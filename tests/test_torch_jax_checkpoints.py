"""The JAX package's own files in the port, and the port's writers of them.

The JAX package writes, on the CPU, a flax variables file
(runtime/checkpointing.py::save_variables) and a training checkpoint
(save_training_checkpoint: a pickle of flax trees and optax.adam's state)
of a ResNet-50 predictor (EMBED_DIM 64) after two Adam steps, in an
experiment directory with its pose_shape_cfg.yaml, encoder_precision.txt
and log.pkl. The port reads them with its own msgpack codec and a
restricted unpickler, never importing msgpack, flax, optax or jax:

  * the codec writes flax's bytes and reads flax's files, leaf type by leaf
    type (exact);
  * the variables give the port's predictor the outputs of JAX's apply
    (within 1e-4 of each output's largest), and load through the predict
    and evaluate CLIs (exact);
  * the training checkpoint gives the model, and Adam's step / exp_avg /
    exp_avg_sq equal to count / mu / nu (exact), and the next step matches
    optax's next step (within 1e-6 of max(1, the tensor's largest): the
    difference is optax's float32 bias correction, 1 - 0.999^t cancels);
    run_train_torch.py -R resumes the experiment;
  * the port's writers are read back by JAX's load_variables and
    load_training_checkpoint into the original trees (exact), optax's
    classes included;
  * in a fresh interpreter none of msgpack, optax, flax or jax is loaded.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from hierarchicalprobabilistic3dhuman_tpu.cli.train import (
    resolve_encoder_precision as j_resolve_encoder_precision)
from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.metrics.train_loss_and_metrics_tracker import (
    TrainingLossesAndMetricsTracker as JTracker)
from hierarchicalprobabilistic3dhuman_tpu.models.hrnet import torch_to_flax_hrnet
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor, torch_to_flax_predictor as j_to_flax)
from hierarchicalprobabilistic3dhuman_tpu.runtime import checkpointing as jck

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.cli import evaluate as tevaluate
from hierarchicalprobabilistic3dhuman_torch.cli import predict as tpredict
from hierarchicalprobabilistic3dhuman_torch.cli.train import (
    main as train_main, resolve_encoder_precision)
from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
    PoseHighResolutionNet as THRNet)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor, init_weights, load_predictor_state_dict,
    to_jax_layout, to_reference_layout, torch_to_flax_predictor)
from hierarchicalprobabilistic3dhuman_torch.runtime import flax_msgpack
from hierarchicalprobabilistic3dhuman_torch.runtime import checkpointing as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, EMBED, LR = 32, 64, 1e-4
CFG_OPTS = ["MODEL.NUM_RESNET_LAYERS", 50, "MODEL.EMBED_DIM", EMBED,
            "DATA.PROXY_REP_SIZE", 24, "TRAIN.BATCH_SIZE", 16,
            "LOSS.STAGE_CHANGE_EPOCH", 1, "TRAIN.EPOCHS_PER_SAVE", 1]
METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
           'joints2D-L2E']


def _tree_equal(a, b):
    flat_a, tree_a = jax.tree_util.tree_flatten(a)
    flat_b, tree_b = jax.tree_util.tree_flatten(b)
    return tree_a == tree_b and all(
        np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)
        for x, y in zip(flat_a, flat_b))


def _random_tree(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """A ResNet-50 predictor's variables after two optax.adam steps (with
    BatchNorm statistics drawn at random), as JAX writes them, and a JAX
    experiment directory around its epoch-0 training checkpoint."""
    root = tmp_path_factory.mktemp("jax")
    model = JPredictor(num_resnet_layers=50, embed_dim=EMBED)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D))))
    opt = optax.adam(LR)
    update = jax.jit(opt.update)
    params, state = init["params"], opt.init(init["params"])
    for seed in (1, 2):
        updates, state = update(_random_tree(params, seed), state, params)
        params = optax.apply_updates(params, updates)
    stats = jax.tree_util.tree_map(
        lambda s: np.abs(s + np.random.RandomState(s.size).randn(*s.shape)
                         .astype(np.float32)), init["batch_stats"])
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats})
    state = jax.tree_util.tree_map(np.asarray, state)
    jck.save_variables(str(root / "variables.msgpack"), variables)

    exp = root / "exp"
    ckpt = jck.checkpoint_path(str(exp / "saved_models"), 0)
    jck.save_training_checkpoint(
        ckpt, epoch=0, best_epoch=0,
        best_epoch_val_metrics={"PVE-SC": np.float64(0.5),
                                "MPJPE-PA": np.float64(0.25)},
        model_variables=variables, best_model_variables=init, opt_state=state)
    cfg = j_cfg()
    cfg.merge_from_list(CFG_OPTS)
    (exp / "pose_shape_cfg.yaml").write_text(cfg.dump())
    j_resolve_encoder_precision(str(exp), False, resuming=False)
    tracker = JTracker(list(METRICS), img_wh=24,
                       log_save_path=str(exp / "log.pkl"))
    tracker.initialise_loss_metric_sums()
    for split in ("train", "val"):
        tracker.update_per_batch_sums(split, 1.0, 16,
                                      {m: 0.5 for m in METRICS})
    tracker.update_per_epoch()
    return SimpleNamespace(model=model, init=init, variables=variables,
                           state=state, opt=opt, root=root, exp=exp, ckpt=ckpt,
                           vars_path=str(root / "variables.msgpack"))


def _port_model():
    return TPredictor(num_resnet_layers=50, embed_dim=EMBED)


LEAVES = {
    "nil": None,
    "bool": [True, False],
    "int": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63],
    "float": [0.0, -1.5, 1e300, float("inf")],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    "array": list(range(20)),
    "map": {f"k{i}": {"inner": i} for i in range(20)},
    "ndarray": [(np.random.RandomState(0).randn(3, 4) * 100).astype(d)
                for d in ("float32", "float64", "float16", "int8", "int32",
                          "int64", "uint8", "bool")]
               + [np.array(3.5, np.float32), np.zeros((0, 3), np.float32),
                  np.arange(70000, dtype=np.float32)]
               + [np.zeros(n, np.uint8) for n in range(40)],
    "npscalar": [np.float32(1.5), np.float64(2.5), np.int64(-7), np.int32(3),
                 np.bool_(True)],
}


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_codec_matches_flax(leaf):
    """The port's codec writes flax.serialization's bytes and each reads
    the other's, for every leaf type of flax's msgpack."""
    tree = {"x": LEAVES[leaf], "y": 1}
    ours, theirs = flax_msgpack.serialize(tree), serialization.msgpack_serialize(tree)
    print(f"{leaf}: {len(ours)} bytes, equal to flax's {ours == theirs}")
    assert ours == theirs
    assert _tree_equal(flax_msgpack.restore(theirs), serialization.msgpack_restore(theirs))
    assert _tree_equal(serialization.msgpack_restore(ours), tree)


def test_codec_refuses_what_it_does_not_read(monkeypatch):
    """bfloat16 leaves, flax's chunked arrays (over 2^30 bytes, here with
    the limit lowered) and other ext types raise."""
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.restore(serialization.msgpack_serialize(
            {"w": jnp.ones(3, jnp.bfloat16)}))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 8)
    chunked = serialization.msgpack_serialize({"w": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.restore(chunked)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 8)
    with pytest.raises(ValueError, match="chunks"):
        flax_msgpack.serialize({"w": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))


def test_flax_variables_into_predict_and_evaluate(jax_files, tmp_path):
    """The variables file gives the port's ResNet-50 predictor JAX's
    outputs, and loads through build_predictor and build_evaluator (with
    --svd_impl auto taking the Jacobi SVD, as JAX's does for such a file);
    an HRNet-W48 variables file loads through build_predictor."""
    model = _port_model()
    model.load_state_dict(load_predictor_state_dict(jax_files.vars_path, model),
                          strict=True)
    x = np.random.RandomState(3).rand(2, 18, D, D).astype(np.float32)
    ref = jax.jit(jax_files.model.apply)(jax_files.variables, jnp.asarray(x))
    with torch.no_grad():
        port = model.eval()(torch.from_numpy(x))
    for k in sorted(ref):
        r = np.asarray(ref[k])
        err = np.abs(port[k].numpy() - r).max() / max(np.abs(r).max(), 1e-6)
        print(f"ResNet-50 from flax variables, {k}: max diff {err:.2e} of the "
              f"largest (tol 1e-4)")
        assert err <= 1e-4, k

    hrnet = init_weights(THRNet(num_joints=17), torch.Generator().manual_seed(4))
    hrnet_path = str(tmp_path / "hrnet_variables")
    jck.save_variables(hrnet_path, torch_to_flax_hrnet(
        {k: v.numpy() for k, v in hrnet.state_dict().items()}))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"MODEL:\n  NUM_RESNET_LAYERS: 50\n  EMBED_DIM: {EMBED}\n"
                   f"DATA:\n  PROXY_REP_SIZE: {D}\n")
    common = ["--pose_shape_weights", jax_files.vars_path, "--pose_shape_cfg",
              str(cfg), "--device", "cpu"]
    built = tpredict.build_predictor(tpredict.build_parser().parse_args(
        ["-I", str(tmp_path), "-S", str(tmp_path), "-C",
         "--pose2D_hrnet_weights", hrnet_path] + common))
    ssp3d = chip_smoke.write_ssp3d_folder(
        str(tmp_path / "ssp3d"), [np.zeros((48, 48, 3), np.uint8)] * 2)
    evaluator = tevaluate.build_evaluator(tevaluate.build_parser().parse_args(
        ["--dataset", "ssp3d", "--dataset_path", ssp3d,
         "--save_path", str(tmp_path / "eval")] + common))
    for where, got in (("predict", built["pose_shape_model"]),
                       ("evaluate", evaluator["pose_shape_model"])):
        assert got.svd_impl == "jacobi", where
        assert all(torch.equal(v, model.state_dict()[k])
                   for k, v in got.state_dict().items()), where
    assert all(torch.equal(v, hrnet.state_dict()[k])
               for k, v in built["hrnet"].state_dict().items())


def test_training_checkpoint_resumes_with_the_next_adam_step(jax_files):
    """The pickle's trees and optax.adam's state land in the model and in
    torch.optim.Adam exactly; the next step from them matches optax's next
    step."""
    model = _port_model()
    optimizer = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                                 eps=1e-8)
    ckpt = to_reference_layout(tck.load_training_checkpoint(jax_files.ckpt),
                               model, optimizer)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    optimizer.load_state_dict(ckpt["optimiser_state_dict"])
    assert ckpt["best_epoch_val_metrics"] == {"PVE-SC": 0.5, "MPJPE-PA": 0.25}
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in
               flax_to_torch_predictor(jax_files.variables, model).items())
    best = flax_to_torch_predictor(jax_files.init, model)
    assert all(torch.equal(v, best[k])
               for k, v in ckpt["best_model_state_dict"].items())
    adam = jax_files.state[0]
    mu = flax_to_torch_predictor({"params": adam.mu}, model, params_only=True)
    nu = flax_to_torch_predictor({"params": adam.nu}, model, params_only=True)
    for name, p in model.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == int(adam.count) == 2
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name

    grads = _random_tree(jax_files.variables["params"], 3)
    tgrads = flax_to_torch_predictor({"params": grads}, model, params_only=True)
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()
    optimizer.step()
    updates, _ = jax_files.opt.update(grads, jax_files.state,
                                      jax_files.variables["params"])
    after = flax_to_torch_predictor({"params": jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jax_files.variables["params"], updates))},
        model, params_only=True)
    errs = {n: float((p.detach() - after[n]).abs().max()
                     / max(float(after[n].abs().max()), 1.0))
            for n, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    print(f"next Adam step vs optax: max diff {errs[worst]:.2e} of max(1, the "
          f"tensor's largest) ({worst}; tol 1e-6)")
    assert errs[worst] <= 1e-6


def test_port_writers_are_read_by_jax(jax_files, tmp_path):
    """save_variables of torch_to_flax_predictor, and the JAX-layout
    training checkpoint of a reference-layout one, read back by the JAX
    package into the trees it wrote, optax's state classes included."""
    model = _port_model()
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    ckpt = to_reference_layout(tck.load_training_checkpoint(jax_files.ckpt),
                               model, optimizer)
    sd = {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}
    tck.save_variables(str(tmp_path / "v.msgpack"), torch_to_flax_predictor(sd))
    got = jck.load_variables(str(tmp_path / "v.msgpack"))
    assert _tree_equal(got, jax_files.variables)
    assert _tree_equal(got, j_to_flax(sd, resnet_layers=(3, 4, 6, 3)))

    path = str(tmp_path / "epoch_000.tar")
    tck.save_jax_training_checkpoint(path, **to_jax_layout(ckpt, model))
    back = jck.load_training_checkpoint(path)
    assert isinstance(back["optimiser_state_dict"][0], type(jax_files.state[0]))
    assert isinstance(back["optimiser_state_dict"][1], type(jax_files.state[1]))
    assert _tree_equal(back["optimiser_state_dict"], jax_files.state)
    assert _tree_equal(back["model_state_dict"], jax_files.variables)
    assert _tree_equal(back["best_model_state_dict"], jax_files.init)
    assert (back["epoch"], back["best_epoch"]) == (0, 0)
    assert back["best_epoch_val_metrics"] == {"PVE-SC": 0.5, "MPJPE-PA": 0.25}


def test_run_train_torch_resumes_a_jax_experiment(jax_files, tmp_path):
    """run_train_torch.py -R 0 --device cpu in the JAX experiment directory
    (its config, encoder precision, log.pkl and pickled epoch 0) trains
    epoch 1 with ResNet-50: log.pkl then holds 2 epochs, and epoch_001.tar,
    in the reference's layout, has Adam at count + 4 steps."""
    exp = tmp_path / "exp"
    os.makedirs(exp / "saved_models")
    for name in ("pose_shape_cfg.yaml", "encoder_precision.txt", "log.pkl",
                 os.path.join("saved_models", "epoch_000.tar")):
        (exp / name).write_bytes((jax_files.exp / name).read_bytes())
    train_main(["-E", str(exp), "-R", "0", "--num_epochs", "2",
                "--device", "cpu"])
    with open(exp / "log.pkl", "rb") as f:
        log = pickle.load(f)
    assert {len(v) for v in log.values()} == {2}
    assert all(np.isfinite(v).all() for v in log.values())
    ckpt = tck.load_training_checkpoint(str(exp / "saved_models" / "epoch_001.tar"))
    assert tck.checkpoint_format(str(exp / "saved_models" / "epoch_001.tar")) == "torch"
    steps = {float(s["step"]) for s in ckpt["optimiser_state_dict"]["state"].values()}
    assert steps == {2.0 + 4}
    assert ckpt["model_state_dict"]["image_encoder.layer4.2.conv3.weight"].shape == (
        2048, 512, 1, 1)


def test_experiment_config_and_precision_read_as_they_are(jax_files, tmp_path):
    """A JAX experiment's pose_shape_cfg.yaml merges into the port's config
    to the same tree, but for the port's own key MODEL.ENCODER, which keeps
    its default (the ResNet), and its encoder_precision.txt gives the same
    mode."""
    import yaml
    cfg = t_cfg()
    cfg.merge_from_file(str(jax_files.exp / "pose_shape_cfg.yaml"))
    jcfg = j_cfg()
    jcfg.merge_from_list(CFG_OPTS)
    tree = yaml.safe_load(cfg.dump())
    assert tree["MODEL"].pop("ENCODER") == "resnet"
    assert tree == yaml.safe_load(jcfg.dump()) and cfg.MODEL.NUM_RESNET_LAYERS == 50
    for bf16 in (False, True):
        j_resolve_encoder_precision(str(tmp_path), bf16, resuming=False)
        assert resolve_encoder_precision(str(tmp_path), not bf16, resuming=True) == bf16


def test_formats_are_told_by_content(jax_files, tmp_path):
    """Each loader takes its formats whatever the name and refuses the
    others; the unpickler refuses any global but optax's two and numpy's
    array reconstruction, before anything runs."""
    assert tck.checkpoint_format(jax_files.vars_path) == "flax"
    assert tck.checkpoint_format(jax_files.ckpt) == "pickle"
    with pytest.raises(ValueError, match="training checkpoint"):
        load_predictor_state_dict(jax_files.ckpt, _port_model())
    with pytest.raises(ValueError, match="not a training checkpoint"):
        tck.load_training_checkpoint(jax_files.vars_path)
    evil = tmp_path / "epoch_000.tar"
    evil.write_bytes(pickle.dumps({"epoch": SimpleNamespace(a=1)}, protocol=5))
    with pytest.raises(pickle.UnpicklingError, match="types.SimpleNamespace"):
        tck.load_training_checkpoint(str(evil))


def test_fresh_interpreter_loads_both_formats_without_jax(jax_files, tmp_path):
    """The port loads a flax variables file, a reference checkpoint and a
    JAX training checkpoint in an interpreter that has imported none of
    msgpack, optax, flax and jax, and imports none of them."""
    ref = str(tmp_path / "model.tar")
    torch.save({"best_model_state_dict": _port_model().state_dict()}, ref)
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    load_predictor_state_dict, to_reference_layout)
from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
    load_training_checkpoint)
model = PoseMFShapeGaussianNet(num_resnet_layers=50, embed_dim={EMBED})
for path in ({jax_files.vars_path!r}, {ref!r}):
    model.load_state_dict(load_predictor_state_dict(path, model), strict=True)
optimizer = torch.optim.Adam(model.parameters())
ckpt = to_reference_layout(load_training_checkpoint({jax_files.ckpt!r}),
                           model, optimizer)
optimizer.load_state_dict(ckpt["optimiser_state_dict"])
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"msgpack", "optax", "flax", "jax", "jaxlib"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    print(f"modules of jax, flax, optax, msgpack loaded: {out.stdout.strip()}")
    assert out.stdout.strip().splitlines()[-1] == "[]"
