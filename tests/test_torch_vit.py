"""ViT-H/16 (models/vit.py) as the distribution predictor's encoder, held on
the CPU against the plain reference of hp3d_bench/reference/ (written from
4D-Humans' vit(), explicit softmax attention, no import of the port) at a
small size: depth 2, width 64, 4 heads, a 32^2 proxy sliced to 32 x 24
(2 tokens), seeded weights, float32.

Tolerances: the two compute the same float32 arithmetic in another order
(the port's attention is torch's fused scaled_dot_product_attention, the
reference's three products and a softmax; the drop-path rates are a
float64 product here and a float32 linspace there), so outputs and
gradients agree to float32 round-off carried through the layers: a relative
gap of 1e-5 for the encoder, 1e-4 for the whole predictor and its train
step (the head's SVD and SMPL amplify an input's last bits), where a wrong
mask, a dropped layer or a missing term reads O(1).

Also: the r18 step's draws are those of the reference's frozen step (a
ResNet draws nothing), a predict batch through run_predict_torch.py's
build_predictor with MODEL.ENCODER vit_h, a training run and its resume from the
torch-layout checkpoint through run_train_torch.py, the JAX layout refused
for a ViT predictor, and the rows a rank keeps of the drop path's draws.
"""

import copy
import os
import statistics

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.cli import predict as cli_predict
from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
from hierarchicalprobabilistic3dhuman_torch.configs import get_pose_shape_cfg_defaults
from hierarchicalprobabilistic3dhuman_torch.models import vit
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    NO_JAX_VIT, flax_to_torch_predictor, init_weights, load_predictor_state_dict,
    to_jax_layout, to_reference_layout, torch_to_flax_predictor)
from hierarchicalprobabilistic3dhuman_torch.runtime import checkpointing as tckpt
from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
    GlobalRowDraws)

from hp3d_bench import harness, inputs
from hp3d_bench.paths import train as bench_train
from hp3d_bench.paths import train_vit as bench_vit
from hp3d_bench.reference.models import vit as ref_vit

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"embed_dim": 64, "depth": 2, "num_heads": 4}
D, B = 32, 4
ENCODER_TOL, PREDICTOR_TOL = 1e-5, 1e-4


@pytest.fixture
def small_vit_h(monkeypatch):
    """The port's vit_h at the small size (its published widths cut)."""
    monkeypatch.setattr(vit, "VIT_H", dict(vit.VIT_H, **SMALL))


def rel_gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def grad_gaps(model, ref_model):
    """{leaf: |g - g_ref| / max(|g_ref|, the median leaf's |g_ref|)}, max
    norms, over the reference's leaves."""
    grads = dict(model.named_parameters())
    ref = {k: p.grad for k, p in ref_model.named_parameters() if p.grad is not None}
    scale = statistics.median(float(g.abs().max()) for g in ref.values())
    return {k: float((grads[k].grad.double() - g.double()).abs().max())
            / max(float(g.abs().max()), scale, 1e-30) for k, g in ref.items()}


def cell_files(cell):
    """A training cell's files at the small size (proxy 32^2, B = 4, 2
    samples, EMBED_DIM 64, small stores; the ViT's keys cut to SMALL)."""
    workload, config, traffic = (copy.deepcopy(x) for x in harness.cell_files(cell))
    cfg = config["pose_shape_cfg"]
    cfg["DATA"]["PROXY_REP_SIZE"] = D
    cfg["TRAIN"]["BATCH_SIZE"] = B
    cfg["LOSS"]["NUM_SAMPLES"] = 2
    cfg["MODEL"]["EMBED_DIM"] = 64
    cfg["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"] = 300.0 * D / 256
    traffic["params"].update(batch=B, poses=64, textures=8, backgrounds=8)
    if "vit" in config:
        config["vit"].update(SMALL, img_size=[D, D * 3 // 4])
        config["predictor_parameters"] = bench_vit.parameter_count(
            bench_vit.reference_model(config, "meta"))
    return workload, config, traffic


def cell_ctx(cell, seed=2 ** 31 + 41):
    workload, config, traffic = cell_files(cell)
    return harness.Context(cell, seed, 0, 0, "cpu", 0.0,
                           files=(workload, config, traffic))


def test_published_widths():
    """vit_h at the config's 256^2 proxy: 256 x 192 in 192 tokens, 32 blocks
    of width 1280 and 16 heads, 635,827,200 parameters (32 blocks of
    19,677,440, the 18-channel patch embedding's 5,899,520, pos_embed's
    247,040, last_norm's 2,560)."""
    with torch.device("meta"):
        enc = vit.vit_h(18, 256)
    assert enc.img_size == (256, 192) and enc.pos_embed.shape == (1, 193, 1280)
    assert len(enc.blocks) == 32 and enc.blocks[0].attn.num_heads == 16
    assert sum(p.numel() for p in enc.blocks[0].parameters()) == 19_677_440
    assert sum(p.numel() for p in enc.parameters()) == 635_827_200
    rates = [b.drop_path.rate for b in enc.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.55)


@pytest.mark.parametrize("train", [False, True])
def test_vit_matches_reference(train):
    """The port's ViT against the reference's: features and every
    parameter's gradient, in eval mode and in train mode with drop path (the
    reference replays the port's draws)."""
    torch.manual_seed(0)
    port = vit.ViT(in_channels=18, img_size=(D, D * 3 // 4), **SMALL)
    init_weights(port, torch.Generator().manual_seed(3))
    ref = ref_vit.ViT(img_size=(D, D * 3 // 4), in_chans=18, **SMALL)
    ref.load_state_dict(port.state_dict(), strict=True)
    port.train(train)
    ref.train(train)
    x = torch.randn(6, 18, D, D)
    draws = inputs.Draws(11, "cpu")
    draws.recording = True
    out = port(x, draws)
    ref.draws = inputs.Replay(draws.record, None)
    ref_out = ref(x)
    assert len(draws.record) == (2 if train else 0)       # block 1's two branches
    if train:
        assert ref.draws.mismatches == 0 and ref.draws.i == 2
    assert rel_gap(out, ref_out) < ENCODER_TOL
    (out * torch.arange(64.0)).square().sum().backward()
    (ref_out * torch.arange(64.0)).square().sum().backward()
    gaps = grad_gaps(port, ref)
    assert len(gaps) == len(list(port.parameters()))
    assert max(gaps.values()) < ENCODER_TOL, max(gaps.items(), key=lambda kv: kv[1])


def test_drop_path_drops_whole_samples():
    """A branch at rate 0.55 keeps a sample (scaled by 1 / 0.45) or drops it
    whole, by its draw; in eval mode it is the identity and draws nothing."""
    dp = vit.DropPath(0.55).train()
    x = torch.ones(4, 3, 2)
    draws = inputs.Draws(5, "cpu")
    draws.recording = True
    y = dp(x, draws)
    u = draws.record[0]
    keep = u >= 0.55 - 1e-6
    assert torch.equal(y[keep], torch.full_like(y[keep], 1 / 0.45))
    assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))
    dp.eval()
    assert dp(x, None) is x
    with pytest.raises(ValueError, match="draw source"):
        dp.train()(x, None)


def test_predictor_and_train_step_match_reference(small_vit_h, tmp_path):
    """The port's ViT predictor (built by build_pose_shape_model from
    MODEL.ENCODER vit_h) against the reference's ViT predictor: the
    forward's outputs in train mode with drop path, then one train step of
    each (the benchmark's seeded weights, batch and draws): the loss and
    every parameter's gradient."""
    ctx = cell_ctx("vith.train.s2.b72")
    model = bench_vit.build_port_model(ctx)
    weights, smpl_arrays, _ = bench_vit.seeded_inputs(ctx)
    step, optimizer, _, _ = bench_vit.build_port(ctx, model, weights, smpl_arrays)
    r_step, r_model, _ = bench_vit.build_reference(ctx, weights, smpl_arrays)
    assert type(model.image_encoder) is vit.ViT

    proxy = torch.rand(B, 18, D, D)
    draws = inputs.Draws(7, "cpu")
    draws.recording = True
    model.train()
    r_model.train()
    out = model(proxy, draws=draws)
    r_model.image_encoder.draws = inputs.Replay(draws.record, None)
    r_out = r_model(proxy)
    assert len(draws.record) == 2 and r_model.image_encoder.draws.mismatches == 0
    for k in r_out:
        assert rel_gap(out[k], r_out[k]) < PREDICTOR_TOL, k

    batch = bench_train.store_draws(ctx, bench_train.write_stores(
        str(tmp_path / "stores"), ctx.seed, ctx.traffic, D)).take()
    draws = inputs.Draws(9, "cpu")
    draws.recording = True
    loss, _, _ = step(draws, *bench_train.upload(batch, ctx.device))
    replay = inputs.Replay(draws.record, None)
    r_model.image_encoder.draws = replay
    r_loss = r_step(replay, *bench_train.upload(batch, ctx.device))
    assert replay.mismatches == 0 and replay.i == len(draws.record)
    assert abs(float(loss) - float(r_loss)) < PREDICTOR_TOL * abs(float(r_loss))
    gaps = grad_gaps(model, r_model)
    assert len(gaps) == len(list(model.parameters()))
    assert max(gaps.values()) < PREDICTOR_TOL, max(gaps.items(), key=lambda kv: kv[1])


def test_resnet_step_draws_are_the_frozen_steps(tmp_path):
    """The r18 train step with the ViT's draw site: its draws (count, shapes
    and values) are those of the reference's frozen copy of the step, made
    before encoders took a draw source; a ResNet draws nothing."""
    ctx = cell_ctx("r18.train.s2.b72")
    weights, smpl_arrays, _ = bench_train.seeded_inputs(ctx)
    step, *_ = bench_train.build_port(ctx, weights, smpl_arrays)
    r_step, *_ = bench_train.build_reference(ctx, weights, smpl_arrays)
    batch = bench_train.store_draws(ctx, bench_train.write_stores(
        str(tmp_path / "stores"), ctx.seed, ctx.traffic, D)).take()
    records = []
    for s in (step, r_step):
        draws = inputs.Draws(13, "cpu")
        draws.recording = True
        s(draws, *bench_train.upload(batch, ctx.device))
        records.append(draws.record)
    assert len(records[0]) == len(records[1]) > 0
    for a, b in zip(*records):
        assert a.shape == b.shape and torch.equal(a, b)


def test_predict_batch_through_build_predictor(small_vit_h, tmp_path):
    """run_predict_torch.py's main with a --pose_shape_cfg of MODEL.ENCODER
    vit_h (32^2 proxy), --batch_size 2 --no_vis on two demo photos: the
    predictor runs its ViT once a batch, in eval mode, and writes finite
    outputs."""
    import cv2
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    for name in ("00007.png", "00008.png"):
        img = cv2.imread(os.path.join(REPO, "demo", name))
        cv2.imwrite(str(image_dir / name), cv2.resize(img, (128, 128)))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"MODEL:\n  ENCODER: vit_h\nDATA:\n  PROXY_REP_SIZE: {D}\n")
    calls = []
    forward = vit.ViT.forward

    def counted(self, x, draws=None):
        calls.append((self.training, x.shape[0], draws))
        return forward(self, x, draws)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vit.ViT, "forward", counted)
        cli_predict.main(["--image_dir", str(image_dir), "--save_dir",
                          str(tmp_path / "out"), "--cropped_images", "--device", "cpu",
                          "--batch_size", "2", "--no_vis",
                          "--num_uncertainty_samples", "4", "--pose_shape_cfg", str(cfg)])
    assert calls == [(False, 2, None)]
    out = np.load(tmp_path / "out" / "outputs.npz")
    assert len(out.files) > 0
    assert all(np.isfinite(out[k]).all() for k in out.files
               if np.issubdtype(out[k].dtype, np.floating))


def test_train_cli_trains_and_resumes_vit_h(small_vit_h, tmp_path):
    """run_train_torch.py -O MODEL.ENCODER vit_h (no other flag) trains the
    ViT predictor through TrainStep from packed stores, writes the torch
    layout's checkpoint (pos_embed and the blocks included, loaded
    strict=True), and -R resumes it with Adam's state."""
    sources = chip_smoke.write_train_sources(
        str(tmp_path / "sources"), 4, 1, 1, 2, texture_hw=(60, 40),
        background_hw=(48, 64), seed=0)
    stores = str(tmp_path / "stores")
    chip_smoke.pack_split(stores, sources, D)
    exp = str(tmp_path / "exp")
    argv = ["-E", exp, "--device", "cpu", "--native_data_dir", stores, "-O",
            "DATA.PROXY_REP_SIZE", str(D), "TRAIN.BATCH_SIZE", "2",
            "MODEL.EMBED_DIM", "64", "MODEL.ENCODER", "vit_h",
            "TRAIN.EPOCHS_PER_SAVE", "1"]
    train_main(argv + ["--num_epochs", "1"])
    train_main(argv + ["--num_epochs", "2", "-R", "0"])
    path = os.path.join(exp, "saved_models", "epoch_001.tar")
    ckpt = tckpt.load_training_checkpoint(path)
    sd = ckpt["model_state_dict"]
    assert sd["image_encoder.pos_embed"].shape == (1, 3, 64)
    assert "image_encoder.blocks.1.mlp.fc2.weight" in sd
    assert {float(s["step"]) for s in ckpt["optimiser_state_dict"]["state"].values()} \
        == {4.0}
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_list(["MODEL.ENCODER", "vit_h", "DATA.PROXY_REP_SIZE", D,
                         "MODEL.EMBED_DIM", 64])
    model = cli_predict.build_pose_shape_model(cfg, "jacobi")
    model.load_state_dict(load_predictor_state_dict(path, model), strict=True)


def test_encoder_bf16_applies_to_the_vit(small_vit_h):
    """encoder_bf16 runs the ViT under autocast to bfloat16, as it runs a
    ResNet: its matmuls in bfloat16, its LayerNorms, features and the head in
    float32; the outputs stay within bfloat16's round-off of the float32
    ones."""
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_list(["MODEL.ENCODER", "vit_h", "DATA.PROXY_REP_SIZE", D])
    model = init_weights(cli_predict.build_pose_shape_model(cfg, "jacobi"),
                         torch.Generator().manual_seed(1)).eval()
    x = torch.rand(2, 18, D, D)
    seen = []
    hook = model.image_encoder.blocks[0].attn.qkv.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        full = model(x)
        model.encoder_bf16 = True
        half = model(x)
    hook.remove()
    assert seen == [torch.float32, torch.bfloat16]
    assert all(v.dtype == torch.float32 for v in half.values())
    assert rel_gap(half["shape_mean"], full["shape_mean"]) < 0.05


def jax_layout_calls(model):
    sd = model.state_dict()
    ckpt = {"epoch": 0, "best_epoch": 0, "best_epoch_val_metrics": {},
            "model_state_dict": sd, "best_model_state_dict": sd,
            "optimiser_state_dict": {"state": {}, "param_groups": []}}
    opt = torch.optim.Adam(model.parameters())
    return {"to_jax_layout": lambda: to_jax_layout(ckpt, model),
            "torch_to_flax_predictor": lambda: torch_to_flax_predictor(sd),
            "flax_to_torch_predictor": lambda: flax_to_torch_predictor(
                {"params": {}}, model),
            "to_reference_layout": lambda: to_reference_layout(
                dict(ckpt, optimiser_state_dict=(None, None)), model, opt)}


@pytest.mark.parametrize("call", ["to_jax_layout", "torch_to_flax_predictor",
                                  "flax_to_torch_predictor", "to_reference_layout"])
def test_jax_layout_refused_for_vit_h(small_vit_h, call):
    """Each way into or out of the JAX package's layout refuses a ViT
    predictor at once: the JAX package has no ViT."""
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_list(["MODEL.ENCODER", "vit_h", "DATA.PROXY_REP_SIZE", D])
    model = cli_predict.build_pose_shape_model(cfg, "jacobi")
    with pytest.raises(ValueError) as err:
        jax_layout_calls(model)[call]()
    assert str(err.value) == NO_JAX_VIT and "no ViT" in NO_JAX_VIT


def test_global_row_draws_keep_the_ranks_rows():
    """On a mesh a rank's drop-path draws are its rows of the global
    batch's draw, as the 1-rank step draws it."""
    class Rows:
        shape = {"data": 4}

        def __init__(self, index):
            self.index = index

        def take_rows(self, x):
            b = x.shape[0] // 4
            return x[self.index * b:(self.index + 1) * b]

    whole = inputs.Draws(3, "cpu").uniform((8,))
    parts = [GlobalRowDraws(inputs.Draws(3, "cpu"), Rows(r)).uniform((2,))
             for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)
