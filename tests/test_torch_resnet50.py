"""The port's ResNet-50 encoder and its predictor head vs the JAX package's
(models/resnet.py::Bottleneck, resnet50; models/pose_mf_shape_gaussian_net.py
at num_resnet_layers=50) on the CPU, the weights carried across with
models/weights.py.

  * Bottleneck, eval mode, with and without its downsample: within 1e-4 of
    the output's largest;
  * resnet50, eval mode, B=2 at 64^2: within 1e-4 of the largest feature;
  * resnet50, train mode at 64^2, against flax's mutable=["batch_stats"]:
    the features within max(1e-4, 10 x their float32 noise floor) of the
    largest, and every running_mean / running_var after the step within
    max(1e-5, 10 x its floor) of its tensor's largest. The floor is the
    port's float32 against its float64 forward: 53 BatchNorms over 2 x 2 x
    B = 8 values a channel in layer4 amplify rounding (measured 3.9e-4 of
    the largest feature, where ResNet-18's was ~5e-6);
  * the predictor at ResNet-50 (2048 features, fc1 2048 -> 1024, fc_embed
    reading 2048 + 2 x 10 + 6 + 3), eval mode: every output within 1e-4 of
    its largest, and the port's torch_to_flax_predictor gives JAX's
    variables back exactly;
  * --bf16_encoder at ResNet-50: float32 outputs, parameters and
    gradients; in eval mode within 5e-2 of the float32 model (in train mode
    at B=2 the same batch statistics amplify bfloat16's rounding: the
    features' cosine with float32 was 0.94, ResNet-18's 0.9996).

tests/test_torch_resnet50_step.py holds the train steps.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.resnet import (
    Bottleneck as JBottleneck, resnet50 as j_resnet50)

from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.resnet import (
    Bottleneck as TBottleneck, resnet50 as t_resnet50)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    _DOWNSAMPLE, _flax_to_state_dict, flax_to_torch_predictor,
    flax_to_torch_resnet, torch_to_flax_predictor)

torch.set_num_threads(2)


def _rel_err(port, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(port) - ref).max() / max(np.abs(ref).max(), 1e-6))


def _random_stats(variables, seed):
    """BatchNorm statistics drawn at random (positive variances), so the
    eval-mode comparison reads every mean and variance."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda s: np.abs(np.asarray(s) + rng.rand(*s.shape).astype(np.float32)),
        variables["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


@pytest.mark.parametrize("in_planes,planes,stride", [(32, 16, 2), (64, 16, 1)])
def test_bottleneck_matches_flax(in_planes, planes, stride):
    downsample = stride != 1 or in_planes != planes * 4
    jblock = JBottleneck(features=planes, strides=stride, downsample=downsample)
    x = np.random.RandomState(0).randn(2, 16, 16, in_planes).astype(np.float32)
    variables = _random_stats(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    ref = jblock.apply(variables, jnp.asarray(x))

    tblock = TBottleneck(in_planes, planes, stride).eval()
    assert (tblock.downsample is not None) == downsample
    tblock.load_state_dict(_flax_to_state_dict(
        variables, tblock,
        lambda mod: (_DOWNSAMPLE[mod[1]],) if mod[0] == "downsample" else (mod[0],)))
    with torch.no_grad():
        port = tblock(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    err = _rel_err(port.transpose(0, 2, 3, 1), ref)
    print(f"Bottleneck {in_planes}->{planes}x4 stride {stride}: max diff "
          f"{err:.2e} of the largest (tol 1e-4)")
    assert err <= 1e-4


@pytest.fixture(scope="module")
def encoder():
    jmodel = j_resnet50()
    x = np.random.RandomState(3).rand(2, 18, 64, 64).astype(np.float32)
    variables = _random_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(4),
                                                   jnp.asarray(x)), 5)
    tmodel = t_resnet50()
    tmodel.load_state_dict(flax_to_torch_resnet(variables, tmodel), strict=True)
    return jmodel, variables, tmodel, x


def test_resnet50_eval_matches_flax(encoder):
    jmodel, variables, tmodel, x = encoder
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        port = tmodel.eval()(torch.from_numpy(x))
    err = _rel_err(port.numpy(), ref)
    print(f"resnet50 features {tuple(port.shape)}: max diff {err:.2e} of the "
          f"largest (tol 1e-4)")
    assert port.shape == (2, 2048) and err <= 1e-4


def test_resnet50_train_mode_and_batch_stats_match_flax(encoder):
    jmodel, variables, tmodel, x = encoder
    ref, new = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model, model64 = copy.deepcopy(tmodel).train(), copy.deepcopy(tmodel).double().train()
    with torch.no_grad():
        port, port64 = model(torch.from_numpy(x)), model64(torch.from_numpy(x).double())
    err, floor = _rel_err(port.numpy(), ref), _rel_err(port.numpy(), port64.numpy())
    expected = flax_to_torch_resnet({"params": variables["params"],
                                     "batch_stats": new["batch_stats"]}, model)
    buffers64 = model64.state_dict()
    over, worst, count = {}, (0.0, None), 0
    for k, v in model.state_dict().items():
        if not k.endswith(("running_mean", "running_var")):
            continue
        count += 1
        e = _rel_err(v.numpy(), expected[k].numpy())
        f = _rel_err(v.numpy(), buffers64[k].numpy())
        worst = max(worst, (e, k))
        if e > max(1e-5, 10 * f):
            over[k] = (e, f)
    print(f"resnet50 train mode: features max diff {err:.2e} of the largest, "
          f"float32 floor {floor:.2e} (tol max(1e-4, 10 x floor)); {count} "
          f"BatchNorm buffers, worst {worst[1]} {worst[0]:.2e} of its largest; "
          f"beyond max(1e-5, 10 x floor): {over}")
    assert count == 2 * 53 and err <= max(1e-4, 10 * floor) and not over


def test_predictor_resnet50_matches_jax():
    jmodel = JPredictor(num_resnet_layers=50, embed_dim=64)
    x = np.random.RandomState(6).rand(2, 18, 64, 64).astype(np.float32)
    variables = _random_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(7),
                                                   jnp.asarray(x)), 8)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    tmodel = TPredictor(num_resnet_layers=50, embed_dim=64)
    assert (tmodel.fc1.in_features, tmodel.fc1.out_features) == (2048, 1024)
    assert tmodel.fc_embed.in_features == 2048 + 2 * 10 + 6 + 3
    sd = flax_to_torch_predictor(variables, tmodel)
    tmodel.load_state_dict(sd, strict=True)
    back = torch_to_flax_predictor(sd)
    flat, tree = jax.tree_util.tree_flatten(back)
    jflat, jtree = jax.tree_util.tree_flatten(variables)
    assert tree == jtree and all(np.array_equal(a, b) for a, b in zip(flat, jflat))
    with torch.no_grad():
        port = tmodel.eval()(torch.from_numpy(x))
    errs = {k: _rel_err(port[k].numpy(), ref[k]) for k in ref}
    print("predictor at ResNet-50, max diff of each output's largest: "
          + ", ".join(f"{k} {v:.1e}" for k, v in sorted(errs.items())) + " (tol 1e-4)")
    assert max(errs.values()) <= 1e-4


def test_bf16_encoder_at_resnet50():
    """The encoder alone under bfloat16 autocast: parameters, BatchNorm
    statistics and outputs stay float32; in eval mode F, shape, glob and
    cam are within 5e-2 of the float32 model's largest (the tolerance of
    ResNet-18's test); a train-mode backward gives finite float32
    gradients."""
    torch.manual_seed(0)
    model = TPredictor(num_resnet_layers=50, embed_dim=64).eval()
    bf16 = copy.deepcopy(model)
    bf16.encoder_bf16 = True
    x = torch.rand(2, 18, 48, 48)
    with torch.no_grad():
        ref, out = model(x), bf16(x)
    for k in ("pose_params_F", "shape_mean", "shape_log_std", "glob", "cam"):
        assert out[k].dtype == torch.float32, k
        err = _rel_err(out[k].numpy(), ref[k].numpy())
        print(f"bf16 encoder at ResNet-50, eval mode, {k}: {err:.2e} of the "
              f"largest (tol 5e-2)")
        assert err <= 5e-2, k
    out = bf16.train()(x)
    out["shape_mean"].sum().backward()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert all(torch.isfinite(p.grad).all() for p in bf16.image_encoder.parameters())
