"""One stage-1 and one stage-2 train step of the port vs the JAX package's
make_train_step(jit=False) on the CPU, and one Adam step vs optax.adam.

Both steps start from the same weights (EMBED_DIM 64, carried with
models/weights.py) and BatchNorm statistics, at B=2, 48^2, with 2
matrix-Fisher samples in stage 2, synthetic SMPL, uint8 textures and
backgrounds, and the same draws: the port is handed JAX's own key tree
(tests/jax_draws.py), so the synthetic batch, the samples and the proxy
are the same. JAX's renderer runs its Pallas kernel in interpret mode. To
read JAX's gradients, its optimizer is a GradientTransformation whose
update is zero and whose state is the gradient.

Compared: the loss and its terms and the metric sums within 1e-4
relative; the new BatchNorm statistics within 1e-4 of each tensor's
largest entry; and every parameter's gradient, per tensor relative to its
largest entry, within max(1e-3, 10 x its float32 noise floor), with the
cosine of the whole gradients >= 0.9999. The noise floor is the port's own
float32 gradient against its float64 one from the same input and the same
upstream gradient: at delta-I the head's three singular values are nearly
equal and the Jacobi SVD's backward amplifies rounding (1/(s_i^2 - s_j^2)),
and BatchNorm over few values does too. Measured on the CPU: stage 1 every
tensor within 5.8e-4; stage 2 the median 1.2e-4, but the encoder's
layer2.1.conv1 5.8e-2 where its floor is 1.3e-2 (its float32 gradient
moves by that much from rounding alone); BatchNorm statistics 3-4e-5;
loss terms 1e-6 to 8e-5.

48^2 puts 8 values a channel in the encoder's last stage: at 32^2 (2
values) the float32 train-mode forward is chaotic
(tests/test_torch_train_repairs.py), and the terms differed by ~2e-3 on
both stages.
"""

import copy
import time
from functools import partial

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import optax
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)
from hierarchicalprobabilistic3dhuman_tpu.train.train_pose_mf_shape_gaussian_net import (
    TrainState, make_train_step as j_make_train_step)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)
from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
    TrainStep)
from jax_draws import JaxDraws

torch.set_num_threads(2)

D, B, EMBED = 48, 2, 64
F = 300.0 * D / 256
METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
           'joints2D-L2E']


def _cfg(get):
    cfg = get()
    cfg.DATA.PROXY_REP_SIZE = D
    cfg.MODEL.EMBED_DIM = EMBED
    cfg.LOSS.NUM_SAMPLES = 2
    cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH = F
    return cfg


def _grad_capture():
    """An optax transformation whose update is zero and whose state is the
    last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(12)
    pose = (rng.randn(B, 72) * 0.3).astype(np.float32)
    pose[:, :3] = 0.1 * rng.randn(B, 3)
    return (pose, (rng.rand(B, 3, D, D) * 255).astype(np.uint8),
            (rng.rand(B, 60, 40, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_jax(batch, stage):
    jc, tc = _cfg(j_cfg), _cfg(t_cfg)
    stage_metrics = METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
    key = jax.random.PRNGKey(30 + stage)

    jmodel = JPredictor(embed_dim=EMBED)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(stage), jnp.zeros((1, 18, D, D))))
    opt = _grad_capture()
    state = TrainState(variables["params"], variables["batch_stats"],
                       opt.init(variables["params"]))
    t_jax = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        jstep = j_make_train_step(
            jmodel, jc, JSMPL.synthetic(),
            JRenderer(img_wh=D, projection_type="perspective",
                      perspective_focal_length=F, render_rgb=True,
                      backend="pallas"),
            JCanny(threshold=0.0), getattr(jc.LOSS, f"STAGE{stage}"), opt,
            train=True, jit=False, metrics_to_track=stage_metrics)
        new_state, jloss, jsums, jterms = jax.jit(jstep)(
            state, key, *(jnp.asarray(a) for a in batch))
    jgrads = flax_to_torch_predictor(
        {"params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)},
        TPredictor(embed_dim=EMBED))

    model = TPredictor(embed_dim=EMBED)
    model.load_state_dict(flax_to_torch_predictor(variables, model))
    model64 = copy.deepcopy(model).double()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
    capture = chip_smoke.OutputCapture(model)
    tstep = TrainStep(
        capture, tc, TSMPL.synthetic("cpu"),
        TRenderer("cpu", img_wh=D, projection_type="perspective",
                  perspective_focal_length=F),
        TCanny("cpu", threshold=0.0), getattr(tc.LOSS, f"STAGE{stage}"),
        optimizer, train=True, metrics_to_track=stage_metrics)
    t0 = time.perf_counter()
    tloss, tsums, tterms = tstep(JaxDraws(key), *(torch.from_numpy(a) for a in batch))
    print(f"stage {stage}: JAX step {t0 - t_jax:.1f} s, port step "
          f"{time.perf_counter() - t0:.1f} s (CPU)")

    term_errs = {}
    for name, t, j in [("loss", tloss, jloss)] + [(k, tterms[k], jterms[k])
                                                  for k in jterms]:
        j = float(j)
        term_errs[name] = abs(float(t) - j) / max(abs(j), 1e-6)
        print(f"stage {stage} {name}: port {float(t):.7g} jax {j:.7g} "
              f"({term_errs[name]:.1e} rel)")
    assert max(term_errs.values()) <= 1e-4, term_errs
    assert sorted(tsums) == sorted(jsums)
    for k in jsums:
        err = abs(float(tsums[k]) - float(jsums[k])) / max(abs(float(jsums[k])), 1e-6)
        assert err <= 1e-4, (k, err)

    # The float32 noise floor of each gradient: the predictor's backward in
    # float64 from the same input and the same upstream gradient, against
    # the port's float32 one.
    errs, floors = chip_smoke.gradient_diffs(
        model, jgrads, chip_smoke.float64_gradients(model64, capture))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    buffers = 0.0
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            ref = jgrads[name]
            buffers = max(buffers, float((b - ref).abs().max() / ref.abs().max()))
    flat = torch.cat([p.grad.flatten() for p in model.parameters()])
    jflat = torch.cat([jgrads[n].flatten() for n, _ in model.named_parameters()])
    cos = float(torch.nn.functional.cosine_similarity(flat.double(), jflat.double(), dim=0))
    q = np.quantile(list(errs.values()), [0.5, 0.9, 1.0])
    worst = max(errs, key=errs.get)
    print(f"stage {stage}: per-tensor gradient diff of the tensor's largest: "
          f"median {q[0]:.2e}, 90% {q[1]:.2e}, max {q[2]:.2e} ({worst}); "
          f"cosine of the whole gradients {cos:.8f}; BatchNorm statistics "
          f"max diff {buffers:.2e} of the largest")
    over = {n: (errs[n], floors[n]) for n in errs
            if errs[n] > max(1e-3, 10 * floors[n])}
    print(f"stage {stage}: float32 noise floor of the port's gradients: "
          f"median {np.median(list(floors.values())):.2e}, max "
          f"{max(floors.values()):.2e}; tensors beyond max(1e-3, 10 x floor): "
          f"{over}")
    assert not over and buffers <= 1e-4 and cos >= 0.9999


def test_adam_step_matches_optax():
    """torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) against
    optax.adam(lr) over three steps of the same gradients: parameters
    within 1e-6 relative."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * s for s in (1.0, 0.01, 3.0)]
    opt = optax.adam(1e-3)
    jp, jstate = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
    err = np.abs(tp.detach().numpy() - np.asarray(jp)).max() / np.abs(p0).max()
    print(f"Adam after 3 steps: max diff {err:.2e} relative")
    assert err <= 1e-6


def test_bf16_encoder_keeps_float32_parameters_and_head():
    """--bf16_encoder: the encoder alone under bfloat16 autocast. The
    parameters, the BatchNorm statistics and every output stay float32, a
    train-mode step's gradients are finite and float32, and F and the
    shape, glob and cam outputs are within 5e-2 of the float32 model's
    largest (bfloat16 keeps 8 bits of mantissa; U and V are left out: with
    F near I their columns turn with any perturbation)."""
    torch.manual_seed(0)
    model = TPredictor(embed_dim=EMBED).train()
    bf16 = copy.deepcopy(model)
    bf16.encoder_bf16 = True
    x = torch.rand(2, 18, D, D)
    ref, out = model(x), bf16(x)
    for k, v in out.items():
        assert v.dtype == torch.float32, k
        if k not in ("pose_params_F", "shape_mean", "shape_log_std", "glob", "cam"):
            continue
        err = float((v - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-6))
        assert err <= 5e-2, (k, err)
    out["shape_mean"].sum().backward()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert all(b.dtype == torch.float32 for n, b in bf16.named_buffers()
               if "running" in n)
    grads = [p.grad for p in bf16.image_encoder.parameters()]
    assert all(g is not None and g.dtype == torch.float32
               and torch.isfinite(g).all() for g in grads)
