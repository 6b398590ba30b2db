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
import os
import time
from functools import partial

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.train.train_pose_mf_shape_gaussian_net import (
    TrainState)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from _torch_train_fixtures import (
    EMBED, Float64Predictor, init_jax_predictor, jax_train_step,
    pallas_interpret, port_train_step, small_cfg)
from jax_draws import JaxDraws

torch.set_num_threads(2)

D, B = 48, 2
METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
           'joints2D-L2E']


def _grad_capture():
    """An optax transformation whose update is zero and whose state is the
    last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


class GivenInput(torch.nn.Module):
    """A predictor run on a given input in place of the one it is handed,
    which it keeps in `handed`."""

    def __init__(self, model, x):
        super().__init__()
        self.model, self.x = model, x

    def forward(self, x):
        self.handed = x
        return self.model(self.x)


class TappedPredictor:
    """JAX's predictor, keeping in `seen` the proxy it is given and the
    gradient of the loss with respect to its outputs (host callbacks from
    inside the jitted step)."""

    def __init__(self, model):
        self.model, self.seen = model, {}

        @jax.custom_vjp
        def tap(out):
            return out

        def tap_bwd(_, g):
            jax.debug.callback(partial(self._keep, "cotangents"), g)
            return (g,)

        tap.defvjp(lambda out: (out, None), tap_bwd)
        self.tap = tap

    def _keep(self, name, value):
        self.seen[name] = jax.tree_util.tree_map(np.asarray, value)

    def apply(self, variables, proxy, **kwargs):
        jax.debug.callback(partial(self._keep, "proxy"), proxy)
        pred, mutated = self.model.apply(variables, proxy, **kwargs)
        return self.tap(pred), mutated


def jax_float64_gradients(jmodel, variables, x, cotangents):
    """JAX's predictor's parameter gradients in float64, in train mode, from
    input `x` and upstream `cotangents` (dict of output name -> array):
    with jax_enable_x64, and flax's BatchNorm computing in float64 (the JAX
    package pins it to float32)."""
    batch_norm = flax.linen.BatchNorm

    @jax.jit
    def vjp(params, x, cotangents):
        def f(params):
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, mutable=["batch_stats"])
            return {k: out[k] for k in cotangents}
        return jax.vjp(f, params)[1](cotangents)[0]

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm",
                   lambda *a, **k: batch_norm(*a, **{**k, "dtype": jnp.float64}))
        g = vjp(f64(variables["params"]), f64(x), f64(cotangents))
        return jax.tree_util.tree_map(np.asarray, g)


def make_batch(size):
    """Poses, uint8 backgrounds at `size` and uint8 textures, from a seed."""
    rng = np.random.RandomState(12)
    pose = (rng.randn(B, 72) * 0.3).astype(np.float32)
    pose[:, :3] = 0.1 * rng.randn(B, 3)
    return (pose, (rng.rand(B, 3, size, size) * 255).astype(np.uint8),
            (rng.rand(B, 60, 40, 3) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def batch():
    return make_batch(D)


def packed_batch(batch, store_dir):
    """A batch from the port's native sampler over stores of `batch`'s
    poses, backgrounds and its atlases sampled per vertex by the port's
    pack tool: uint8 (B, 7829, 3) texels in place of the atlases. The
    sampler runs in sequential mode (NativeTrainLoader's shuffled draws
    pick records with replacement: 2 of 2 repeat one half the time, and a
    batch of one pose twice puts the train-mode BatchNorm over two
    near-equal samples, which on the CPU moved head gradients to 1.95 of
    the bound below), so the batch holds each record once."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeBatchSampler, write_tensor_store)
    from hierarchicalprobabilistic3dhuman_torch.data.pack_training_stores import (
        sample_texture_atlas_at_vertices)
    pose, background, atlases = batch
    paths = [write_tensor_store(os.path.join(store_dir, f"{name}.bin"), a)
             for name, a in (("poses", pose), ("backgrounds", background),
                             ("textures", sample_texture_atlas_at_vertices(atlases)))]
    sampler = NativeBatchSampler(paths, B, n_threads=1, shuffle=False)
    try:
        out = sampler.next()
    finally:
        sampler.close()
    assert out[2].shape == (B, 7829, 3) and out[2].dtype == np.uint8
    np.testing.assert_array_equal(out[0], pose)
    return tuple(out)


@pytest.mark.parametrize("stage,texels", [pytest.param(1, False, id="1"),
                                          pytest.param(2, False, id="2"),
                                          pytest.param(1, True, id="1-packed")])
def test_train_step_matches_jax(batch, tmp_path, stage, texels):
    """The third case feeds both steps a packed batch (per-vertex texels
    from the port's native sampler), held by the same rule."""
    if texels:
        batch = packed_batch(batch, str(tmp_path))
    check_step_matches_jax(batch, stage, layers=18, size=D)


def check_step_matches_jax(batch, stage, layers, size, resnet50_rule=False):
    """One train step of the port against JAX's, with a ResNet-`layers`
    predictor on a `size`^2 proxy, by the rule of the module docstring.

    `resnet50_rule` holds a deeper predictor, whose float32 train step
    amplifies rounding far more, as follows.
    - The port's predictor runs on JAX's proxy, and the port's own proxy is
      held to it within 1e-4 absolute, every value. At ResNet-50 on 36^2
      the two proxies differed by at most 3.3e-5 (stage 1) and 4.9e-5
      (stage 2), and that alone moved the gradient of layer4.2.conv2 by 0.10
      of its largest (7.9e-4 with JAX's proxy): BatchNorm over 8 values a
      channel in layer4 amplifies the input's rounding.
    - Every gradient tensor is held to max(1e-3, 10 x (port floor + JAX
      floor)). The port's floor is the larger of its float32 backward's
      difference from its float64 one (the same input and upstream
      gradient) and its difference from the gradient of the same step with
      the predictor in float64, its outputs rounded to float32 for the loss
      (the upstream gradient moves with the forward's rounding). JAX's floor
      is its step's gradient against its predictor's float64 backward
      (jax_float64_gradients) from the proxy and upstream gradient that its
      step saw, read by host callbacks (TappedPredictor).
    - The cosine of the whole gradients is held to min(0.9999, 1 - 10 x
      the sum of the two floors' 1 - cos), and the loss terms, metric sums
      and BatchNorm statistics to max(1e-4, 10 x the largest difference of
      the predictor's float32 outputs from its float64 ones): through 53
      BatchNorms the float32 forward of ResNet-50 is 1e-4 to 4e-4 of its
      largest from the float64 one at every size and batch tried (B 2-8,
      36^2-128^2), ResNet-18's ~5e-6.
    The JAX package's and the port's float64 gradients from the same input
    and upstream gradient agree within 6e-8 of each tensor's largest.
    """
    jc, tc = small_cfg(j_cfg, size, layers), small_cfg(t_cfg, size, layers)
    stage_metrics = METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
    key = jax.random.PRNGKey(30 + stage)

    jmodel, variables = init_jax_predictor(layers, size, seed=stage)
    jpredictor = TappedPredictor(jmodel) if resnet50_rule else jmodel
    opt = _grad_capture()
    state = TrainState(variables["params"], variables["batch_stats"],
                       opt.init(variables["params"]))
    t_jax = time.perf_counter()
    with pallas_interpret():
        jstep = jax_train_step(jpredictor, jc, getattr(jc.LOSS, f"STAGE{stage}"),
                               opt, stage_metrics)
        new_state, jloss, jsums, jterms = jax.jit(jstep)(
            state, key, *(jnp.asarray(a) for a in batch))

    def to_torch(params, batch_stats=new_state.batch_stats):
        return flax_to_torch_predictor(
            {"params": jax.tree_util.tree_map(np.asarray, params),
             "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)},
            TPredictor(num_resnet_layers=layers, embed_dim=EMBED))

    jgrads = to_torch(new_state.opt_state)

    model = TPredictor(num_resnet_layers=layers, embed_dim=EMBED)
    model.load_state_dict(flax_to_torch_predictor(variables, model))
    model64 = copy.deepcopy(model).double()
    step64 = Float64Predictor(copy.deepcopy(model64))

    def port_step(predictor):
        if resnet50_rule:
            predictor = GivenInput(predictor, jproxy)
        optimizer = torch.optim.Adam(predictor.parameters(), lr=1e-4)
        step = port_train_step(predictor, tc, getattr(tc.LOSS, f"STAGE{stage}"),
                               optimizer, stage_metrics)
        out = step(JaxDraws(key), *(torch.from_numpy(a) for a in batch))
        return out, predictor

    if resnet50_rule:
        jproxy = torch.from_numpy(jpredictor.seen["proxy"])
    capture = chip_smoke.OutputCapture(model)
    t0 = time.perf_counter()
    (tloss, tsums, tterms), predictor = port_step(capture)
    print(f"ResNet-{layers} stage {stage}: JAX step {t0 - t_jax:.1f} s, port step "
          f"{time.perf_counter() - t0:.1f} s (CPU)")

    tol = 1e-4
    if resnet50_rule:
        proxy_err = float((predictor.handed - jproxy).abs().max())
        print(f"stage {stage}: the port's proxy within {proxy_err:.2e} of JAX's")
        assert proxy_err <= 1e-4
        with torch.no_grad():
            out64 = copy.deepcopy(model64).train()(capture.x.double())
        floor = max(float((capture.out[k].detach().double() - v).abs().max()
                          / v.abs().max()) for k, v in out64.items())
        tol = max(tol, 10 * floor)
        print(f"stage {stage}: the predictor's float32 outputs {floor:.2e} "
              f"of the largest from float64: terms, sums and BatchNorm "
              f"statistics held to {tol:.2e}")
    term_errs = {}
    for name, t, j in [("loss", tloss, jloss)] + [(k, tterms[k], jterms[k])
                                                  for k in jterms]:
        j = float(j)
        term_errs[name] = abs(float(t) - j) / max(abs(j), 1e-6)
        print(f"stage {stage} {name}: port {float(t):.7g} jax {j:.7g} "
              f"({term_errs[name]:.1e} rel)")
    assert max(term_errs.values()) <= tol, term_errs
    assert sorted(tsums) == sorted(jsums)
    for k in jsums:
        err = abs(float(tsums[k]) - float(jsums[k])) / max(abs(float(jsums[k])), 1e-6)
        assert err <= tol, (k, err)

    def flat(grads):
        return torch.cat([grads[n].flatten().double()
                          for n, _ in model.named_parameters()])

    def one_minus_cos(a, b):
        return 1 - float(torch.nn.functional.cosine_similarity(
            flat(a), flat(b), dim=0))

    # The float32 noise floor of each gradient: the predictor's backward in
    # float64 from the same input and the same upstream gradient, against
    # the port's float32 one.
    grads = {n: p.grad for n, p in model.named_parameters()}
    errs, floors = chip_smoke.gradient_diffs(
        model, jgrads, chip_smoke.float64_gradients(model64, capture))
    jfloors = dict.fromkeys(errs, 0.0)
    min_cos = 0.9999
    if resnet50_rule:
        port_step(step64)
        grads64 = {n: p.grad for n, p in step64.model.named_parameters()}
        _, moved = chip_smoke.gradient_diffs(model, jgrads, grads64)
        floors = {n: max(f, moved[n]) for n, f in floors.items()}
        t64 = time.perf_counter()
        j64 = to_torch(jax_float64_gradients(
            jmodel, variables, jpredictor.seen["proxy"],
            jpredictor.seen["cotangents"]))
        jfloors = {n: float((jgrads[n].double() - j64[n].double()).abs().max()
                            / j64[n].abs().max()) for n in errs}
        gaps = one_minus_cos(grads, grads64), one_minus_cos(jgrads, j64)
        min_cos = min(min_cos, 1 - 10 * sum(gaps))
        print(f"stage {stage}: the step with a float64 predictor: gradients "
              f"median {np.median(list(moved.values())):.2e}, max "
              f"{max(moved.values()):.2e} of the largest from the float32 "
              f"step's, 1 - cos {gaps[0]:.2e}; JAX's float32 gradients from "
              f"its float64 backward ({time.perf_counter() - t64:.1f} s): "
              f"median {np.median(list(jfloors.values())):.2e}, max "
              f"{max(jfloors.values()):.2e}, 1 - cos {gaps[1]:.2e}; cosine "
              f"held to >= {min_cos:.6f}")
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    buffers = 0.0
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            ref = jgrads[name]
            buffers = max(buffers, float((b - ref).abs().max() / ref.abs().max()))
    cos = 1 - one_minus_cos(grads, jgrads)
    q = np.quantile(list(errs.values()), [0.5, 0.9, 1.0])
    worst = max(errs, key=errs.get)
    print(f"stage {stage}: per-tensor gradient diff of the tensor's largest: "
          f"median {q[0]:.2e}, 90% {q[1]:.2e}, max {q[2]:.2e} ({worst}); "
          f"cosine of the whole gradients {cos:.8f}; BatchNorm statistics "
          f"max diff {buffers:.2e} of the largest")
    bound = {n: max(1e-3, 10 * (floors[n] + jfloors[n])) for n in errs}
    over = {n: (errs[n], floors[n], jfloors[n]) for n in errs
            if errs[n] > bound[n]}
    print(f"stage {stage}: float32 noise floor of the port's gradients: "
          f"median {np.median(list(floors.values())):.2e}, max "
          f"{max(floors.values()):.2e}; the largest diff is "
          f"{max(errs[n] / bound[n] for n in errs):.3f} of its bound; "
          f"beyond it (diff, port floor, JAX floor): {over}")
    assert not over
    assert buffers <= tol and cos >= min_cos


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
