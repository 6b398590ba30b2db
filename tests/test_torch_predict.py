"""The port's predict slice as a whole vs the JAX package.

The whole-slice test runs JAX's make_predict_core and the port's on the
same predictor weights (carried across with models/weights.py), the same
HRNet crop, joints and confidences, and the same sampler draws (rebuilt in
the test from JAX's key splitting: sampling_utils.py:57 then
bingham_sampling.py:47-57). Proxy size 64, renders at 64^2, 4 samples,
batch 2. The JAX renderer runs its Pallas backend in interpret mode, whose
arithmetic the port's plain rasterizer reproduces (see
tests/test_torch_rasterizer.py).
"""

from functools import partial

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu import configs as jcfg
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.predict.predict_pose_mf_shape_gaussian_net import (
    jet_colormap as j_jet, make_predict_core as j_make_predict_core)
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)

from hierarchicalprobabilistic3dhuman_torch import configs as tcfg
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
    jet_colormap as t_jet, make_predict_core as t_make_predict_core)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D, WH, N, B = 64, 64, 4, 2


def _report(name, port, ref, atol):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    print(f"{name}: max abs diff {np.abs(port - ref).max():.3e} (tol {atol})")
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=name)


def test_jet_colormap_matches():
    values = np.linspace(-0.05, 0.3, 1001).astype(np.float32)
    _report("jet", t_jet(torch.from_numpy(values)), j_jet(jnp.asarray(values)),
            1e-6)


@pytest.fixture(scope="module")
def slice_outputs():
    jax_cfg = jcfg.get_pose_shape_cfg_defaults()
    jax_cfg.DATA.PROXY_REP_SIZE = D
    port_cfg = tcfg.get_pose_shape_cfg_defaults()
    port_cfg.DATA.PROXY_REP_SIZE = D
    hrnet_cfg = tcfg.get_pose2d_hrnet_cfg_defaults()

    jmodel = JPredictor()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D)))
    tmodel = TPredictor().eval()
    tmodel.load_state_dict(flax_to_torch_predictor(
        jax.tree_util.tree_map(np.asarray, variables), tmodel))

    rng = np.random.RandomState(21)
    hr_cropped = rng.rand(B, 3, 384, 288).astype(np.float32)
    joints2D = (rng.rand(B, 17, 2) * [288, 384]).astype(np.float32)
    confs = rng.rand(B, 17).astype(np.float32)
    key = jax.random.PRNGKey(5)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        jcore = j_make_predict_core(
            jmodel.apply, jax_cfg, JSMPL.synthetic(), JCanny(threshold=0.0),
            JRenderer(img_wh=WH, projection_type="orthographic",
                      render_rgb=True, backend="pallas"),
            jcfg.get_pose2d_hrnet_cfg_defaults(), visualise_wh=WH,
            num_uncertainty_samples=N, pose_shape_vars=variables)
        ref = jcore(key, jnp.asarray(hr_cropped), jnp.asarray(joints2D),
                    jnp.asarray(confs))
        ref = {k: np.asarray(v) for k, v in ref.items()}

    # The draws JAX's core made: key -> (pose, shape) -> (eps, w).
    key_pose, _ = jax.random.split(key)
    key_eps, key_w = jax.random.split(key_pose)
    eps = jax.random.normal(key_eps, (B, 23, N * 8, 4), dtype=jnp.float32)
    w = jax.random.uniform(key_w, (B, 23, N * 8), dtype=jnp.float32)

    tcore = t_make_predict_core(tmodel, port_cfg, TSMPL.synthetic(device="cpu"),
                                TCanny(device="cpu", threshold=0.0),
                                TRenderer(device="cpu", img_wh=WH,
                                          projection_type="orthographic",
                                          render_rgb=True),
                                hrnet_cfg, num_uncertainty_samples=N)
    port = tcore(torch.from_numpy(hr_cropped), torch.from_numpy(joints2D),
                 torch.from_numpy(confs), eps=torch.from_numpy(np.asarray(eps)),
                 w=torch.from_numpy(np.asarray(w)))
    return {k: v.numpy() for k, v in port.items()}, ref


@pytest.mark.parametrize("key,atol", [
    ("cropped_joints2D", 1e-5),
    ("pose_rotmats_mode", 1e-5),
    ("shape_mean", 1e-5),
    ("cam", 1e-5),
    ("per_vertex_3Dvar", 1e-5),
    ("verts_mode", 1e-5),
    ("verts_samples", 1e-5),
    ("cropped_vis", 1e-5),
])
def test_slice_outputs_match(slice_outputs, key, atol):
    port, ref = slice_outputs
    _report(key, port[key], ref[key], atol)


def test_slice_proxy_matches(slice_outputs):
    """Heatmap channels to 1e-5; the edge channel by agreement share (an
    NMS decision can flip at a 45-degree bin edge)."""
    port, ref = slice_outputs
    _report("proxy heatmaps", port["proxy"][:, 1:], ref["proxy"][:, 1:], 1e-5)
    agree = np.mean(np.isclose(port["proxy"][:, 0], ref["proxy"][:, 0],
                               rtol=0, atol=1e-5))
    print(f"proxy edges agreement {agree}")
    assert agree >= 0.995


def test_slice_renders_match(slice_outputs):
    """6 views per image, batch 2: 99.9% of pixels agree on coverage. The
    meshes reach the renderer with vertex positions differing by <= 5e-7
    (SMPL's sums in another order); at 64^2 the SMPL faces are 1-3 px wide,
    so that moves barycentric weights and the area-weighted normals of
    near-degenerate fans. Measured on common pixels: 99th percentile 6.5e-5
    and max 2.4e-3 (RGB), 4.9e-5 and 6.4e-4 (IUV). Held to: 99% within
    5e-4, all within 1e-2. (The renderer alone, on identical inputs, matches
    to 4.5e-7: tests/test_torch_rasterizer.py.)"""
    port, ref = slice_outputs
    assert port["rgb_views"].shape == (B, 6, WH, WH, 3)
    pm = port["iuv_views"][..., 0] > 0
    rm = ref["iuv_views"][..., 0] > 0
    agree = np.mean(pm == rm)
    print(f"render coverage agreement {agree}, covered {pm.sum()}")
    assert pm.sum() > 500 and agree >= 0.999
    both = pm & rm
    for k in ("rgb_views", "iuv_views", "front"):
        err = np.abs(port[k] - ref[k])
        err = err[both] if k != "front" else err
        q99 = np.quantile(err, 0.99)
        print(f"{k}: max abs diff {err.max():.3e}, 99th percentile {q99:.3e}")
        assert q99 <= 5e-4 and err.max() <= 1e-2, k
