"""The port's TexturedIUVRenderer takes the JAX package's constructor
defaults (256^2, perspective, IUV without colours, the configured UV file),
and the callers that relied on the port's old defaults (512^2,
orthographic, colours) pass their values.

  * TexturedIUVRenderer("cpu") and JAX's TexturedIUVRenderer() render one
    synthetic SMPL mesh alike, against JAX's XLA backend (its default on
    the CPU) at the renderer tests' tolerances: >= 99.9% of the pixels'
    masks agree, and where both are set depth and the U and V channels
    within 1e-4, the part label (0-24) within 2e-3: XLA contracts the
    barycentric planes into FMAs on the CPU, which moved a label by
    1.05e-3 at 64^2 in tests/test_torch_rasterizer.py (why those tests
    hold the renderer to Pallas);
  * the SSP-3D evaluation driver's silhouette renderer is orthographic,
    as JAX's (evaluate_pose_mf_shape_gaussian_net.py:360), and its
    silhouettes of the first batch equal JAX's renderer's, built as JAX's
    driver builds it, on the same meshes (Pallas in interpret mode, which
    the port matches exactly).
"""

from functools import partial

import numpy as np
import jax.experimental.pallas as pl
import jax.numpy as jnp
import torch

from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.evaluate import (
    evaluate_pose_mf_shape_gaussian_net as tev)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)
from test_eval_driver import _TinyEvalDataset

torch.set_num_threads(2)


def test_default_renderers_render_alike():
    port, ref = TRenderer("cpu"), JRenderer()
    settings = ("img_wh", "projection_type", "render_rgb", "focal_length",
                "orthographic_scale", "texture_mode")
    assert ([getattr(port, k) for k in settings]
            == [getattr(ref, k) for k in settings]
            == [256, "perspective", False, 300.0, 0.9, "vertex"])
    rng = np.random.RandomState(0)
    pose = torch.as_tensor(rng.randn(1, 69) * 0.2, dtype=torch.float32)
    verts = TSMPL.synthetic(device="cpu")(body_pose=pose)["vertices"]
    verts = (verts * torch.tensor([1.0, -1.0, -1.0])).numpy()   # pi about x
    p = {k: v.numpy() for k, v in port(torch.from_numpy(verts)).items()}
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(verts)).items()}
    assert sorted(p) == sorted(r) == ["depth_images", "iuv_images", "silhouettes"]
    pm, rm = p["silhouettes"] > 0, r["silhouettes"] > 0
    both = pm & rm
    agree = np.mean(pm == rm)
    channels = np.abs(p["iuv_images"][both] - r["iuv_images"][both]).max(axis=0)
    label, uv = channels[0], channels[1:].max()
    depth = np.abs(p["depth_images"][both] - r["depth_images"][both]).max()
    print(f"default renderers at 256^2, perspective: {pm.sum()} covered px, "
          f"mask agreement {agree:.6f} (tol 0.999), part label {label:.2e} "
          f"(tol 2e-3), U and V {uv:.2e}, depth {depth:.2e} (tol 1e-4)")
    assert pm.sum() > 1000 and agree >= 0.999
    assert label <= 2e-3 and uv <= 1e-4 and depth <= 1e-4


class _RecordingRenderer(TRenderer):
    """The port's renderer, keeping what each call was given and gave."""
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []
        _RecordingRenderer.made.append(self)

    def __call__(self, vertices, cam_t=None, orthographic_scale=None, **kwargs):
        out = super().__call__(vertices, cam_t=cam_t,
                               orthographic_scale=orthographic_scale, **kwargs)
        self.calls.append((vertices, cam_t, orthographic_scale, out))
        return out


def test_ssp3d_eval_silhouettes_unchanged(tmp_path, monkeypatch):
    D = 32
    cfg = t_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    monkeypatch.setattr(tev, "TexturedIUVRenderer", _RecordingRenderer)
    _RecordingRenderer.made.clear()
    tev.evaluate_pose_mf_shape_gaussian_net(
        pose_shape_model=init_weights(TPredictor(embed_dim=64),
                                      torch.Generator().manual_seed(0)).eval(),
        pose_shape_cfg=cfg, smpl_neutral=TSMPL.synthetic("cpu", seed=0),
        smpl_male=TSMPL.synthetic("cpu", seed=1),
        smpl_female=TSMPL.synthetic("cpu", seed=2),
        edge_detect_model=TCanny("cpu", threshold=0.0),
        metrics=["silhouette-IOU", "silhouettesamples-IOU"],
        eval_dataset=_TinyEvalDataset(), device=torch.device("cpu"),
        batch_size=2, num_workers=0, num_samples_for_metrics=2,
        save_path=str(tmp_path), save_per_frame_metrics=False)
    (renderer,) = _RecordingRenderer.made
    assert (renderer.img_wh, renderer.projection_type, renderer.render_rgb) == (
        D, "orthographic", False)
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    jrenderer = JRenderer(img_wh=D, projection_type="orthographic",
                          render_rgb=False, backend="pallas")
    for verts, cam_t, scale, out in renderer.calls[:2]:
        ref = jrenderer(jnp.asarray(verts.numpy()), cam_t=jnp.asarray(cam_t.numpy()),
                        orthographic_scale=jnp.asarray(scale.numpy()))
        covered = int(out["silhouettes"].sum())
        print(f"silhouettes {tuple(out['silhouettes'].shape)}: {covered} covered "
              f"px, equal to JAX's")
        assert covered > 0
        np.testing.assert_array_equal(out["silhouettes"].numpy(),
                                      np.asarray(ref["silhouettes"]))
