"""Port's rasterizer and renderer vs the JAX package, and the kernel wrapper.

The port's plain rasterizer (ops/rasterizer.py, what CPU tensors run) is
held against JAX's XLA backend and against the Pallas kernel in interpret
mode (as tests/test_rasterizer_pallas.py runs it). The masks must be equal
on the hand-made triangles; elsewhere at least 99.9% of pixels must agree
(XLA's CPU code may contract FMAs where the port does not), and attrs and
depth must agree to 1e-4 where both masks are set. The CUDA kernel itself
is tested in tests/test_torch_kernels.py.
"""

from functools import partial

import numpy as np
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.ops.rasterizer import rasterize as j_rasterize
import hierarchicalprobabilistic3dhuman_tpu.ops.rasterizer_pallas as jrp
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)

from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.ops import rasterizer_cuda as trc
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

RNG_SEED = 77


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))


def _port(verts, faces, attrs, hw):
    return trc.rasterize(torch.from_numpy(verts), torch.from_numpy(faces).long(),
                         torch.from_numpy(attrs), hw)


def _compare(port, ref, min_agree, name=""):
    pm, rm = port["mask"].numpy(), np.asarray(ref["mask"])
    agree = np.mean(pm == rm)
    both = pm & rm
    attr_err = np.abs(port["attrs"].numpy()[both]
                      - np.asarray(ref["attrs"])[both]).max(initial=0.0)
    depth_err = np.abs(port["depth"].numpy()[both]
                       - np.asarray(ref["depth"])[both]).max(initial=0.0)
    print(f"{name}: mask agreement {agree:.6f}, attrs {attr_err:.2e}, "
          f"depth {depth_err:.2e}")
    assert agree >= min_agree, agree
    assert attr_err <= 1e-4 and depth_err <= 1e-4
    assert np.all(np.isinf(port["depth"].numpy()[~pm]))


def _both_refs(verts, faces, attrs, hw):
    args = (jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), hw)
    return {"xla": j_rasterize(*args, backend="xla"),
            "pallas": jrp.rasterize_batched_pallas(*args)}


def _triangles():
    verts = np.array([[
        [4.0, 4.0, 2.0], [28.0, 4.0, 2.0], [4.0, 28.0, 2.0],
        [0.0, 0.0, 5.0], [60.0, 0.0, 5.0], [0.0, 60.0, 5.0],
        [30.5, 30.5, 1.0], [50.5, 30.5, 1.0], [30.5, 50.5, 1.0],
        [50.5, 30.5, 1.0], [50.5, 50.5, 1.0], [30.5, 50.5, 1.0],
    ]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]], np.int32)
    attrs = np.array([[[1, 0]] * 3 + [[0, 1]] * 3 + [[2, 2]] * 6], np.float32)
    return verts, faces, attrs


def _random_mesh(rng, V, F, B, H, W, A):
    verts = np.stack([np.stack([rng.rand(V) * (W - 2), rng.rand(V) * (H - 2),
                                rng.rand(V) * 3 + 1], axis=-1)
                      for _ in range(B)]).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    return verts, faces, rng.rand(B, V, A).astype(np.float32)


def test_hand_made_triangles_masks_equal(interpret_pallas):
    """Nested triangles at two depths and a square split on its diagonal
    through pixel centres (a shared edge)."""
    verts, faces, attrs = _triangles()
    port = _port(verts, faces, attrs, (64, 64))
    for name, ref in _both_refs(verts, faces, attrs, (64, 64)).items():
        np.testing.assert_array_equal(port["mask"].numpy(), np.asarray(ref["mask"]))
        _compare(port, ref, 1.0, name)


@pytest.mark.parametrize("hw,V,F,B", [
    ((64, 64), 60, 40, 2),
    ((96, 96), 50, 30, 2),      # 36 tiles: the Pallas tile-group padding case
])
def test_random_meshes_match(interpret_pallas, hw, V, F, B):
    rng = np.random.RandomState(RNG_SEED + hw[0])
    verts, faces, attrs = _random_mesh(rng, V, F, B, *hw, 5)
    port = _port(verts, faces, attrs, hw)
    for name, ref in _both_refs(verts, faces, attrs, hw).items():
        _compare(port, ref, 0.999, name)


def test_pack_face_tables_matches():
    rng = np.random.RandomState(RNG_SEED)
    verts, faces, attrs = _random_mesh(rng, 60, 300, 2, 64, 64, 4)
    port = trc.pack_face_tables(torch.from_numpy(verts),
                                torch.from_numpy(faces).long(),
                                torch.from_numpy(attrs), (64, 64))[:3]
    ref = jrp.pack_face_tables(jnp.asarray(verts), jnp.asarray(faces),
                               jnp.asarray(attrs))
    assert [tuple(p.shape) for p in port] == [r.shape for r in ref]
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    g_p, g_r = port[0].numpy(), np.asarray(ref[0])
    rel = np.abs(g_p - g_r) / np.maximum(np.abs(g_r), 1.0)
    print(f"geometry rows: max diff relative to max(|x|, 1) {rel.max():.2e}")
    assert rel.max() <= 1e-5


@pytest.fixture(scope="module")
def smpl_scene():
    """Six synthetic-SMPL views as the predict path poses them, orthographic,
    with per-vertex colours (A = 12)."""
    rng = np.random.RandomState(3)
    smpl = SMPL.synthetic(device="cpu")
    pose = torch.as_tensor(rng.randn(1, 69) * 0.2, dtype=torch.float32)
    verts = smpl(body_pose=pose)["vertices"]
    verts = verts * torch.tensor([1.0, -1.0, -1.0])        # rotate pi about x
    angles = [0.0, -np.pi / 2, -np.pi, -1.5 * np.pi, 0.3, 1.2]
    views = []
    for a in angles:
        c, s = np.cos(a), np.sin(a)
        R = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32)
        views.append(verts @ R.T)
    verts = torch.cat(views).numpy()
    feats = rng.rand(6, 6890, 3).astype(np.float32)
    cam_t = np.array([[0.0, -0.2, 2.5]] * 6, np.float32)
    scale = np.full((6, 2), 0.95, np.float32)
    lights = {"location": [0.0, -0.8, -2.0], "ambient_color": [0.5] * 3,
              "diffuse_color": [0.3] * 3, "specular_color": [0.0] * 3}
    lights = {k: np.tile(np.asarray(v, np.float32), (6, 1))
              for k, v in lights.items()}
    return verts, feats, cam_t, scale, lights


def test_renderer_matches_jax(smpl_scene, interpret_pallas):
    """The whole renderer (screen transform with the batch-wide z shift,
    normals by scatter-add, A=12 rasterization, Phong) at 64^2, against the
    JAX renderer on its Pallas backend (interpret mode). Its XLA backend
    contracts the barycentric planes into FMAs on the CPU, which on faces
    1-3 px wide moved the interpolated part label (up to 24) by 1.05e-3 and
    would hide the port's own error; against Pallas the measured maxima are
    0 (IUV, depth) and 4.5e-7 (RGB)."""
    verts, feats, cam_t, scale, lights = smpl_scene
    port = TRenderer(device="cpu", img_wh=64, projection_type="orthographic",
                     render_rgb=True)(
        torch.from_numpy(verts), cam_t=torch.from_numpy(cam_t),
        orthographic_scale=torch.from_numpy(scale),
        lights_rgb_settings={k: torch.from_numpy(v) for k, v in lights.items()},
        verts_features=torch.from_numpy(feats))
    ref = JRenderer(img_wh=64, projection_type="orthographic", render_rgb=True,
                    backend="pallas")(
        jnp.asarray(verts), cam_t=jnp.asarray(cam_t),
        orthographic_scale=jnp.asarray(scale),
        lights_rgb_settings={k: jnp.asarray(v) for k, v in lights.items()},
        verts_features=jnp.asarray(feats))
    pm = port["iuv_images"][..., 0].numpy() > 0
    rm = np.asarray(ref["iuv_images"])[..., 0] > 0
    agree = np.mean(pm == rm)
    both = pm & rm
    print(f"renderer: {pm.sum()} covered px, mask agreement {agree:.6f}")
    assert pm.sum() > 1000 and agree >= 0.999
    for k, tol in (("iuv_images", 1e-5), ("depth_images", 1e-5),
                   ("rgb_images", 1e-5)):
        err = np.abs(port[k].numpy()[both] - np.asarray(ref[k])[both]).max()
        print(f"renderer {k}: max abs diff on common pixels {err:.2e}")
        assert err <= tol, (k, err)


def test_smpl_scene_packed_tables_match_pallas_interpret(smpl_scene,
                                                         interpret_pallas):
    """One synthetic-SMPL 6-view scene (13,824 padded faces, 108 chunks)
    through the port's plain rasterizer and JAX's Pallas kernel."""
    verts, feats, cam_t, scale, _ = smpl_scene
    renderer = TRenderer(device="cpu", img_wh=48, projection_type="orthographic",
                         render_rgb=True)
    screen, vert_attrs = renderer.raster_inputs(
        torch.from_numpy(verts), torch.from_numpy(cam_t),
        torch.from_numpy(scale), torch.from_numpy(feats))
    faces = renderer.faces
    port = trc.rasterize(screen, faces, vert_attrs, (48, 48))
    ref = jrp.rasterize_batched_pallas(jnp.asarray(screen.numpy()),
                                       jnp.asarray(faces.numpy()),
                                       jnp.asarray(vert_attrs.numpy()), (48, 48))
    _compare(port, ref, 0.999, "smpl scene vs pallas")
