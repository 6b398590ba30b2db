"""The training render and the synthetic batch of the port vs the JAX
package on the CPU.

- The perspective textured renderer (training's projection: x = f X / Z +
  wh / 2, z = Z) in its three texture routes (atlas sampled per vertex,
  pre-sampled (B, 7829, 3) texels, atlas sampled per pixel), 2 meshes at
  48^2 with random per-mesh lights, against the JAX renderer on its Pallas
  backend in interpret mode (its XLA backend contracts FMAs; ROADMAP
  Queue 3): masks agree on >= 0.999 of the pixels, IUV and depth within
  1e-5 and RGB within 1e-4 on the pixels covered by both.
- make_synth_data_fn at B=2, 48^2 with JAX's own draws (tests/jax_draws.py)
  and uint8 backgrounds and textures: the targets within 1e-4 of their
  largest magnitude, visibility equal, and the proxy: >= 0.99 of its
  pixels equal within 1e-4 (the IUV is rounded to whole labels, so a
  render difference of ~1e-6 can flip a label and with it an edge pixel).
"""

from functools import partial

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)
from hierarchicalprobabilistic3dhuman_tpu.train import (
    train_pose_mf_shape_gaussian_net as jtrain)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)
from hierarchicalprobabilistic3dhuman_torch.train import (
    train_pose_mf_shape_gaussian_net as ttrain)
from jax_draws import JaxDraws

torch.set_num_threads(2)

# The focal length scaled from 300 px at 256^2, as the body fills the image
# at the configuration's own size.
D, B = 48, 2
F = 300.0 * D / 256


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def scene():
    """Two posed synthetic-SMPL meshes flipped into the camera frame as the
    train driver flips them, camera translations, lights and textures."""
    rng = np.random.RandomState(8)
    smpl = TSMPL.synthetic("cpu")
    verts = smpl(body_pose=torch.as_tensor(rng.randn(B, 69) * 0.2, dtype=torch.float32),
                 betas=torch.as_tensor(rng.randn(B, 10), dtype=torch.float32)
                 )["vertices"].numpy() * np.float32([1.0, -1.0, -1.0])
    cam_t = np.float32([[0.02, -0.2, 2.6], [-0.05, -0.15, 2.3]])
    lights = {k: rng.uniform(0.2, 0.8, (B, 3)).astype(np.float32)
              for k in ("ambient_color", "diffuse_color", "specular_color")}
    lights["location"] = rng.randn(B, 3).astype(np.float32)
    atlas = rng.rand(B, 60, 40, 3).astype(np.float32)
    texels = rng.rand(B, 7829, 3).astype(np.float32)
    return verts, cam_t, lights, atlas, texels


@pytest.mark.parametrize("route", ["vertex", "pre-sampled", "pixel"])
def test_perspective_textured_render_matches_jax(scene, interpret_pallas, route):
    verts, cam_t, lights, atlas, texels = scene
    mode = "pixel" if route == "pixel" else "vertex"
    tex = texels if route == "pre-sampled" else atlas
    port = TRenderer("cpu", img_wh=D, projection_type="perspective",
                     perspective_focal_length=F, render_rgb=True,
                     texture_mode=mode)(
        torch.from_numpy(verts), cam_t=torch.from_numpy(cam_t),
        lights_rgb_settings={k: torch.from_numpy(v) for k, v in lights.items()},
        textures=torch.from_numpy(tex))
    ref = JRenderer(img_wh=D, projection_type="perspective",
                    perspective_focal_length=F, render_rgb=True,
                    backend="pallas", texture_mode=mode)(
        jnp.asarray(verts), textures=jnp.asarray(tex), cam_t=jnp.asarray(cam_t),
        lights_rgb_settings={k: jnp.asarray(v) for k, v in lights.items()})
    pm = port["silhouettes"].numpy() > 0
    rm = np.asarray(ref["silhouettes"]) > 0
    agree, both = np.mean(pm == rm), pm & rm
    print(f"{route}: {pm.sum()} covered px, mask agreement {agree:.6f}")
    assert pm.sum() > 200 and agree >= 0.999
    for k, tol in (("iuv_images", 1e-5), ("depth_images", 1e-5),
                   ("rgb_images", 1e-4)):
        err = np.abs(port[k].numpy()[both] - np.asarray(ref[k])[both]).max()
        print(f"{route} {k}: max abs diff on common pixels {err:.2e}")
        assert err <= tol, (k, err)


def test_synth_data_matches_jax(interpret_pallas):
    rng = np.random.RandomState(9)
    pose = (rng.randn(B, 72) * 0.3).astype(np.float32)
    pose[:, :3] = 0.1 * rng.randn(B, 3)
    bg = (rng.rand(B, 3, D, D) * 255).astype(np.uint8)
    tex = (rng.rand(B, 60, 40, 3) * 255).astype(np.uint8)
    key = jax.random.PRNGKey(21)

    jc, tc = j_cfg(), t_cfg()
    for c in (jc, tc):
        c.DATA.PROXY_REP_SIZE = D
        c.TRAIN.SYNTH_DATA.FOCAL_LENGTH = F
    jsynth = jtrain.make_synth_data_fn(
        jc, JSMPL.synthetic(), JRenderer(img_wh=D, projection_type="perspective",
                                         perspective_focal_length=F,
                                         render_rgb=True, backend="pallas"),
        JCanny(threshold=0.0))
    jproxy, jtargets = jsynth(key, jnp.asarray(pose), jnp.asarray(bg), jnp.asarray(tex))
    tsynth = ttrain.make_synth_data_fn(
        tc, TSMPL.synthetic("cpu"),
        TRenderer("cpu", img_wh=D, projection_type="perspective",
                  perspective_focal_length=F, render_rgb=True),
        TCanny("cpu", threshold=0.0))
    tproxy, ttargets = tsynth(JaxDraws(key), torch.from_numpy(pose),
                              torch.from_numpy(bg), torch.from_numpy(tex))

    for k in sorted(jtargets):
        r, p = np.asarray(jtargets[k]), ttargets[k].numpy()
        if r.dtype == bool:
            assert np.array_equal(r, p), k
            print(f"target {k}: equal ({int(r.sum())} of {r.size} visible)")
            continue
        err = np.abs(p - r).max() / max(np.abs(r).max(), 1.0)
        print(f"target {k}: max diff {err:.2e} of the largest")
        assert err <= 1e-4, (k, err)
    jproxy = np.asarray(jproxy)
    equal = np.isclose(tproxy.numpy(), jproxy, rtol=0, atol=1e-4)
    share = equal.mean()
    print(f"proxy {jproxy.shape}: {share:.6f} of its values equal within "
          f"1e-4 ({(jproxy[:, 0] > 0).mean():.3f} of the pixels are edges)")
    assert share >= 0.99
