"""The port's figure path vs the JAX package: resampling with the nearest
mode and a pad value, uncropping, the camera and joint helpers, the sample
meshes sorted by 2D joint error, the predict core's outputs for the figures
and the batched driver, and the samples figure's render.

Tolerances: nearest resampling exactly equal, bilinear within 1e-5; the
sampling order exactly equal; the core's outputs within 1e-5 (as in
tests/test_torch_predict.py); the samples render held as that file's
test_slice_renders_match holds renders. Each test prints its max diff.
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
from hierarchicalprobabilistic3dhuman_tpu.ops.resample import (
    affine_resample as j_affine_resample)
from hierarchicalprobabilistic3dhuman_tpu.predict.predict_pose_mf_shape_gaussian_net import (
    make_predict_core as j_make_predict_core)
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)
from hierarchicalprobabilistic3dhuman_tpu.utils import cam_utils as jcam
from hierarchicalprobabilistic3dhuman_tpu.utils import image_utils as jimg
from hierarchicalprobabilistic3dhuman_tpu.utils import joints2d_utils as jj2d
from hierarchicalprobabilistic3dhuman_tpu.utils.image_utils import (
    batch_add_rgb_background as j_add_background)
from hierarchicalprobabilistic3dhuman_tpu.utils.label_conversions import (
    convert_heatmaps_to_2Djoints_coordinates as j_heatmaps_to_joints)
from hierarchicalprobabilistic3dhuman_tpu.utils.rotation_utils import (
    aa_rotate_translate_points as j_rotate)
from hierarchicalprobabilistic3dhuman_tpu.utils.sampling_utils import (
    joints2D_error_sorted_verts_sampling as j_sorted_sampling)

from hierarchicalprobabilistic3dhuman_torch import configs as tcfg
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from hierarchicalprobabilistic3dhuman_torch.ops.resample import (
    affine_resample as t_affine_resample)
from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
    make_predict_core as t_make_predict_core, samples_core)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)
from hierarchicalprobabilistic3dhuman_torch.utils import cam_utils as tcam
from hierarchicalprobabilistic3dhuman_torch.utils import image_utils as timg
from hierarchicalprobabilistic3dhuman_torch.utils import joints2d_utils as tj2d
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_heatmaps_to_2Djoints_coordinates as t_heatmaps_to_joints)
from hierarchicalprobabilistic3dhuman_torch.utils.sampling_utils import (
    joints2D_error_sorted_verts_sampling as t_sorted_sampling)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D, WH, N, B = 64, 64, 4, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _report(name, port, ref, atol):
    port = np.asarray(port).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    print(f"{name}: max abs diff {np.abs(port - ref).max():.3e} (tol {atol})")
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=name)


def _affines(rng, n):
    """Scale + translate forward affines that map part of a 40 x 30 image
    off a 50 x 45 output and leave part of the output outside the image;
    some sample half-integer coordinates (round-half-even ties)."""
    a = np.zeros((n, 2, 3), np.float32)
    a[:, 0, 0] = rng.uniform(0.6, 2.0, n)
    a[:, 1, 1] = rng.uniform(0.6, 2.0, n)
    a[:, :, 2] = rng.uniform(-15, 15, (n, 2))
    a[0] = [[2.0, 0.0, 1.0], [0.0, 2.0, -3.0]]           # src = (x - 1) / 2
    return a


@pytest.mark.parametrize("mode,pad_val,atol", [("nearest", 0.0, 0.0),
                                               ("nearest", 7.0, 0.0),
                                               ("bilinear", 0.0, 1e-5),
                                               ("bilinear", -2.5, 1e-5)])
def test_affine_resample_modes_match(mode, pad_val, atol):
    rng = np.random.RandomState(0)
    img = rng.rand(4, 3, 40, 30).astype(np.float32)
    aff = _affines(rng, 4)
    port = t_affine_resample(_t(img), _t(aff), (50, 45), mode=mode,
                             pad_val=pad_val)
    ref = j_affine_resample(jnp.asarray(img), jnp.asarray(aff), (50, 45),
                            mode=mode, pad_val=pad_val, assume_axis_aligned=True)
    _report(f"affine_resample {mode} pad {pad_val}", port, ref, atol)
    if mode == "nearest":
        assert (port.numpy() == pad_val).any() and (port.numpy() != pad_val).any()


def test_batch_uncrop_affine_matches():
    """rgb bilinear, iuv nearest with an out-of-frame pad value, seg
    nearest: a 64^2 crop pasted into a 90 x 120 frame."""
    rng = np.random.RandomState(1)
    rgb = rng.rand(3, 3, 64, 64).astype(np.float32)
    iuv = np.round(rng.rand(3, 3, 64, 64) * 24).astype(np.float32)
    seg = np.round(rng.rand(3, 64, 64) * 5).astype(np.float32)
    centres = np.array([[45.0, 60.0], [20.5, 100.0], [80.0, 10.0]], np.float32)
    whs = np.array([70.0, 33.3, 150.0], np.float32)
    port = timg.batch_uncrop_affine((64, 64), (120, 90), _t(centres), _t(whs),
                                    _t(whs), iuv=_t(iuv), rgb=_t(rgb),
                                    seg=_t(seg), out_of_frame_pad_val=-1.0)
    ref = jimg.batch_uncrop_affine((64, 64), (120, 90), centres, whs, whs,
                                   iuv=jnp.asarray(iuv), rgb=jnp.asarray(rgb),
                                   seg=jnp.asarray(seg), out_of_frame_pad_val=-1.0)
    _report("uncrop rgb", port["rgb"], ref["rgb"], 1e-5)
    _report("uncrop iuv", port["iuv"], ref["iuv"], 0.0)
    _report("uncrop seg", port["seg"], ref["seg"], 0.0)
    assert port["iuv"].shape == (3, 3, 90, 120)
    assert (port["iuv"] == -1.0).any() and (port["iuv"] > 0).any()


def test_bbox_converters_match():
    rng = np.random.RandomState(2)
    corners = (rng.rand(5, 4) * 100).astype(np.float32)
    port = timg.convert_bbox_corners_to_centre_hw(_t(corners))
    ref = jimg.convert_bbox_corners_to_centre_hw(jnp.asarray(corners))
    for name, p, r in zip(("centre", "height", "width"), port, ref):
        _report(f"corners_to_centre_hw {name}", p, r, 0.0)
    _report("centre_hw_to_corners",
            timg.convert_bbox_centre_hw_to_corners(*port),
            jimg.convert_bbox_centre_hw_to_corners(*ref), 1e-5)


def test_camera_and_joint_helpers_match():
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 17, 3).astype(np.float32)
    pts[0, 0, 2] = -0.005                      # on the camera plane: clamped
    cam = rng.rand(2, 3).astype(np.float32) + [0.5, 0.0, 0.0]
    rot = np.stack([np.eye(3, dtype=np.float32)] * 2)
    trans = np.array([[0.0, 0.1, 3.0], [0.2, 0.0, 2.0]], np.float32)
    _report("orthographic_project", tcam.orthographic_project(_t(pts), _t(cam)),
            jcam.orthographic_project(jnp.asarray(pts), jnp.asarray(cam)), 1e-6)
    _report("perspective_project",
            tcam.perspective_project(_t(pts), _t(rot), _t(trans),
                                     focal_length=300.0, img_wh=256),
            jcam.perspective_project(jnp.asarray(pts), jnp.asarray(rot),
                                     jnp.asarray(trans), focal_length=300.0,
                                     img_wh=256), 1e-3)
    _report("batch_convert_weak_perspective",
            tcam.batch_convert_weak_perspective_to_camera_translation(
                _t(cam), 5000.0, 256),
            jcam.batch_convert_weak_perspective_to_camera_translation(
                jnp.asarray(cam), 5000.0, 256), 1e-3)
    _report("get_intrinsics_matrix", tcam.get_intrinsics_matrix(256, 200, 300.0),
            jcam.get_intrinsics_matrix(256, 200, 300.0), 0.0)
    _report("convert_weak_perspective",
            tcam.convert_weak_perspective_to_camera_translation(cam[0], 5000.0, 256),
            jcam.convert_weak_perspective_to_camera_translation(cam[0], 5000.0, 256),
            0.0)

    j2d = (rng.rand(2, 17, 2) * 300 - 20).astype(np.float32)
    j2d[0, 0] = [256.0, 256.0]                 # on the boundary: visible
    _report("undo_keypoint_normalisation",
            tj2d.undo_keypoint_normalisation(_t(j2d / 128 - 1), 256),
            jj2d.undo_keypoint_normalisation(jnp.asarray(j2d / 128 - 1), 256), 1e-4)
    _report("normalise_keypoints", tj2d.normalise_keypoints(_t(j2d), 256),
            jj2d.normalise_keypoints(jnp.asarray(j2d), 256), 1e-6)
    vis = tj2d.check_joints2d_visibility(_t(j2d), 256)
    _report("check_joints2d_visibility", vis,
            jj2d.check_joints2d_visibility(jnp.asarray(j2d), 256), 0)
    seg = rng.randint(0, 15, (2, 32, 32)).astype(np.int32)
    seg[1, :16] = 3                            # part 3 large in image 1 only
    _report("check_joints2d_occluded",
            tj2d.check_joints2d_occluded(_t(seg), vis, pixel_count_threshold=60),
            jj2d.check_joints2d_occluded(jnp.asarray(seg), jnp.asarray(vis.numpy()),
                                         pixel_count_threshold=60), 0)


def test_heatmaps_to_joints_match():
    rng = np.random.RandomState(4)
    hm = rng.rand(2, 17, 12, 10).astype(np.float32) * 0.1
    hm[0, 3] = 0.0                             # invisible joint
    hm[1, 5, 4, 7] = hm[1, 5, 8, 2] = 0.5      # tie: the first index wins
    port = t_heatmaps_to_joints(_t(hm))
    ref = j_heatmaps_to_joints(jnp.asarray(hm))
    _report("heatmaps -> joints", port[0], ref[0], 0.0)
    _report("heatmaps -> visibility", port[1], ref[1], 0)
    assert port[0][0, 3].tolist() == [-1.0, -1.0]


def _sorting_inputs(seed, visible):
    rng = np.random.RandomState(seed)
    verts = rng.randn(8, 6890, 3).astype(np.float32)
    joints = (rng.randn(8, 90, 3) * 0.4).astype(np.float32)
    joints[3] = joints[5]                      # two samples of equal error
    heatmaps = np.zeros((1, 17, 32, 32), np.float32)
    for j in range(17):
        if visible[j]:
            heatmaps[0, j, rng.randint(32), rng.randint(32)] = 1.0
    cam = np.array([[0.9, 0.05, -0.1]], np.float32)
    return verts, joints, heatmaps, cam


@pytest.mark.parametrize("visible", ["all", "some", "none"])
def test_sorted_verts_sampling_order_matches(visible):
    """Same order (exact), with a tie between two samples; with no visible
    joint every error is -inf and the order is the draw order."""
    vis = {"all": [1] * 17, "some": [1, 0] * 8 + [1], "none": [0] * 17}[visible]
    verts, joints, heatmaps, cam = _sorting_inputs(5, vis)
    port = t_sorted_sampling(_t(verts), _t(joints), _t(heatmaps), _t(cam))
    ref = j_sorted_sampling(jnp.asarray(verts), jnp.asarray(joints),
                            jnp.asarray(heatmaps), jnp.asarray(cam))
    order_p = [int(np.flatnonzero((verts == v).all(axis=(1, 2)))[0])
               for v in port.numpy()]
    order_r = [int(np.flatnonzero((verts == v).all(axis=(1, 2)))[0])
               for v in np.asarray(ref)]
    print(f"order port {order_p}, JAX {order_r}")
    assert order_p == order_r
    _report("sorted vertices", port, ref, 0.0)
    if visible == "none":
        assert order_p == list(range(8))


def _draws(key, n_images, n_samples):
    """The sampler draws JAX's core made from `key` (sampling_utils.py:57,
    bingham_sampling.py:47-57)."""
    key_pose, _ = jax.random.split(key)
    key_eps, key_w = jax.random.split(key_pose)
    eps = jax.random.normal(key_eps, (n_images, 23, n_samples * 8, 4))
    w = jax.random.uniform(key_w, (n_images, 23, n_samples * 8))
    return torch.from_numpy(np.asarray(eps)), torch.from_numpy(np.asarray(w))


@pytest.fixture(scope="module")
def cores():
    """JAX's core (figures on: its outputs hold those of render_vis=False),
    and the port's core with render_vis=False and True, on the same weights,
    inputs and draws. Batch 2, proxy 64, renders at 64^2, 4 samples."""
    jax_cfg = jcfg.get_pose_shape_cfg_defaults()
    jax_cfg.DATA.PROXY_REP_SIZE = D
    port_cfg = tcfg.get_pose_shape_cfg_defaults()
    port_cfg.DATA.PROXY_REP_SIZE = D
    hrnet_cfg = tcfg.get_pose2d_hrnet_cfg_defaults()

    jmodel = JPredictor()
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 18, D, D)))
    tmodel = TPredictor().eval()
    tmodel.load_state_dict(flax_to_torch_predictor(
        jax.tree_util.tree_map(np.asarray, variables), tmodel))

    rng = np.random.RandomState(31)
    hr_cropped = rng.rand(B, 3, 384, 288).astype(np.float32)
    joints2D = (rng.rand(B, 17, 2) * [288, 384]).astype(np.float32)
    confs = rng.rand(B, 17).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jrenderer = JRenderer(img_wh=WH, projection_type="orthographic",
                          render_rgb=True, backend="pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        jcore = j_make_predict_core(
            jmodel.apply, jax_cfg, JSMPL.synthetic(), JCanny(threshold=0.0),
            jrenderer, jcfg.get_pose2d_hrnet_cfg_defaults(), visualise_wh=WH,
            num_uncertainty_samples=N, pose_shape_vars=variables)
        ref = jcore(key, jnp.asarray(hr_cropped), jnp.asarray(joints2D),
                    jnp.asarray(confs))

    eps, w = _draws(key, B, N)
    trenderer = TRenderer(device="cpu", img_wh=WH, projection_type="orthographic",
                          render_rgb=True)
    kwargs = dict(pose_shape_model=tmodel, pose_shape_cfg=port_cfg,
                  smpl_model=TSMPL.synthetic(device="cpu"),
                  edge_detect_model=TCanny(device="cpu", threshold=0.0),
                  hrnet_cfg=hrnet_cfg, num_uncertainty_samples=N)
    inputs = (_t(hr_cropped), _t(joints2D), _t(confs))
    no_vis = t_make_predict_core(body_vis_renderer=None, render_vis=False,
                                 **kwargs)(*inputs, eps=eps, w=w)
    vis = t_make_predict_core(body_vis_renderer=trenderer, **kwargs)(
        *inputs, eps=eps, w=w)
    return {"jax": ref, "no_vis": no_vis, "vis": vis,
            "jrenderer": jrenderer, "trenderer": trenderer}


@pytest.mark.parametrize("key", ["pred_cam_t", "pred_scale", "joints_samples",
                                 "pose_rotmats_mode", "shape_mean", "cam",
                                 "per_vertex_3Dvar", "verts_samples",
                                 "verts_mode"])
def test_core_outputs_without_render_match(cores, key):
    _report(f"render_vis=False {key}", cores["no_vis"][key],
            np.asarray(cores["jax"][key]), 1e-5)


def test_core_without_render_makes_no_render(cores):
    """render_vis=False returns no render output (and was given no
    renderer); render_vis=True adds them and the 90-degree mesh."""
    assert not {"rgb_views", "iuv_views", "front", "cropped_vis",
                "verts_rot90"} & set(cores["no_vis"])
    _report("render_vis=True verts_rot90", cores["vis"]["verts_rot90"],
            np.asarray(cores["jax"]["verts_rot90"]), 1e-5)
    for key in ("pose_rotmats_mode", "per_vertex_3Dvar", "joints_samples"):
        assert torch.equal(cores["vis"][key], cores["no_vis"][key]), key


def _jax_samples(renderer, out, i):
    """JAX's `_samples_core` (predict_pose_mf_shape_gaussian_net.py:332-365)
    on image i of a core's outputs, step for step, with its 8 samples
    shown."""
    x_axis, y_axis = jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0])
    zero_t = jnp.zeros(3)
    lights = {"location": jnp.asarray([0.0, -0.8, -2.0]),
              "ambient_color": jnp.full((3,), 0.5),
              "diffuse_color": jnp.full((3,), 0.3),
              "specular_color": jnp.zeros((3,))}
    one = {k: out[k][i:i + 1] for k in (
        "verts_samples", "joints_samples", "proxy", "cam", "verts_mode",
        "verts_rot90", "cropped_vis", "pred_cam_t", "pred_scale")}
    sorted_verts = j_sorted_sampling(one["verts_samples"][0],
                                     one["joints_samples"][0],
                                     one["proxy"][:, 1:], one["cam"])[:8]
    sorted_verts = j_rotate(sorted_verts, x_axis, np.pi, zero_t)
    rot90 = j_rotate(sorted_verts, y_axis, -np.pi / 2, zero_t)
    sample_verts = jnp.concatenate([one["verts_mode"], sorted_verts], axis=0)
    sample_verts90 = jnp.concatenate([one["verts_rot90"], rot90], axis=0)
    n = sample_verts.shape[0]
    vis = renderer(
        jnp.concatenate([sample_verts, sample_verts90], axis=0),
        cam_t=jnp.concatenate([jnp.broadcast_to(one["pred_cam_t"], (n, 3)),
                               jnp.broadcast_to(jnp.asarray([0.0, -0.2, 2.5]),
                                                (n, 3))], axis=0),
        orthographic_scale=jnp.concatenate(
            [jnp.broadcast_to(one["pred_scale"], (n, 2)),
             jnp.broadcast_to(jnp.asarray([0.95, 0.95]), (n, 2))], axis=0),
        lights_rgb_settings={k: jnp.broadcast_to(v[0:1], (2 * n, 3))
                             for k, v in lights.items()},
        verts_features=jnp.full((2 * n, 6890, 3), 0.7))
    front = j_add_background(
        jnp.broadcast_to(one["cropped_vis"], (n, 3, WH, WH)),
        jnp.transpose(vis["rgb_images"][:n], (0, 3, 1, 2)),
        jnp.round(vis["iuv_images"][:n, :, :, 0]))
    return np.asarray(front), np.asarray(vis["rgb_images"][n:])


def test_samples_render_matches(cores):
    """The samples figure's render of image 0 (mode + 4 sorted samples,
    front and turned: 10 meshes at 64^2), port vs JAX's _samples_core logic
    on the same inputs: the port core's outputs. (The cores' own outputs
    differ by float noise, up to 2.4e-6 on the sample meshes, which moved
    one pixel of 1,052 to another face.) Measured: coverage equal, max diff
    1.2e-7. Held as test_slice_renders_match holds the 6 views: 99.9% of
    pixels agree on coverage; on pixels covered by both, 99% within 5e-4
    and all within 1e-2."""
    vis = cores["vis"]
    inputs = [vis[k][0:1] for k in (
        "verts_samples", "joints_samples", "proxy", "cam", "verts_mode",
        "verts_rot90", "cropped_vis", "pred_cam_t", "pred_scale")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        ref_front, ref_rot = _jax_samples(
            cores["jrenderer"], {k: jnp.asarray(vis[k].numpy()) for k in vis}, 0)
    port_front, port_rot = samples_core(cores["trenderer"], *inputs)
    port_front, port_rot = port_front.numpy(), port_rot.numpy()
    assert port_front.shape == ref_front.shape == (N + 1, 3, WH, WH)
    assert port_rot.shape == ref_rot.shape == (N + 1, WH, WH, 3)
    pm, rm = port_rot.max(-1) > 0, ref_rot.max(-1) > 0
    agree = np.mean(pm == rm)
    print(f"samples render coverage agreement {agree}, covered {pm.sum()}")
    assert pm.sum() > 200 and agree >= 0.999
    for name, p, r, both in (("turned", port_rot, ref_rot, pm & rm),
                             ("front", port_front, ref_front, None)):
        err = np.abs(p - r)
        err = err[both] if both is not None else err
        q99 = np.quantile(err, 0.99)
        print(f"samples {name}: max abs diff {err.max():.3e}, 99th percentile "
              f"{q99:.3e}")
        assert q99 <= 5e-4 and err.max() <= 1e-2, name
