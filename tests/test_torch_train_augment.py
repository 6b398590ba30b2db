"""The port's training augmentations, crop and label conversions vs the JAX
package, each handed JAX's own draws (tests/jax_draws.py rebuilds them from
the JAX function's key tree), on the CPU.

Every case compares every output: integer, boolean and label outputs
equal, float outputs within 1e-5 of their largest magnitude (1e-5 absolute
below 1). The proxy-representation probabilities are raised to 0.5 so that
every branch is taken in a batch of 8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.utils import image_utils as jimg
from hierarchicalprobabilistic3dhuman_tpu.utils import label_conversions as jlc
from hierarchicalprobabilistic3dhuman_tpu.utils.augmentation import (
    cam_augmentation as jca, lighting_augmentation as jla,
    proxy_rep_augmentation as jpa, rgb_augmentation as jra,
    smpl_augmentation as jsa)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.utils import image_utils as timg
from hierarchicalprobabilistic3dhuman_torch.utils import label_conversions as tlc
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation import (
    cam_augmentation as tca, lighting_augmentation as tla,
    proxy_rep_augmentation as tpa, rgb_augmentation as tra,
    smpl_augmentation as tsa)
from jax_draws import JaxDraws

torch.set_num_threads(2)

B, D = 8, 48
KEY = jax.random.PRNGKey(11)


def _inputs():
    rng = np.random.RandomState(4)
    seg = rng.randint(0, 25, (B, D, D)).astype(np.float32)
    seg[:, :6] = 0.0
    seg[0] = 0.0                                    # an empty mask
    iuv = np.concatenate([seg[:, None], np.round(rng.rand(B, 2, D, D) * 255)],
                         axis=1).astype(np.float32)
    return {
        "seg": seg, "iuv": iuv,
        "rgb": rng.rand(B, 3, D, D).astype(np.float32),
        "bg": rng.rand(B, 3, D, D).astype(np.float32),
        "j2d": (rng.rand(B, 17, 2) * D).astype(np.float32),
        "vis": rng.rand(B, 17) > 0.2,
        "cam": np.tile(np.float32([0.0, -0.2, 2.5]), (B, 1)),
    }


def _proxy_cfg(cfg):
    c = cfg.TRAIN.SYNTH_DATA.AUGMENT.PROXY_REP
    c.REMOVE_PARTS_PROBS = [0.5] * 24
    for k in ("JOINTS_SWAP_PROB", "OCCLUDE_BOX_PROB", "OCCLUDE_BOTTOM_PROB",
              "OCCLUDE_TOP_PROB", "OCCLUDE_VERTICAL_PROB", "REMOVE_JOINTS_PROB",
              "EXTREME_CROP_PROB"):
        setattr(c, k, 0.5)
    c.OCCLUDE_BOX_DIM = 16
    r = cfg.TRAIN.SYNTH_DATA.AUGMENT.RGB
    for k in ("OCCLUDE_BOTTOM_PROB", "OCCLUDE_TOP_PROB", "OCCLUDE_VERTICAL_PROB"):
        setattr(r, k, 0.5)
    return cfg


JCFG, TCFG = _proxy_cfg(j_cfg()), _proxy_cfg(t_cfg())
JAUG, TAUG = JCFG.TRAIN.SYNTH_DATA.AUGMENT, TCFG.TRAIN.SYNTH_DATA.AUGMENT


def _crop_args(x, j, t):
    """batch_crop_affine's training call, as make_synth_data_fn makes it."""
    return dict(rgb=t(x["rgb"]), iuv=t(x["iuv"]), joints2D=t(x["j2d"]),
                bbox_determiner=t(x["seg"]), orig_scale_factor=1.2,
                delta_scale_range=(-0.3, 0.2), delta_centre_range=(-5, 5),
                out_of_frame_pad_val=-1.0)


# name -> (jax call, port call), each (key or draws, inputs, to-array) -> outputs
CASES = {
    "normal_sample_shape": (
        lambda k, x, a: jsa.normal_sample_shape(k, B, jnp.zeros(10), jnp.full(10, 1.25)),
        lambda d, x, a: tsa.normal_sample_shape(d, B, torch.zeros(10), torch.full((10,), 1.25))),
    "uniform_sample_shape": (
        lambda k, x, a: jsa.uniform_sample_shape(k, B, jnp.zeros(10), (-2, 3)),
        lambda d, x, a: tsa.uniform_sample_shape(d, B, torch.zeros(10), (-2, 3))),
    "uniform_random_unit_vector": (
        lambda k, x, a: jsa.uniform_random_unit_vector(k, B),
        lambda d, x, a: tsa.uniform_random_unit_vector(d, B)),
    "augment_cam_t": (
        lambda k, x, a: jca.augment_cam_t(k, a(x["cam"]), 0.05, (-0.5, 0.5)),
        lambda d, x, a: tca.augment_cam_t(d, a(x["cam"]), 0.05, (-0.5, 0.5))),
    "augment_light": (
        lambda k, x, a: jla.augment_light(k, B, JAUG.RGB),
        lambda d, x, a: tla.augment_light(d, B, TAUG.RGB)),
    "random_joints2D_deviation": (
        lambda k, x, a: jpa.random_joints2D_deviation(k, a(x["j2d"]), (-6, 6), (-15, 15)),
        lambda d, x, a: tpa.random_joints2D_deviation(d, a(x["j2d"]), (-6, 6), (-15, 15))),
    "random_remove_bodyparts": (
        lambda k, x, a: jpa.random_remove_bodyparts(
            k, a(x["seg"]), list(range(1, 25)), [0.5] * 24, a(x["vis"]), 0.5),
        lambda d, x, a: tpa.random_remove_bodyparts(
            d, a(x["seg"]), list(range(1, 25)), [0.5] * 24, a(x["vis"]), 0.5)),
    "random_remove_joints2D": (
        lambda k, x, a: jpa.random_remove_joints2D(k, a(x["vis"]), [7, 8, 9, 10], 0.5),
        lambda d, x, a: tpa.random_remove_joints2D(d, a(x["vis"]), [7, 8, 9, 10], 0.5)),
    "random_swap_joints2D": (
        lambda k, x, a: jpa.random_swap_joints2D(k, a(x["j2d"]), [[5, 6], [11, 12]], 0.5),
        lambda d, x, a: tpa.random_swap_joints2D(d, a(x["j2d"]), [[5, 6], [11, 12]], 0.5)),
    "random_occlude_box": (
        lambda k, x, a: jpa.random_occlude_box(k, a(x["seg"]), 0.5, 16.0),
        lambda d, x, a: tpa.random_occlude_box(d, a(x["seg"]), 0.5, 16.0)),
    **{f"random_occlude_{half}_half_{kind}": (
        (lambda half, kind: lambda k, x, a: getattr(jpa, f"random_occlude_{half}_half")(
            k, a(x[kind]), a(x["j2d"]), a(x["vis"]), 0.5))(half, kind),
        (lambda half, kind: lambda d, x, a: getattr(tpa, f"random_occlude_{half}_half")(
            d, a(x[kind]), a(x["j2d"]), a(x["vis"]), 0.5))(half, kind))
       for half in ("bottom", "top", "vertical") for kind in ("seg", "rgb")},
    "augment_proxy_representation": (
        lambda k, x, a: jpa.augment_proxy_representation(
            k, a(x["seg"]), a(x["j2d"]), a(x["vis"]), JAUG.PROXY_REP),
        lambda d, x, a: tpa.augment_proxy_representation(
            d, a(x["seg"]), a(x["j2d"]), a(x["vis"]), TAUG.PROXY_REP)),
    "random_extreme_crop": (
        lambda k, x, a: jpa.random_extreme_crop(k, a(x["seg"]), 0.5),
        lambda d, x, a: tpa.random_extreme_crop(d, a(x["seg"]), 0.5)),
    "random_pixel_noise_per_channel": (
        lambda k, x, a: jra.random_pixel_noise_per_channel(k, a(x["rgb"]), 0.2),
        lambda d, x, a: tra.random_pixel_noise_per_channel(d, a(x["rgb"]), 0.2)),
    "random_gaussian_blur": (
        lambda k, x, a: jra.random_gaussian_blur(k, a(x["rgb"])),
        lambda d, x, a: tra.random_gaussian_blur(d, a(x["rgb"]))),
    "augment_rgb": (
        lambda k, x, a: jra.augment_rgb(k, a(x["rgb"]), a(x["j2d"]), a(x["vis"]), JAUG.RGB),
        lambda d, x, a: tra.augment_rgb(d, a(x["rgb"]), a(x["j2d"]), a(x["vis"]), TAUG.RGB)),
    "batch_crop_affine_train": (
        lambda k, x, a: jimg.batch_crop_affine((D, D), rng_key=k, **_crop_args(x, jnp, a)),
        lambda d, x, a: timg.batch_crop_affine((D, D), draws=d, **_crop_args(x, torch, a))),
    "batch_crop_affine_from_joints_with_seg": (
        lambda k, x, a: jimg.batch_crop_affine(
            (D, D), joints2D=a(x["j2d"]), joints2D_vis=a(x["vis"]), seg=a(x["seg"]),
            bbox_centres=None, rng_key=k, delta_centre_range=(-3, 3)),
        lambda d, x, a: timg.batch_crop_affine(
            (D, D), joints2D=a(x["j2d"]), joints2D_vis=a(x["vis"]), seg=a(x["seg"]),
            draws=d, delta_centre_range=(-3, 3))),
}


def _flat(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [y for o in out for y in _flat(o)]
    return [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_augmentation_matches_jax(name):
    jfn, tfn = CASES[name]
    x = _inputs()
    ref = _flat(jfn(KEY, x, jnp.asarray))
    port = _flat(tfn(JaxDraws(KEY), x, torch.from_numpy))
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        r, p = np.asarray(r), p.numpy()
        assert r.shape == p.shape, (r.shape, p.shape)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            assert np.array_equal(r, p)
        else:
            err = np.abs(r.astype(np.float64) - p).max() / max(np.abs(r).max(), 1.0)
            assert err <= 1e-5, err
    print(f"{name}: {len(ref)} outputs equal")


def test_bbox_from_mask_and_joints_match_jax():
    x = _inputs()
    np.testing.assert_array_equal(
        timg.bbox_from_mask(torch.from_numpy(x["seg"])).numpy(),
        np.asarray(jimg.bbox_from_mask(jnp.asarray(x["seg"]))))
    vis = x["vis"].copy()
    vis[1] = False
    vis[1, 4] = True                               # one visible joint
    np.testing.assert_array_equal(
        timg.bbox_from_joints2d(torch.from_numpy(x["j2d"]), torch.from_numpy(vis),
                                (D, D)).numpy(),
        np.asarray(jimg.bbox_from_joints2d(jnp.asarray(x["j2d"]), jnp.asarray(vis),
                                           (D, D))))


def test_label_conversions_match_jax():
    x = _inputs()
    seg = x["iuv"][:, 0].copy()
    seg[:, :3] = -1.0                              # the crop's out-of-frame pad
    for a in (seg, seg.astype(np.int64)):
        np.testing.assert_array_equal(
            tlc.convert_densepose_seg_to_14part_labels(torch.from_numpy(a)).numpy(),
            np.asarray(jlc.convert_densepose_seg_to_14part_labels(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tlc.convert_multiclass_to_binary_labels(torch.from_numpy(seg)).numpy(),
        np.asarray(jlc.convert_multiclass_to_binary_labels(jnp.asarray(seg))))
    assert tlc.TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP == jlc.TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP
