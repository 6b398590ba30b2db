"""Port vs JAX package: configs, rotations, resampling/crops, heatmaps,
Canny, the Jacobi SVD, matrix-Fisher sampling, uncertainty and SMPL.

Inputs are made from a seed with numpy and fed to both; the sampler gets
JAX's own random draws, rebuilt from its key splitting. Tolerances are
stated per test; float32 throughout, on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu import configs as jcfg
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.ops import bingham_sampling as jbs
from hierarchicalprobabilistic3dhuman_tpu.ops.resample import (
    affine_resample as j_affine_resample)
from hierarchicalprobabilistic3dhuman_tpu.ops.svd3 import (
    proper_svd3x3 as j_proper_svd3x3)
from hierarchicalprobabilistic3dhuman_tpu.utils import image_utils as jimg
from hierarchicalprobabilistic3dhuman_tpu.utils import rotation_utils as jrot
from hierarchicalprobabilistic3dhuman_tpu.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps_batched as j_heatmaps)
from hierarchicalprobabilistic3dhuman_tpu.utils.sampling_utils import (
    compute_vertex_uncertainties_by_sampling as j_uncertainty)

from hierarchicalprobabilistic3dhuman_torch import configs as tcfg
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import (
    SMPL as TSMPL, SMPLParams)
from hierarchicalprobabilistic3dhuman_torch.ops import bingham_sampling as tbs
from hierarchicalprobabilistic3dhuman_torch.ops.resample import (
    affine_resample as t_affine_resample)
from hierarchicalprobabilistic3dhuman_torch.ops.svd3 import (
    proper_svd3x3 as t_proper_svd3x3)
from hierarchicalprobabilistic3dhuman_torch.utils import image_utils as timg
from hierarchicalprobabilistic3dhuman_torch.utils import rotation_utils as trot
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps_batched as t_heatmaps)
from hierarchicalprobabilistic3dhuman_torch.utils.sampling_utils import (
    compute_vertex_uncertainties_by_sampling as t_uncertainty)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(port, ref, atol, err_msg=""):
    port, ref = np.asarray(port), np.asarray(ref)
    print(f"{err_msg} max abs diff {np.abs(port - ref).max():.3e} (tol {atol})")
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module")
def smpl_pair():
    jsmpl = JSMPL.synthetic()
    return jsmpl, TSMPL.synthetic(device="cpu")


def test_config_defaults_match():
    """The JAX package's defaults, and the port's own key MODEL.ENCODER
    (the ResNet by default), which the JAX package has no encoder for."""
    port = tcfg.get_pose_shape_cfg_defaults()
    assert port.MODEL.pop("ENCODER") == "resnet"
    assert port == jcfg.get_pose_shape_cfg_defaults()
    assert tcfg.get_pose2d_hrnet_cfg_defaults() == jcfg.get_pose2d_hrnet_cfg_defaults()


@pytest.mark.parametrize("name,shape", [
    ("rot6d_to_rotmat", (7, 4, 6)),
    ("quat_to_rotmat", (7, 4, 4)),
    ("so3_exp", (7, 4, 3)),
    ("batch_rodrigues", (5, 3)),
])
def test_rotations_match(name, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    if name == "so3_exp":
        x[0] *= 1e-5            # the Taylor branch
    _close(getattr(trot, name)(_t(x)), getattr(jrot, name)(jnp.asarray(x)),
           1e-5)


def test_aa_rotate_translate_points_match():
    pts = np.random.RandomState(1).randn(3, 50, 3).astype(np.float32)
    for axis, angle in (([1.0, 0.0, 0.0], np.pi), ([0.0, 1.0, 0.0], -np.pi / 2)):
        _close(trot.aa_rotate_translate_points(_t(pts), axis, angle, [0.1, 0, 0]),
               jrot.aa_rotate_translate_points(jnp.asarray(pts),
                                               jnp.asarray(axis), angle,
                                               jnp.asarray([0.1, 0, 0])),
               1e-5)


def test_affine_resample_matches_both_jax_paths():
    """Separable matmul path and the per-pixel gather path (which the JAX
    core takes under jit for the front composite) agree with the port."""
    rng = np.random.RandomState(2)
    img = rng.rand(2, 3, 40, 30).astype(np.float32)
    aff = np.array([[[1.7, 0, -3.2], [0, 1.3, 2.5]],
                    [[0.6, 0, 4.0], [0, 0.8, -1.0]]], np.float32)
    port = t_affine_resample(_t(img), _t(aff), (50, 45))
    for force_gather in (False, True):
        ref = j_affine_resample(jnp.asarray(img), jnp.asarray(aff), (50, 45),
                                force_gather=force_gather)
        _close(port, ref, 1e-5, err_msg=f"force_gather={force_gather}")


@pytest.mark.parametrize("in_hw,out_wh,scale,atol", [
    # HRNet input crop. XLA contracts the affine's tx = w/2 - a00 * cx into
    # an FMA (affine entries differ by 7.6e-6); at source coordinates ~500,
    # where one float32 ulp is 6.1e-5, that moves the tent weights: measured
    # max 8.9e-5.
    ((512, 512), (288, 384), 1.2, 1e-4),
    ((384, 288), (256, 256), 1.0, 1e-5),  # proxy crop: measured 0.0
])
def test_batch_crop_affine_matches(in_hw, out_wh, scale, atol):
    rng = np.random.RandomState(3)
    img = rng.rand(1, 3, *in_hw).astype(np.float32)
    j2d = (rng.rand(1, 17, 2) * in_hw[::-1]).astype(np.float32)
    centre = np.array([[in_hw[0] / 2, in_hw[1] / 2]], np.float32)
    h = np.array([in_hw[0]], np.float32)
    w = np.array([in_hw[1] * 1.1], np.float32)
    port = timg.batch_crop_affine(out_wh, _t(centre), _t(h), _t(w), rgb=_t(img),
                                  joints2D=_t(j2d), orig_scale_factor=scale)
    ref = jimg.batch_crop_affine(out_wh, joints2D=jnp.asarray(j2d),
                                 rgb=jnp.asarray(img), bbox_centres=centre,
                                 bbox_heights=h, bbox_widths=w,
                                 orig_scale_factor=scale)
    _close(port["rgb"], ref["rgb"], atol)
    _close(port["joints2D"], ref["joints2D"], 1e-4)   # pixel coords ~500
    _close(port["affine_trans"], ref["affine_trans"], 1e-5)


def test_add_rgb_background_matches():
    rng = np.random.RandomState(4)
    bg, rgb = rng.rand(2, 2, 3, 16, 16).astype(np.float32)
    seg = rng.randint(0, 3, (2, 16, 16)).astype(np.float32)
    _close(timg.batch_add_rgb_background(_t(bg), _t(rgb), _t(seg)),
           jimg.batch_add_rgb_background(jnp.asarray(bg), jnp.asarray(rgb),
                                         jnp.asarray(seg)), 0)


def test_gaussian_heatmaps_match():
    j2d = (np.random.RandomState(5).rand(2, 17, 2) * 64).astype(np.float32)
    _close(t_heatmaps(_t(j2d), 64, std=4.0), j_heatmaps(jnp.asarray(j2d), 64, 4.0),
           1e-5)


def test_canny_matches():
    """Magnitude to 1e-5. Thin edges by agreement share: a float difference
    at a 45-degree bin edge flips an NMS decision (measured agreement on this
    input: 1.0)."""
    img = np.random.RandomState(6).rand(2, 3, 64, 64).astype(np.float32)
    port = TCanny(device="cpu", threshold=0.0)(_t(img))
    ref = JCanny(threshold=0.0)(jnp.asarray(img))
    _close(port["grad_magnitude"], ref["grad_magnitude"], 1e-5)
    p_thin = port["thresholded_thin_edges"].numpy()
    r_thin = np.asarray(ref["thresholded_thin_edges"])
    agree = np.mean(np.isclose(p_thin, r_thin, rtol=0, atol=1e-5))
    print(f"thin-edge agreement {agree}")
    assert agree >= 0.995, agree


def test_proper_svd3x3_matches_jacobi_including_signs():
    rng = np.random.RandomState(7)
    F = rng.randn(300, 3, 3).astype(np.float32)
    F[:100] += np.eye(3, dtype=np.float32)          # delta-I-like inputs
    port = t_proper_svd3x3(_t(F))
    ref = j_proper_svd3x3(jnp.asarray(F))
    for k in ("U", "S", "V", "U_proper", "S_proper", "V_proper", "mode"):
        _close(port[k], ref[k], 1e-5, err_msg=k)


def _jax_sampler_draws(key, B, J, N, K=8):
    """eps and w exactly as bingham_sampling draws them from `key`."""
    key_eps, key_w = jax.random.split(key)
    eps = jax.random.normal(key_eps, (B, J, N * K, 4), dtype=jnp.float32)
    w = jax.random.uniform(key_w, (B, J, N * K), dtype=jnp.float32)
    return _t(eps), _t(w)


def _random_svd_inputs(rng, B):
    F = rng.randn(B, 23, 3, 3).astype(np.float32) * 3 + np.eye(3, dtype=np.float32)
    svd = j_proper_svd3x3(jnp.asarray(F))
    return [np.asarray(svd[k]) for k in ("U", "S", "V")]


def test_pose_matrix_fisher_sampling_matches_given_jax_draws():
    U, S, V = _random_svd_inputs(np.random.RandomState(8), 2)
    key = jax.random.PRNGKey(3)
    ref = jbs.pose_matrix_fisher_sampling(key, jnp.asarray(U), jnp.asarray(S),
                                          jnp.asarray(V), 6)
    eps, w = _jax_sampler_draws(key, 2, 23, 6)
    port = tbs.pose_matrix_fisher_sampling(_t(U), _t(S), _t(V), 6, eps=eps, w=w)
    _close(port, ref, 1e-5)


def test_vertex_uncertainty_matches_given_jax_draws(smpl_pair):
    jsmpl, tsmpl = smpl_pair
    rng = np.random.RandomState(9)
    U, S, V = _random_svd_inputs(rng, 1)
    shape_mean = rng.randn(1, 10).astype(np.float32)
    glob = np.asarray(jrot.so3_exp(jnp.asarray(rng.randn(1, 3) * 0.3,
                                               jnp.float32)))
    key = jax.random.PRNGKey(11)
    ref = j_uncertainty(key, jnp.asarray(U), jnp.asarray(S), jnp.asarray(V),
                        jnp.asarray(shape_mean), jnp.ones((1, 10)),
                        jnp.asarray(glob), 4, jsmpl, use_mean_shape=True)
    key_pose, _ = jax.random.split(key)
    eps, w = _jax_sampler_draws(key_pose, 1, 23, 4)
    port = t_uncertainty(_t(U), _t(S), _t(V), _t(shape_mean), _t(glob), 4, tsmpl,
                         eps=eps, w=w)
    _close(port[0], ref[0], 1e-5, err_msg="per-vertex uncertainty")
    _close(port[1], ref[1], 1e-5, err_msg="vertex samples")
    _close(port[2], ref[2], 1e-5, err_msg="joint samples")


def test_synthetic_smpl_is_the_same_model(smpl_pair):
    jsmpl, tsmpl = smpl_pair
    for name in SMPLParams.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tsmpl.params, name).numpy(),
                                      np.asarray(getattr(jsmpl.params, name)),
                                      err_msg=name)


@pytest.mark.parametrize("pose2rot", [True, False])
def test_smpl_forward_matches(smpl_pair, pose2rot):
    jsmpl, tsmpl = smpl_pair
    rng = np.random.RandomState(10)
    betas = rng.randn(3, 10).astype(np.float32)
    aa = (rng.randn(3, 24, 3) * 0.4).astype(np.float32)
    if pose2rot:
        body, glob = aa[:, 1:].reshape(3, 69), aa[:, 0]
    else:
        R = np.asarray(jrot.so3_exp(jnp.asarray(aa)))
        body, glob = R[:, 1:], R[:, :1]
    port = tsmpl(betas=_t(betas), body_pose=_t(body), global_orient=_t(glob),
                 pose2rot=pose2rot)
    ref = jsmpl(betas=jnp.asarray(betas), body_pose=jnp.asarray(body),
                global_orient=jnp.asarray(glob), pose2rot=pose2rot)
    for k in ("vertices", "joints"):
        assert port[k].shape == ref[k].shape
        _close(port[k], ref[k], 1e-5, err_msg=k)
    # The T-pose call of the predict path: betas only.
    _close(tsmpl(betas=_t(betas))["vertices"],
           jsmpl(betas=jnp.asarray(betas))["vertices"], 1e-5)


def test_smpl_from_npz_files(tmp_path, smpl_pair):
    """The native-field npz layout loads into the same model; a missing file
    raises FileNotFoundError (the CLI then uses the synthetic model)."""
    _, tsmpl = smpl_pair
    p = {k: v.numpy() for k, v in vars(tsmpl.params).items()}
    V = p["v_template"].shape[0]
    np.savez(tmp_path / "SMPL_NEUTRAL.npz", v_template=p["v_template"],
             shapedirs=p["shapedirs"], posedirs=p["posedirs"].T.reshape(V, 3, 207),
             J_regressor=p["J_regressor"], weights=p["lbs_weights"], f=p["faces"])
    loaded = TSMPL.from_files(device="cpu", model_path=str(tmp_path))
    for name, value in p.items():
        np.testing.assert_array_equal(getattr(loaded.params, name).numpy(), value,
                                      err_msg=name)
    with pytest.raises(FileNotFoundError):
        TSMPL.from_files(device="cpu", gender="female", model_path=str(tmp_path))
