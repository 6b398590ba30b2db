"""The port's so3_log, theta2_sixth, rotmat_to_rot6d and aa_rotate_rotmats
(utils/rotation_utils.py) against the JAX package's on the CPU, float32.

so3_log: 1,000 random rotations, 100 with theta < 1e-4 (the small-angle
branch) and 100 with theta > pi - 1e-3 (the near-pi branch).
- Small angles: equal to JAX's.
- Near pi (theta > pi - 1e-3): the axis sign of a rotation by ~pi is a
  convention, so so3_exp of both outputs is compared, within 1e-5.
- The generic branch w theta / (2 sin theta), w the antisymmetric part:
  within 1e-5 rad of JAX's, plus what its conditioning allows. Near pi it
  is ill conditioned: sin theta comes from arccos of a cosine near -1, so
  an error d in that cosine moves the output by ~d theta / sin^2 theta.
  arccos and sin round differently in XLA and in torch, and
  aa_rotate_rotmats' matrices differ by up to 6e-8 between the two, so each
  output is held within 1e-5 + 4 eps theta / s^2 rad (eps float32's, s =
  sin theta above pi / 2, else 1): four ulps of the cosine
  (chip_smoke.log_map_tolerance, which phase 9e also uses). Measured on
  seeds 0-4 (1,000 rotations, and 200 rotated each way): at most 0.95 of
  that allowance beyond 1e-5. On seed 0's rotations the two are 1.1e-5
  apart at theta = 3.08; on rotated matrices 4.9e-3 apart at theta = pi -
  0.0057, where each is within 2e-5 of the float64 log map of its own
  matrix.
rotmat_to_rot6d is exact in both layouts; aa_rotate_rotmats' rotated
matrices are within 1e-6 (pre and post, one axis-angle for all or one per
matrix), its rotation vectors go through so3_log and are held by its rule.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.utils import rotation_utils as jrot

from hierarchicalprobabilistic3dhuman_torch.utils import rotation_utils as trot


def rotations_at(rng, n, lo, hi):
    """n rotation matrices (float32) about random axes by angles in [lo, hi)."""
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return Rotation.from_rotvec(axis * rng.uniform(lo, hi, (n, 1))).as_matrix(
    ).astype(np.float32)


def check_log(R, j, t, what):
    """Hold the port's log map `t` of float32 matrices R to JAX's `j` by
    the rule of the module docstring."""
    rotvecs = Rotation.from_matrix(R.astype(np.float64)).as_rotvec()
    theta = np.linalg.norm(rotvecs, axis=1)
    near_pi = theta > np.pi - 1e-3
    tol = chip_smoke.log_map_tolerance(rotvecs)
    err = np.abs(j - t).max(axis=1)
    worst = np.argmax(np.where(near_pi, 0.0, err / tol))
    print(f"{what}: {(~near_pi).sum()} rows in the generic or small-angle "
          f"branch, max diff {err[~near_pi].max():.2e} rad; the largest share "
          f"of its tolerance {err[worst] / tol[worst]:.3f} (theta "
          f"{theta[worst]:.4f}); {near_pi.sum()} rows near pi")
    assert (err[~near_pi] <= tol[~near_pi]).all()
    if near_pi.any():
        jR = np.asarray(jrot.so3_exp(jnp.asarray(j[near_pi])))
        tR = trot.so3_exp(torch.from_numpy(t[near_pi])).numpy()
        assert np.abs(jR - tR).max() <= 1e-5


def both_logs(R):
    return (np.asarray(jrot.so3_log(jnp.asarray(R))),
            trot.so3_log(torch.from_numpy(R.copy())).numpy())


@pytest.mark.parametrize("case", ["random", "small", "near_pi"])
def test_so3_log_matches_jax(case):
    rng = np.random.RandomState(0)
    if case == "random":
        R = Rotation.random(1000, random_state=rng).as_matrix().astype(np.float32)
    elif case == "small":
        R = rotations_at(rng, 100, 0.0, 1e-4)
    else:
        R = rotations_at(rng, 100, np.pi - 1e-3, np.pi)
    j, t = both_logs(R)
    if case == "small":
        np.testing.assert_array_equal(t, j)
    elif case == "near_pi":
        jR = np.asarray(jrot.so3_exp(jnp.asarray(j)))
        tR = trot.so3_exp(torch.from_numpy(t)).numpy()
        err = np.abs(jR - tR).max()
        print(f"near pi: so3_exp of the two logs within {err:.2e}")
        assert err <= 1e-5
    else:
        check_log(R, j, t, case)


def test_so3_log_round_trip_and_identity():
    rng = np.random.RandomState(3)
    v = rng.randn(64, 3).astype(np.float32)
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    v = (v / norms * np.clip(norms, 0.0, 3.0)).astype(np.float32)
    back = trot.so3_log(trot.so3_exp(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(back, v, atol=1e-3)
    assert trot.so3_log(torch.eye(3)[None]).abs().max() == 0.0
    theta = np.float32(0.3)
    assert (trot.theta2_sixth(torch.tensor(theta)).item()
            == float(jrot.theta2_sixth(jnp.float32(theta))))


@pytest.mark.parametrize("stack_columns", [False, True])
def test_rotmat_to_rot6d_exact(stack_columns):
    R = Rotation.random(32, random_state=np.random.RandomState(1)).as_matrix(
    ).astype(np.float32).reshape(4, 8, 3, 3)
    j = np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(R), stack_columns))
    t = trot.rotmat_to_rot6d(torch.from_numpy(R), stack_columns).numpy()
    assert t.shape == (4, 8, 6)
    np.testing.assert_array_equal(t, j)
    if not stack_columns:
        back = trot.rot6d_to_rotmat(torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(back, R, atol=1e-5)


@pytest.mark.parametrize("order", ["pre", "post"])
@pytest.mark.parametrize("per_example", [False, True])
def test_aa_rotate_rotmats_matches_jax(order, per_example):
    rng = np.random.RandomState(2)
    R = Rotation.random(50, random_state=rng).as_matrix().astype(np.float32)
    if per_example:
        axes = rng.randn(50, 3).astype(np.float32)
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        angles = rng.uniform(-np.pi, np.pi, (50, 1)).astype(np.float32)
        jargs, targs = (jnp.asarray(axes), jnp.asarray(angles)), (
            torch.from_numpy(axes), torch.from_numpy(angles))
    else:
        jargs = targs = ((1.0, 0.0, 0.0), np.float32(np.pi / 3))
    jvec, jmat = jrot.aa_rotate_rotmats(jnp.asarray(R), *jargs, rot_mult_order=order)
    tvec, tmat = trot.aa_rotate_rotmats(torch.from_numpy(R), *targs,
                                        rot_mult_order=order)
    mat_err = np.abs(np.asarray(jmat) - tmat.numpy()).max()
    print(f"{order}, per example {per_example}: rotmats within {mat_err:.2e}")
    assert mat_err <= 1e-6
    check_log(tmat.numpy(), np.asarray(jvec), tvec.numpy(), "rotvecs")
    with pytest.raises(ValueError):
        trot.aa_rotate_rotmats(torch.from_numpy(R), *targs, rot_mult_order="left")
