"""The port's LAPACK-sign 3x3 SVD and the predictor head's svd_impl switch
vs the JAX package.

ops/lapack_svd3.py::svd3x3_gesdd against the JAX function of the same name
on the bars of tests/test_lapack_svd3.py: 2,000 F + I matrices (the head's
operating regime) and random matrices at scales 1, 20 and 0.05. Tolerances:
S within 1e-5 max|F|; U and V within 1e-5 on >= 0.99 of the matrices (the
rest are column-sign flips at floating-point branch boundaries: XLA on the
CPU may contract a*b + c into an FMA, eager torch does not; their count is
printed); against np.linalg.svd (the sgesdd both emulate), signs included,
>= 0.95. The host oracle (proper_svd3x3_lapack) equals JAX's exactly: both
call numpy. The head with svd_impl="lapack": F, S and the mode within 1e-4
on >= 0.98 of the (batch, joint) lanes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.ops.lapack_svd3 import (
    svd3x3_gesdd as j_gesdd)
from hierarchicalprobabilistic3dhuman_tpu.ops.svd3 import (
    proper_svd3x3_gesdd as j_proper_gesdd,
    proper_svd3x3_lapack as j_proper_lapack)

from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import (
    svd3x3_gesdd as t_gesdd)
from hierarchicalprobabilistic3dhuman_torch.ops.svd3 import (
    proper_svd3x3_gesdd as t_proper_gesdd,
    proper_svd3x3_lapack as t_proper_lapack)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D = 64


def _both(Fs):
    ref = [np.asarray(a) for a in jax.jit(j_gesdd)(jnp.asarray(Fs))]
    t_gesdd.iterations = 0
    port = [a.numpy() for a in t_gesdd(torch.from_numpy(Fs))]
    return port, ref


def _vs_numpy(U, S, V, Fs):
    U_np, S_np, Vh_np = np.linalg.svd(Fs)
    return ((np.abs(U - U_np).max(axis=(1, 2)) < 1e-3)
            & (np.abs(V - np.swapaxes(Vh_np, 1, 2)).max(axis=(1, 2)) < 1e-3))


def _hold(name, Fs):
    (U, S, V), (Uj, Sj, Vj) = _both(Fs)
    s_err = np.abs(S - Sj).max() / np.abs(Fs).max()
    same = ((np.abs(U - Uj).max(axis=(1, 2)) <= 1e-5)
            & (np.abs(V - Vj).max(axis=(1, 2)) <= 1e-5))
    flips = int((~same).sum())
    np_share = _vs_numpy(U, S, V, Fs).mean()
    print(f"{name}: S max diff {s_err:.2e} x max|F| (tol 1e-5); U, V within "
          f"1e-5 of JAX on {same.mean():.4f} of {len(Fs)} (tol 0.99), {flips} "
          f"sign flips; signs equal numpy's on {np_share:.4f} (tol 0.95); "
          f"{t_gesdd.iterations} loop iterations")
    assert s_err <= 1e-5
    assert same.mean() >= 0.99
    assert np_share >= 0.95
    # Every matrix where the signs differ from JAX's is the same
    # decomposition with columns flipped.
    for i in np.flatnonzero(~same):
        flip = np.sign(np.sum(U[i] * Uj[i], axis=0))
        np.testing.assert_allclose(U[i] * flip, Uj[i], atol=1e-4)
        np.testing.assert_allclose(V[i] * flip, Vj[i], atol=1e-4)


def test_gesdd_matches_jax_on_the_head_regime():
    rng = np.random.RandomState(5)
    _hold("F + I", (rng.randn(2000, 3, 3) * 0.5 + np.eye(3)).astype(np.float32))


@pytest.mark.parametrize("scale", [1.0, 20.0, 0.05])
def test_gesdd_matches_jax_across_scales(scale):
    rng = np.random.RandomState(int(scale * 100))
    _hold(f"randn x {scale}", (rng.randn(2000, 3, 3) * scale).astype(np.float32))


def test_gesdd_degenerate_inputs_valid_and_equal_to_jax():
    """Zero, identity, rank 1 and 2, repeated singular values, a negative
    diagonal: finite orthogonal factors, S >= 0 descending, exact
    reconstruction, and the same numbers as JAX."""
    rng = np.random.RandomState(17)
    Q = np.linalg.qr(rng.randn(3, 3))[0]
    mats = [np.zeros((3, 3)), np.eye(3), np.diag([3.0, 0.0, -1.0]),
            np.diag([0.0, 0.0, 2.0]), rng.randn(3, 1) @ rng.randn(1, 3),
            rng.randn(3, 2) @ rng.randn(2, 3), 2.0 * Q,
            Q @ np.diag([2.0, 2.0, 0.5]) @ Q.T]
    Fs = np.stack(mats).astype(np.float32)
    (U, S, V), (Uj, Sj, Vj) = _both(Fs)
    assert np.isfinite(U).all() and np.isfinite(S).all() and np.isfinite(V).all()
    assert (S >= 0).all() and (np.diff(S, axis=-1) <= 1e-6).all()
    eye = np.eye(3)
    for i in range(len(Fs)):
        np.testing.assert_allclose(U[i] @ U[i].T, eye, atol=1e-5)
        np.testing.assert_allclose(V[i] @ V[i].T, eye, atol=1e-5)
        np.testing.assert_allclose((U[i] * S[i]) @ V[i].T, Fs[i], atol=1e-5)
    for name, a, b in (("U", U, Uj), ("S", S, Sj), ("V", V, Vj)):
        print(f"degenerate {name}: max abs diff from JAX {np.abs(a - b).max():.2e}")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)


def test_gesdd_keeps_leading_dims():
    F = np.random.RandomState(3).randn(2, 5, 3, 3).astype(np.float32)
    U, S, V = t_gesdd(torch.from_numpy(F))
    assert U.shape == (2, 5, 3, 3) and S.shape == (2, 5, 3) and V.shape == U.shape
    Uf, Sf, Vf = t_gesdd(torch.from_numpy(F.reshape(10, 3, 3)))
    assert torch.equal(U.reshape(10, 3, 3), Uf) and torch.equal(S.reshape(10, 3), Sf)


def test_proper_modes_match_jax():
    """The host oracle is numpy's sgesdd on both sides: difference 0. The
    device mode: rotations, and JAX's numbers on >= 0.99 of the matrices."""
    F = (np.random.RandomState(8).randn(400, 3, 3) * 0.6
         + np.eye(3)).astype(np.float32)
    port = t_proper_lapack(torch.from_numpy(F))
    ref = j_proper_lapack(jnp.asarray(F))
    for k in ref:
        diff = np.abs(port[k].numpy() - np.asarray(ref[k])).max()
        print(f"proper_svd3x3_lapack {k}: max abs diff {diff:.2e} (tol 0)")
        assert diff == 0, k
    port = t_proper_gesdd(torch.from_numpy(F))
    ref = j_proper_gesdd(jnp.asarray(F))
    np.testing.assert_allclose(np.linalg.det(port["mode"].numpy()), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(port["U_proper"].numpy()), 1.0,
                               atol=1e-5)
    same = np.abs(port["mode"].numpy() - np.asarray(ref["mode"])).max(axis=(1, 2)) <= 1e-5
    print(f"proper_svd3x3_gesdd mode within 1e-5 of JAX on {same.mean():.4f}")
    assert same.mean() >= 0.99


@pytest.mark.parametrize("svd_impl", ["lapack", "lapack_callback"])
def test_head_with_lapack_svd_matches_jax(svd_impl):
    """The whole predictor (embed 64, 64^2 proxy, batch 4) with the
    LAPACK-sign SVD at every kinematic depth: an ancestor's sign flip moves
    its descendants, so the bar is per (batch, joint) lane."""
    jmodel = JPredictor(embed_dim=64, svd_impl=svd_impl)
    variables = jax.jit(JPredictor(embed_dim=64).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 18, D, D)))
    tmodel = TPredictor(embed_dim=64, svd_impl=svd_impl).eval()
    tmodel.load_state_dict(flax_to_torch_predictor(
        jax.tree_util.tree_map(np.asarray, variables), tmodel))
    x = np.random.RandomState(6).rand(4, 18, D, D).astype(np.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        port = tmodel(torch.from_numpy(x))
    for k, shape in (("pose_params_F", (3, 3)), ("pose_params_S", (3,)),
                     ("pose_rotmats_mode", (3, 3))):
        err = np.abs(port[k].numpy() - np.asarray(ref[k]))
        lanes = err.reshape(err.shape[:2] + (-1,)).max(-1)
        share = (lanes <= 1e-4).mean()
        print(f"{svd_impl} head {k}: within 1e-4 on {share:.4f} of "
              f"{lanes.size} lanes (tol 0.98), max {err.max():.2e}")
        assert port[k].shape[2:] == shape and share >= 0.98, k
    for k in ("shape_mean", "shape_log_std", "cam", "glob"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_head_rejects_unknown_svd_impl():
    with pytest.raises(ValueError, match="svd_impl"):
        TPredictor(embed_dim=64, svd_impl="qr")
