"""The port's matrix-Fisher math and training loss vs the JAX package.

- log_mf_norm_constant, value and gradient (the port's
  torch.autograd.Function against JAX's custom_vjp), on proper singular
  values up to scale 50 with s2 of both signs: value within 1e-5 relative,
  gradient within 1e-5 of its largest entry; and torch's gradcheck of the
  Function in float64 (the quadrature's own derivative integrals against
  finite differences of the quadrature);
- matrix_fisher_nll on random F: 1e-5 relative;
- both loss stages' PoseMFShapeGaussianLoss, total and terms, with an
  invisible joint whose target is inf: 1e-5 relative; and the loss's
  gradient stays finite there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.losses import (
    PoseMFShapeGaussianLoss as JLoss)
from hierarchicalprobabilistic3dhuman_tpu.ops import matrix_fisher as jmf
from hierarchicalprobabilistic3dhuman_tpu.ops.svd3 import proper_svd3x3 as j_svd

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.losses import (
    PoseMFShapeGaussianLoss as TLoss)
from hierarchicalprobabilistic3dhuman_torch.ops import matrix_fisher as tmf

torch.set_num_threads(2)


def proper_singular_values(rng, n, scale):
    """(n, 3) s0 >= s1 >= |s2|, s2 of random sign."""
    s = np.sort(np.abs(rng.randn(n, 3)) * scale, axis=-1)[:, ::-1].copy()
    s[:, 2] *= rng.choice([-1.0, 1.0], n)
    return s.astype(np.float32)


@pytest.mark.parametrize("scale", [0.1, 2.0, 10.0, 50.0])
def test_log_mf_norm_constant_matches_jax(scale):
    S = proper_singular_values(np.random.RandomState(int(scale * 10)), 64, scale)
    g = np.random.RandomState(1).randn(64).astype(np.float32)
    j_val, j_vjp = jax.vjp(jmf.log_mf_norm_constant, jnp.asarray(S))
    (j_grad,) = j_vjp(jnp.asarray(g))
    tS = torch.tensor(S, requires_grad=True)
    t_val = tmf.log_mf_norm_constant(tS)
    t_val.backward(torch.from_numpy(g))
    j_val, j_grad = np.asarray(j_val), np.asarray(j_grad)
    val_err = np.max(np.abs(t_val.detach().numpy() - j_val) / np.maximum(np.abs(j_val), 1.0))
    grad_err = np.abs(tS.grad.numpy() - j_grad).max() / np.abs(j_grad).max()
    print(f"scale {scale}: value {val_err:.2e} rel, gradient {grad_err:.2e} of the largest")
    assert val_err <= 1e-5 and grad_err <= 1e-5


def test_log_mf_norm_constant_gradcheck():
    """The Function's backward (the derivative integrals) against finite
    differences of its forward, in float64."""
    S = torch.tensor(proper_singular_values(np.random.RandomState(7), 6, 3.0),
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tmf.LogMFNormConstant.apply, (S,),
                                    eps=1e-6, atol=1e-6, rtol=1e-4)


def test_matrix_fisher_nll_matches_jax():
    rng = np.random.RandomState(3)
    F = (rng.randn(4, 23, 3, 3) * 3 + np.eye(3)).astype(np.float32)
    R = np.linalg.qr(rng.randn(4, 23, 3, 3))[0].astype(np.float32)
    svd = j_svd(jnp.asarray(F))
    U, S, V = (np.asarray(svd[k]) for k in ("U", "S", "V"))
    ref = np.asarray(jmf.matrix_fisher_nll(jnp.asarray(F), svd["U"], svd["S"],
                                           svd["V"], jnp.asarray(R)))
    port = tmf.matrix_fisher_nll(*(torch.from_numpy(a) for a in (F, U, S, V, R)))
    err = np.max(np.abs(port.numpy() - ref) / np.maximum(np.abs(ref), 1.0))
    print(f"matrix_fisher_nll: {err:.2e} rel")
    assert err <= 1e-5


def _loss_inputs(seed=5, B=3, S=4):
    rng = np.random.RandomState(seed)
    F = (rng.randn(B, 23, 3, 3) * 2 + np.eye(3)).astype(np.float32)
    svd = j_svd(jnp.asarray(F))

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    pred = {"pose_params_F": F,
            **{f"pose_params_{k}": np.asarray(svd[k]) for k in ("U", "S", "V")},
            "shape_mean": f(B, 10), "shape_log_std": f(B, 10) * 0.3,
            "verts": f(B, 6890, 3), "joints3D": f(B, 14, 3),
            "joints2D": f(B, S, 17, 2) * 0.5, "glob_rotmats": f(B, 3, 3)}
    j2d = (rng.rand(B, 17, 2) * 64).astype(np.float32)
    j2d[0, 3] = np.inf                                   # an invisible joint
    vis = rng.rand(B, 17) > 0.3
    vis[0, 3] = False
    target = {"pose_params_rotmats": np.linalg.qr(f(B, 23, 3, 3))[0].astype(np.float32),
              "shape_params": f(B, 10), "joints2D": j2d, "joints2D_vis": vis,
              "glob_rotmats": f(B, 3, 3), "verts": f(B, 6890, 3),
              "joints3D": f(B, 14, 3)}
    return pred, target


@pytest.mark.parametrize("stage", ["STAGE1", "STAGE2"])
def test_pose_mf_shape_gaussian_loss_matches_jax(stage):
    pred, target = _loss_inputs()
    jloss = JLoss(getattr(j_cfg().LOSS, stage), img_wh=64)
    tloss = TLoss(getattr(t_cfg().LOSS, stage), img_wh=64)
    j_total, j_terms = jloss({k: jnp.asarray(v) for k, v in target.items()},
                             {k: jnp.asarray(v) for k, v in pred.items()})
    tpred = {k: torch.tensor(v, requires_grad=True) for k, v in pred.items()}
    t_total, t_terms = tloss({k: torch.from_numpy(v) for k, v in target.items()},
                             tpred)
    for name, t, j in [("total", t_total, j_total)] + [
            (k, t_terms[k], j_terms[k]) for k in j_terms]:
        j = float(j)
        err = abs(float(t) - j) / max(abs(j), 1.0)
        print(f"{stage} {name}: port {float(t):.6g} jax {j:.6g} ({err:.1e} rel)")
        assert np.isfinite(j) and err <= 1e-5, name
    t_total.backward()
    assert all(torch.isfinite(v.grad).all() for v in tpred.values() if v.grad is not None)
    assert tpred["joints2D"].grad[0, :, 3].abs().max() == 0
