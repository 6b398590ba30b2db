"""Batched 3x3 SVDs in torch: one-sided Jacobi, and the LAPACK-sign modes.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/svd3.py
(proper_svd3x3 :142, _properize :126, det3x3 :119, _np_svd3 :156,
svd3x3_lapack :164, proper_svd3x3_lapack :190, proper_svd3x3_gesdd :200).
The Jacobi sweep order, the rotation formula, the descending stable sort
and the rebuild of U from the rotated columns follow the JAX kernel step
for step, so U/S/V match it including column signs. torch.linalg.svd is
not used: its sign choices differ, and the hierarchical head feeds U/S/mode
of each joint to its children.

The LAPACK-sign modes serve checkpoints trained on the reference's
torch.svd signs: `proper_svd3x3_gesdd` runs ops/lapack_svd3.py on the
tensors' own device, `proper_svd3x3_lapack` is the oracle the JAX package
holds itself to, numpy's sgesdd on a host copy, on every device.
"""

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import svd3x3_gesdd

_TINY = 1e-30


def _jacobi_rotation(a_pp, a_qq, a_pq):
    """cos/sin of the angle orthogonalising columns p, q:
    theta = 0.5 * atan2(2 a_pq, a_pp - a_qq), zero at the exact degenerate
    point."""
    num = 2.0 * a_pq
    den = a_pp - a_qq
    degenerate = (torch.abs(num) < _TINY) & (torch.abs(den) < _TINY)
    num = torch.where(degenerate, torch.zeros_like(num), num)
    den = torch.where(degenerate, torch.ones_like(den), den)
    theta = 0.5 * torch.atan2(num, den)
    return torch.cos(theta), torch.sin(theta)


def _apply_right_rotation(A, p, q, c, s):
    """A @ G(p, q, theta) for batched (..., 3, 3) A; c/s are (...,)."""
    col_p = A[..., :, p]
    col_q = A[..., :, q]
    A = A.clone()
    A[..., :, p] = c[..., None] * col_p + s[..., None] * col_q
    A[..., :, q] = -s[..., None] * col_p + c[..., None] * col_q
    return A


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def svd3x3(F, n_sweeps=8):
    """SVD of batched 3x3 matrices, F = U @ diag(S) @ V^T.

    :param F: (..., 3, 3)
    :return: U (..., 3, 3), S (..., 3) descending, V (..., 3, 3)
    """
    A = F
    V = torch.eye(3, dtype=F.dtype, device=F.device).expand(F.shape)
    for _ in range(n_sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            a_pp = torch.sum(A[..., :, p] * A[..., :, p], dim=-1)
            a_qq = torch.sum(A[..., :, q] * A[..., :, q], dim=-1)
            a_pq = torch.sum(A[..., :, p] * A[..., :, q], dim=-1)
            c, s = _jacobi_rotation(a_pp, a_qq, a_pq)
            A = _apply_right_rotation(A, p, q, c, s)
            V = _apply_right_rotation(V, p, q, c, s)

    # Singular values are the column norms of the converged A = U diag(S).
    S = torch.sqrt(torch.clamp(torch.sum(A * A, dim=-2), min=0.0))
    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.gather(S, -1, order)
    cols = order[..., None, :].expand(A.shape)
    A = torch.gather(A, -1, cols)
    V = torch.gather(V, -1, cols)

    # U columns: normalised A columns, with orthogonal rebuilds where F is
    # rank-deficient.
    eps = 1e-12
    u0_raw = A[..., :, 0]
    u0_norm = _norm(u0_raw)
    e0 = torch.zeros_like(u0_raw)
    e0[..., 0] = 1.0
    u0 = torch.where(u0_norm > eps, u0_raw / torch.clamp(u0_norm, min=eps), e0)

    u1_raw = A[..., :, 1]
    u1_ortho = u1_raw - torch.sum(u0 * u1_raw, dim=-1, keepdim=True) * u0
    u1_norm = _norm(u1_ortho)
    zero = torch.zeros_like(u0[..., 0])
    fallback1_a = torch.stack([-u0[..., 1], u0[..., 0], zero], dim=-1)
    fallback1_b = torch.stack([zero, -u0[..., 2], u0[..., 1]], dim=-1)
    fallback1 = torch.where(_norm(fallback1_a) > 0.1, fallback1_a, fallback1_b)
    fallback1 = fallback1 / torch.clamp(_norm(fallback1), min=eps)
    u1 = torch.where(u1_norm > eps, u1_ortho / torch.clamp(u1_norm, min=eps),
                     fallback1)

    cross01 = torch.linalg.cross(u0, u1, dim=-1)
    # Keep the sign of the true third column where it is meaningful.
    sign = torch.where(torch.sum(cross01 * A[..., :, 2], dim=-1, keepdim=True)
                       < 0.0, -1.0, 1.0)
    U = torch.stack([u0, u1, cross01 * sign], dim=-1)
    return U, S, V


def det3x3(M):
    """Determinant of batched 3x3 matrices, closed form."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def proper_from_raw(U, S, V):
    """Fold det signs into the third column/value: U_proper and V_proper are
    rotations and S_proper[..., 2] carries det(U) det(V)."""
    detU = det3x3(U)
    detV = det3x3(V)
    U_proper = torch.cat([U[..., :2], U[..., 2:] * detU[..., None, None]], dim=-1)
    V_proper = torch.cat([V[..., :2], V[..., 2:] * detV[..., None, None]], dim=-1)
    S_proper = torch.cat([S[..., :2], S[..., 2:] * (detU * detV)[..., None]],
                         dim=-1)
    return U_proper, S_proper, V_proper


def _properize(U, S, V):
    U_proper, S_proper, V_proper = proper_from_raw(U, S, V)
    return {
        "U": U, "S": S, "V": V,
        "U_proper": U_proper, "S_proper": S_proper, "V_proper": V_proper,
        "mode": U_proper @ V_proper.transpose(-1, -2),
    }


def proper_svd3x3(F, n_sweeps=8):
    """Jacobi SVD with the reference's "proper" rotation convention.

    :return: dict with U, S, V (raw SVD), U_proper, S_proper, V_proper, and
             mode = U_proper @ V_proper^T (the distribution's mode rotation).
    """
    return _properize(*svd3x3(F, n_sweeps=n_sweeps))


def svd3x3_lapack(F):
    """SVD by numpy's LAPACK sgesdd on a host copy, returned on F's device.

    :param F: (..., 3, 3)
    :return: U (..., 3, 3), S (..., 3), V (..., 3, 3)
    """
    U, S, Vh = np.linalg.svd(F.detach().to("cpu", torch.float32).numpy())
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=F.device)
                 for a in (U, S, np.swapaxes(Vh, -1, -2)))


def proper_svd3x3_lapack(F):
    """proper_svd3x3 with numpy's LAPACK signs (the host oracle)."""
    return _properize(*svd3x3_lapack(F))


def proper_svd3x3_gesdd(F):
    """proper_svd3x3 with LAPACK sgesdd's signs, on F's device
    (ops/lapack_svd3.py; not differentiable)."""
    return _properize(*svd3x3_gesdd(F))
