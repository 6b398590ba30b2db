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

The Jacobi SVD takes two forms, chosen by the tensor's device; neither
falls back to the other. `svd3x3_plain` (CPU tensors): the torch ops, and
autograd through them. `svd3x3_jacobi_cuda` (CUDA tensors, float32 or
float64): the kernels of csrc/svd3_jacobi.cu, one launch a call forward and
one backward, on the current stream with no host sync (so the pose head's
CUDA graphs capture them). The forward gives the torch ops' bits on the
card; the backward is the exact derivative of the same unrolled algorithm,
the one autograd takes through the torch ops, not the closed-form SVD
gradient. At most MAX_SWEEPS sweeps on the card.
"""

import ctypes
import os
from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from hierarchicalprobabilistic3dhuman_torch.ops.cuda_build import (
    BUILD_DIR, CSRC_DIR, build_library)
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
    """SVD of batched 3x3 matrices by one-sided Jacobi, F = U @ diag(S) @
    V^T, differentiable: CUDA tensors take the kernels
    (svd3x3_jacobi_cuda), CPU tensors the torch ops (svd3x3_plain).

    :param F: (..., 3, 3)
    :return: U (..., 3, 3), S (..., 3) descending, V (..., 3, 3)
    """
    if F.device.type == "cuda":
        return svd3x3_jacobi_cuda(F, n_sweeps)
    if F.device.type != "cpu":
        raise ValueError(f"no svd3x3 for device {F.device}")
    return svd3x3_plain(F, n_sweeps)


def svd3x3_plain(F, n_sweeps=8):
    """svd3x3 as torch ops: what CPU tensors take, and the kernels' plain
    version on the card.

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


SRC_PATH = os.path.join(CSRC_DIR, "svd3_jacobi.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libsvd3_jacobi.so")
LOG_PATH = os.path.join(BUILD_DIR, "libsvd3_jacobi.log")
# The most sweeps the backward kernel's local records hold (the .cu's
# kMaxSweeps).
MAX_SWEEPS = 8


def build_svd3_jacobi():
    """Compile csrc/svd3_jacobi.cu into build/hp3d_torch_kernels/
    libsvd3_jacobi.so (skipped while the library is newer than the source),
    with nvcc's register report in libsvd3_jacobi.log beside it.

    :return: the library path
    """
    return build_library(SRC_PATH, LIB_PATH, LOG_PATH)


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_svd3_jacobi())
    lib.hp3d_svd3_jacobi.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.hp3d_svd3_jacobi.restype = ctypes.c_int
    lib.hp3d_svd3_jacobi_bwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.hp3d_svd3_jacobi_bwd.restype = ctypes.c_int
    return lib


def _launch(name, A, *pointers, n_sweeps):
    """One launch of kernel `name` over A's matrices on A's card's current
    stream; raises on a refused launch."""
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(_library(), name)(*pointers, A.shape[0], n_sweeps,
                                        int(A.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _pointer(grad, like):
    """A gradient's address as the backward kernel reads it, None where
    autograd gave none; the contiguous tensor that holds it."""
    if grad is None:
        return None, None
    grad = grad.reshape(like).contiguous()
    return grad.data_ptr(), grad


class _JacobiKernel(torch.autograd.Function):
    """svd3_jacobi forward, svd3_jacobi_bwd backward, on (N, 3, 3)."""

    @staticmethod
    def forward(ctx, A, n_sweeps):
        N = A.shape[0]
        U, V = torch.empty_like(A), torch.empty_like(A)
        S = A.new_empty((N, 3))
        if N:                      # a launch of no threads fails
            _launch("hp3d_svd3_jacobi", A, A.data_ptr(), U.data_ptr(),
                    S.data_ptr(), V.data_ptr(), n_sweeps=n_sweeps)
            svd3x3_jacobi_cuda.launches += 1
        ctx.save_for_backward(A)
        ctx.n_sweeps = n_sweeps
        ctx.set_materialize_grads(False)
        return U, S, V

    @staticmethod
    @once_differentiable
    def backward(ctx, gU, gS, gV):
        (A,) = ctx.saved_tensors
        N = A.shape[0]
        gF = torch.empty_like(A)
        if N:
            gu, gU = _pointer(gU, A.shape)
            gs, gS = _pointer(gS, (N, 3))
            gv, gV = _pointer(gV, A.shape)
            _launch("hp3d_svd3_jacobi_bwd", A, A.data_ptr(), gu, gs, gv,
                    gF.data_ptr(), n_sweeps=ctx.n_sweeps)
            svd3x3_jacobi_cuda.backward_launches += 1
        return gF, None


def svd3x3_jacobi_cuda(F, n_sweeps=8):
    """Launch the svd3_jacobi kernel: svd3x3_plain's U, S, V, bit for bit as
    its torch ops give them on the card, in one launch on the current stream
    with no host sync; under autograd the backward is one launch of
    svd3_jacobi_bwd. Counts: `.launches`, `.backward_launches` (host
    launches; a CUDA graph's replays are not counted).

    :param F: (..., 3, 3) float32 or float64 on the card
    :param n_sweeps: 0 to MAX_SWEEPS
    :return: U (..., 3, 3), S (..., 3) descending, V (..., 3, 3)
    """
    if F.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"svd3x3_jacobi_cuda: need float32 or float64, got "
                         f"{F.dtype}")
    if F.dim() < 2 or tuple(F.shape[-2:]) != (3, 3):
        raise ValueError(f"svd3x3_jacobi_cuda: need shape (..., 3, 3), got "
                         f"{tuple(F.shape)}")
    if (not isinstance(n_sweeps, int) or isinstance(n_sweeps, bool)
            or not 0 <= n_sweeps <= MAX_SWEEPS):
        raise ValueError(f"svd3x3_jacobi_cuda: n_sweeps must be an int in "
                         f"[0, {MAX_SWEEPS}], got {n_sweeps!r}")
    if not F.is_cuda:
        raise ValueError(f"svd3x3_jacobi_cuda: need a CUDA tensor, got one on "
                         f"{F.device}")
    batch = F.shape[:-2]
    A = F.reshape(-1, 3, 3).contiguous()
    if A.shape[0] >= 2 ** 31:
        raise ValueError(f"svd3x3_jacobi_cuda: {A.shape[0]} matrices, at most "
                         f"2**31 - 1")
    U, S, V = _JacobiKernel.apply(A, n_sweeps)
    return (U.reshape(batch + (3, 3)), S.reshape(batch + (3,)),
            V.reshape(batch + (3, 3)))


svd3x3_jacobi_cuda.launches = 0
svd3x3_jacobi_cuda.backward_launches = 0


def det3x3(M):
    """Determinant of batched 3x3 matrices, closed form."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def proper_from_raw(U, S, V):
    """Fold det signs into the third column/value: U_proper and V_proper are
    rotations and S_proper[..., 2] carries det(U) det(V). The head's
    convention: the signs keep their gradient, as in the JAX package's
    _properize."""
    return fold_det_signs(U, S, V, det3x3(U), det3x3(V))


def fold_det_signs(U, S, V, detU, detV):
    """U's and V's third columns times detU and detV, S's third value times
    detU * detV."""
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
