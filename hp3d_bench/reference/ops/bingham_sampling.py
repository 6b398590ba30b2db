"""Fixed-shape Bingham / matrix-Fisher sampling and Gaussian shape sampling,
in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/bingham_sampling.py
:29-130: ACG proposals for every (batch, joint, sample, oversample) lane are
drawn at once, acceptance is a mask, and the first N accepted lanes in draw
order are kept (the shortfall falls back to the highest acceptance ratios).

The Gaussian draws `eps` and the uniform draws `w` may be passed in, so a
test can hand the port the JAX sampler's own draws; otherwise they come from
the caller's `torch.Generator`.

Gradients flow through the reparameterised draw into the proper singular
values and through U_proper/V_proper; the det signs folded into them are
piecewise constant and carry none (`proper_svd_from_raw`, as the JAX
sampler's :71-78 stops them).
"""

import numpy as np
import torch

from hp3d_bench.reference.ops.svd3 import det3x3, fold_det_signs
from hp3d_bench.reference.utils.rotation_utils import (
    quat_to_rotmat)


def bingham_sampling(A, num_samples, b=1.5, oversampling_ratio=8,
                     generator=None, eps=None, w=None):
    """Sample unit quaternions from Bingham(diag(A)) on S^3 by ACG rejection.

    :param A: (..., 4) non-negative diagonal Bingham parameter
    :param num_samples: N samples per batch element
    :param oversampling_ratio: K proposals drawn per requested sample
    :param eps: optional (..., N*K, 4) standard-normal draws
    :param w: optional (..., N*K) uniform [0, 1) draws
    :return: samples (..., N, 4), accept_ratio (...,)
    """
    batch_shape = A.shape[:-1]
    N, K = num_samples, oversampling_ratio
    Omega = 1.0 + 2.0 * A / b
    Gaussian_std = Omega ** (-0.5)
    M_star = np.exp(-(4.0 - b) / 2.0) * ((4.0 / b) ** 2)

    if eps is None:
        eps = torch.randn(batch_shape + (N * K, 4), generator=generator,
                          dtype=A.dtype, device=A.device)
    if w is None:
        w = torch.rand(batch_shape + (N * K,), generator=generator,
                       dtype=A.dtype, device=A.device)
    y = Gaussian_std[..., None, :] * eps
    samples = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)

    p_bing_star = torch.exp(-torch.sum(samples ** 2 * A[..., None, :], dim=-1))
    p_acg_star = torch.sum(samples ** 2 * Omega[..., None, :], dim=-1) ** (-2)
    ratio = p_bing_star / (M_star * p_acg_star)
    accept = w < ratio

    # "First N accepted" with static shapes: rank accepted lanes by draw
    # order, then the rest by acceptance ratio.
    draw_order = torch.arange(N * K, dtype=A.dtype, device=A.device)
    score = torch.where(accept, -draw_order,
                        -(N * K) - 1.0 + torch.clamp(ratio, 0.0, 1.0))
    idx = torch.argsort(-score, dim=-1, stable=True)[..., :N]
    chosen = torch.gather(samples, -2, idx[..., None].expand(idx.shape + (4,)))
    accept_ratio = accept.sum(dim=-1).to(A.dtype) / N * 4.0
    return chosen, accept_ratio


def proper_svd_from_raw(U, S, V):
    """Raw SVD -> the proper convention, with the det signs detached:
    U_proper and V_proper are rotations, S_proper[..., 2] carries
    det(U) det(V)."""
    return fold_det_signs(U, S, V, det3x3(U).detach(), det3x3(V).detach())


def bingham_A_from_S_proper(S_proper):
    """Bingham diagonal from proper singular values."""
    zeros = torch.zeros_like(S_proper[..., 0])
    return torch.stack([
        zeros,
        2.0 * (S_proper[..., 1] + S_proper[..., 2]),
        2.0 * (S_proper[..., 0] + S_proper[..., 2]),
        2.0 * (S_proper[..., 0] + S_proper[..., 1]),
    ], dim=-1)


def pose_matrix_fisher_sampling(pose_U, pose_S, pose_V, num_samples, b=1.5,
                                oversampling_ratio=8, generator=None,
                                eps=None, w=None):
    """Sample rotation matrices from per-joint matrix-Fisher distributions.

    :param pose_U/S/V: (B, J, 3, 3), (B, J, 3), (B, J, 3, 3) raw SVD of F
    :param eps, w: optional pre-drawn (B, J, N*K, 4) / (B, J, N*K) draws
    :return: (B, N, J, 3, 3) rotation matrix samples
    """
    U_proper, S_proper, V_proper = proper_svd_from_raw(pose_U, pose_S,
                                                     pose_V)
    A = bingham_A_from_S_proper(S_proper)                   # (B, J, 4)
    quat_samples, _ = bingham_sampling(A, num_samples, b=b,
                                       oversampling_ratio=oversampling_ratio,
                                       generator=generator, eps=eps, w=w)
    R_tilde = quat_to_rotmat(quat_samples).transpose(1, 2)  # (B, N, J, 3, 3)
    return U_proper[:, None] @ R_tilde @ V_proper.transpose(-1, -2)[:, None]


def shape_gaussian_sampling(shape_mean, shape_std, num_samples,
                            generator=None, eps=None):
    """Reparameterised diagonal-Gaussian shape samples (the JAX package's
    bingham_sampling.py::shape_gaussian_sampling :122).

    :param shape_mean, shape_std: (B, num_betas)
    :param eps: optional (B, N, num_betas) standard-normal draws
    :return: (B, N, num_betas)
    """
    if eps is None:
        eps = torch.randn((shape_mean.shape[0], num_samples, shape_mean.shape[1]),
                          generator=generator, dtype=shape_mean.dtype,
                          device=shape_mean.device)
    return shape_mean[:, None] + shape_std[:, None] * eps
