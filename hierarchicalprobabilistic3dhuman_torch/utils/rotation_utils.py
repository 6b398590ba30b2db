"""Rotation representations and the SO(3) exponential map, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/rotation_utils.py
(rot6d_to_rotmat :20, quat_to_rotmat :53, so3_exp :81,
aa_rotate_translate_points :179, batch_rodrigues :196), with the same
formulas and guards. All functions accept arbitrary leading batch dims.
"""

import torch

_EPS = 1e-8


def _normalise(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=_EPS)


def rot6d_to_rotmat(x):
    """6D rotation representation -> rotation matrix via Gram-Schmidt.

    The 6 numbers are the first two columns of R stored row-interleaved,
    i.e. x.reshape(..., 3, 2) (reference utils/rigid_transform_utils.py:80-94).

    :param x: (..., 6)
    :return: (..., 3, 3)
    """
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1 = x[..., 0]
    a2 = x[..., 1]
    b1 = _normalise(a1)
    b2 = _normalise(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_to_rotmat(quat):
    """Quaternion (w, x, y, z) -> rotation matrix; need not be normalised.

    :param quat: (..., 4)
    :return: (..., 3, 3)
    """
    q = _normalise(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def _hat(v):
    """Skew-symmetric matrix of (..., 3) vectors."""
    zeros = torch.zeros_like(v[..., 0])
    row0 = torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1)
    row1 = torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1)
    row2 = torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def so3_exp(log_rot):
    """Axis-angle vector -> rotation matrix (Rodrigues' formula).

    sin(t)/t and (1 - cos t)/t^2 switch to their Taylor expansions below
    t = 1e-4, as in the JAX package.

    :param log_rot: (..., 3)
    :return: (..., 3, 3)
    """
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-4
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    sin_t_over_t = torch.where(small, 1.0 - theta2 / 6.0,
                               torch.sin(theta) / torch.sqrt(safe_theta2))
    one_minus_cos_over_t2 = torch.where(small, 0.5 - theta2 / 24.0,
                                        (1.0 - torch.cos(theta)) / safe_theta2)
    K = _hat(log_rot)
    KK = K @ K
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device)
    return (eye
            + sin_t_over_t[..., None, None] * K
            + one_minus_cos_over_t2[..., None, None] * KK)


def aa_rotate_translate_points(points, axis, angle, translation):
    """Rotate point sets about one axis-angle, then translate.

    :param points: (B, N, 3)
    :param axis: (3,) sequence or tensor
    :param angle: scalar, radians
    :param translation: (3,) sequence or tensor
    :return: (B, N, 3)
    """
    r = torch.as_tensor(axis, dtype=points.dtype, device=points.device) * angle
    R = so3_exp(r.expand(points.shape[0], 3))
    rotated = torch.einsum("bij,bkj->bki", R, points)
    return rotated + torch.as_tensor(translation, dtype=points.dtype,
                                     device=points.device)


def batch_rodrigues(axisang):
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); alias of so3_exp."""
    return so3_exp(axisang)
