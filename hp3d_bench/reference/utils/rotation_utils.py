"""Rotation representations and the SO(3) exponential map, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/rotation_utils.py
(rot6d_to_rotmat :20, rotmat_to_rot6d :41, quat_to_rotmat :53, so3_exp :81,
so3_log :107, theta2_sixth :154, aa_rotate_rotmats :159,
aa_rotate_translate_points :179, batch_rodrigues :196), with the same
formulas, guards and branch selection. All functions accept arbitrary
leading batch dims.
"""

import math

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


def rotmat_to_rot6d(R, stack_columns=False):
    """Rotation matrix -> 6D representation (reference :97-110).

    stack_columns=False (default) returns [R11, R12, R21, R22, R31, R32]
    (the exact inverse layout of rot6d_to_rotmat); True returns the two
    columns stacked [col0; col1].
    """
    if stack_columns:
        return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))


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


def so3_log(R):
    """Rotation matrix -> axis-angle vector (SO(3) log map).

    Three branches, selected as in the JAX package: theta < 1e-4 takes
    w (0.5 + theta^2 / 12) from the antisymmetric part w; theta > pi - 1e-3
    takes the normalised column of R + I at the largest diagonal entry,
    signed by the diagonal-based axis, times theta; the rest w theta /
    (2 sin theta).

    :param R: (..., 3, 3)
    :return: (..., 3)
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)

    # Generic branch: axis from the antisymmetric part.
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    generic = w * (theta / (2.0 * safe_sin))[..., None]

    # Small-angle branch: log(R) ~ (R - R^T)/2 vectorised, i.e. w / 2.
    small_branch = w * (0.5 + theta2_sixth(theta))[..., None]

    # Near-pi branch: the column of R + I at the largest diagonal entry,
    # its sign set by the diagonal-based axis sqrt((diag + 1) / 2).
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, 0.0, 1.0))
    k = torch.argmax(diag, dim=-1)
    Rp = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col = torch.gather(Rp, -1, k[..., None, None].expand(k.shape + (3, 1)))[..., 0]
    col_norm = _normalise(col)
    signed_axis = torch.where(torch.sum(col_norm * axis, dim=-1, keepdim=True) < 0,
                              -col_norm, col_norm)
    pi_branch = signed_axis * theta[..., None]

    return torch.where(small[..., None], small_branch,
                       torch.where(near_pi[..., None], pi_branch, generic))


def theta2_sixth(theta):
    """Second-order correction term theta^2/12 used in the small-angle log map."""
    return theta * theta / 12.0


def aa_rotate_rotmats(rotmats, axes, angles, rot_mult_order="post"):
    """Rotate rotation matrices about given axis-angles (reference :11-31,
    :34-58).

    :param rotmats: (B, 3, 3)
    :param axes: (3,) or (B, 3)
    :param angles: scalar or (B, 1), radians
    :param rot_mult_order: "post" (rotmats @ R) or "pre" (R @ rotmats)
    :return: (rotated_rotvecs (B, 3), rotated_rotmats (B, 3, 3))
    """
    if rot_mult_order not in ("pre", "post"):
        raise ValueError(f"rot_mult_order {rot_mult_order!r}")
    def tensor(a):
        return torch.as_tensor(a, dtype=rotmats.dtype, device=rotmats.device)

    r = tensor(axes) * tensor(angles)
    if r.ndim < 2:
        r = r[None, :].expand(rotmats.shape[0], 3)
    R = so3_exp(r)
    rotated = rotmats @ R if rot_mult_order == "post" else R @ rotmats
    return so3_log(rotated), rotated


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
