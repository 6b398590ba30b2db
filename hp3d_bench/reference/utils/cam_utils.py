"""Camera models: weak-perspective (scaled orthographic) and perspective.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/cam_utils.py
(orthographic_project :12, get_intrinsics_matrix :24, perspective_project
:31, convert_weak_perspective_to_camera_translation :59,
batch_convert_weak_perspective_to_camera_translation :66), batched.
"""

import numpy as np
import torch


def orthographic_project(points3D, cam_params):
    """Scaled orthographic (weak-perspective) projection.

    :param points3D: (B, N, 3)
    :param cam_params: (B, 3) [scale, tx, ty]
    :return: (B, N, 2) in normalised [-1, 1]-ish coords
    """
    scale = cam_params[..., None, 0:1]
    trans = cam_params[..., None, 1:3]
    return scale * (points3D[..., :2] + trans)


def get_intrinsics_matrix(img_width, img_height, focal_length):
    """3x3 calibration matrix with principal point at the image centre."""
    return np.array([[focal_length, 0.0, img_width / 2.0],
                     [0.0, focal_length, img_height / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


def perspective_project(points, rotation, translation, cam_K=None,
                        focal_length=None, img_wh=None):
    """Perspective projection.

    :param points: (B, N, 3)
    :param rotation: (B, 3, 3) or None
    :param translation: (B, 3)
    :param cam_K: (B, 3, 3) or None (then focal_length + img_wh required)
    :return: (B, N, 2) pixel coordinates
    """
    if cam_K is None:
        cam_K = torch.as_tensor(
            get_intrinsics_matrix(img_wh, img_wh, focal_length),
            device=points.device).expand(points.shape[0], 3, 3)
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    # Sign-preserving depth clamp: a point on the camera plane (z == 0)
    # would divide to NaN; such joints project huge and fail the visibility
    # check instead.
    z = points[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-2,
                         torch.where(z < 0, -1e-2, 1e-2), z)
    projected = torch.einsum("bij,bkj->bki", cam_K, points / z_safe)
    return projected[..., :2]


def convert_weak_perspective_to_camera_translation(cam_wp, focal_length,
                                                   resolution):
    """Single weak-perspective [s, tx, ty] -> camera translation (numpy)."""
    cam_wp = np.asarray(cam_wp)
    return np.array([cam_wp[1], cam_wp[2],
                     2 * focal_length / (resolution * cam_wp[0] + 1e-9)])


def batch_convert_weak_perspective_to_camera_translation(cam_wp, focal_length,
                                                         resolution):
    """Batched weak-perspective -> camera translation, for tensors or numpy.

    :param cam_wp: (B, 3)
    :return: (B, 3)
    """
    cam_tz = 2 * focal_length / (resolution * cam_wp[:, 0] + 1e-9)
    if isinstance(cam_wp, torch.Tensor):
        return torch.stack([cam_wp[:, 1], cam_wp[:, 2], cam_tz], dim=-1)
    return np.stack([cam_wp[:, 1], cam_wp[:, 2], cam_tz], axis=-1)
