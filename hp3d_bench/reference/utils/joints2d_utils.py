"""2D joint coordinate helpers, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/joints2d_utils.py
(undo_keypoint_normalisation :15, normalise_keypoints :20,
check_joints2d_visibility :25, check_joints2d_occluded :39), with the same
boundary semantics (a joint at exactly x == img_wh counts visible).
"""

import torch

# joint index -> 14-part-seg body part used for self-occlusion checks
JOINTS_TO_OCCLUSION_BODYPARTS = {7: 3, 8: 5, 9: 12, 10: 11, 13: 7, 14: 9,
                                 15: 14, 16: 13}


def undo_keypoint_normalisation(normalised_keypoints, img_wh):
    """Map keypoints from [-1, 1] back to pixel coordinates."""
    return (normalised_keypoints + 1.0) * (img_wh / 2.0)


def normalise_keypoints(keypoints, img_wh):
    """Map pixel-coordinate keypoints to [-1, 1]."""
    return (2.0 * keypoints) / img_wh - 1.0


def check_joints2d_visibility(joints2d, img_wh, visibility=None):
    """Joints outside the image frame are not visible.

    :param joints2d: (B, N, 2) pixel coords
    :param visibility: optional (B, N) bool initial visibility
    :return: (B, N) bool
    """
    if visibility is None:
        visibility = torch.ones(joints2d.shape[:2], dtype=torch.bool,
                                device=joints2d.device)
    inside = ((joints2d[..., 0] >= 0) & (joints2d[..., 0] <= img_wh)
              & (joints2d[..., 1] >= 0) & (joints2d[..., 1] <= img_wh))
    return visibility & inside


def check_joints2d_occluded(seg14part, vis, pixel_count_threshold=50):
    """Mark appendage joints invisible when their body part is occluded: a
    joint stays visible only if its 14-part-seg body part covers more than
    `pixel_count_threshold` pixels.

    :param seg14part: (B, D, D) 14-part segmentation
    :param vis: (B, 17) bool
    :return: (B, 17) bool
    """
    new_vis = vis.clone()
    for joint_index, part in JOINTS_TO_OCCLUSION_BODYPARTS.items():
        num_pixels_part = torch.sum(seg14part == part, dim=(1, 2))
        new_vis[:, joint_index] = (vis[:, joint_index]
                                   & (num_pixels_part > pixel_count_threshold))
    return new_vis
