"""Joint-set maps and 2D joints <-> heatmaps, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/label_conversions.py
(ALL_JOINTS_TO_COCO_MAP :25, the batched heatmaps :62-99,
convert_heatmaps_to_2Djoints_coordinates :100): the heatmap is the outer
product of two 1-D Gaussians (rows x columns), with the row/col convention
the JAX package pins.
"""

import torch

# The SMPL wrapper (models/smpl.py) returns 90 joints; the COCO-17 subset.
ALL_JOINTS_TO_COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2,
                          4, 5, 7, 8]


def convert_2Djoints_to_gaussian_heatmaps_batched(joints2D, img_wh, std=4.0):
    """Batched heatmaps, channels-first.

    :param joints2D: (B, N, 2) [u=col, v=row] pixel coords
    :return: (B, N, img_wh, img_wh)
    """
    std = float(std)
    grid = torch.arange(img_wh, dtype=torch.float32, device=joints2D.device)
    gc = torch.exp(-((grid - joints2D[..., 0, None]) / std) ** 2 / 2.0)
    gr = torch.exp(-((grid - joints2D[..., 1, None]) / std) ** 2 / 2.0)
    return gr[..., :, None] * gc[..., None, :]


def convert_heatmaps_to_2Djoints_coordinates(joints2D_heatmaps, eps=1e-6):
    """Heatmaps -> argmax coordinates + visibility.

    :param joints2D_heatmaps: (B, K, H, W)
    :return: joints2D (B, K, 2) [u=x, v=y] with -1 for invisible joints,
             joints2D_vis (B, K) bool (max heatmap value > eps)
    """
    B, K, H, W = joints2D_heatmaps.shape
    max_vals, max_idx = torch.max(joints2D_heatmaps.reshape(B, K, H * W), dim=-1)
    x = (max_idx % W).to(torch.float32)
    y = torch.floor(max_idx.to(torch.float32) / float(W))
    joints2D = torch.stack([x, y], dim=-1)
    vis = max_vals > eps
    return torch.where(vis[..., None], joints2D, -1.0), vis
