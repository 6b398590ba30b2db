"""Joint-set maps and 2D joints <-> heatmaps, in torch and numpy.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/label_conversions.py
(ALL_JOINTS_TO_COCO_MAP :25, ALL_JOINTS_TO_H36M_MAP :26, H36M_TO_J14 :28,
the heatmaps :62-99, convert_heatmaps_to_2Djoints_coordinates :100): the
heatmap is the outer product of two 1-D Gaussians (rows x columns), with
the row/col convention the JAX package pins. The datasets build one item's
heatmaps on the host, in numpy (convert_2Djoints_to_gaussian_heatmaps).
"""

import numpy as np
import torch

# The SMPL wrapper (models/smpl.py) returns 90 joints; the COCO-17 subset,
# the H36M-17 subset, and the 14 evaluation joints of H36M's 17.
ALL_JOINTS_TO_COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2,
                          4, 5, 7, 8]
ALL_JOINTS_TO_H36M_MAP = list(range(73, 90))
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]


def convert_2Djoints_to_gaussian_heatmaps(joints2D, img_wh, std=4):
    """Unbatched heatmaps, channels-last, float32 numpy.

    :param joints2D: (N, 2) [u=col, v=row] pixel coords
    :return: (img_wh, img_wh, N)
    """
    joints2D = np.asarray(joints2D, dtype=np.float32)
    std = np.float32(std)
    grid = np.arange(img_wh, dtype=np.float32)
    gc = np.exp(-((grid - joints2D[:, 0, None]) / std) ** 2 / np.float32(2.0))
    gr = np.exp(-((grid - joints2D[:, 1, None]) / std) ** 2 / np.float32(2.0))
    return np.transpose(gr[:, :, None] * gc[:, None, :], (1, 2, 0))


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
