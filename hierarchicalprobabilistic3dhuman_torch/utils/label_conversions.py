"""2D joints -> Gaussian heatmaps, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/label_conversions.py
:62-99: the heatmap is the outer product of two 1-D Gaussians (rows x
columns), with the row/col convention the JAX package pins.
"""

import torch


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
