"""Camera translation jitter, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/augmentation/
cam_augmentation.py::augment_cam_t :7 (its key splits into key_xy, key_z).
"""

import torch


def augment_cam_t(draws, mean_cam_t, xy_std=0.05, delta_z_range=(-0.5, 0.5)):
    """:param mean_cam_t: (B, 3); returns jittered (B, 3)."""
    B = mean_cam_t.shape[0]
    draws_xy, draws_z = draws.split(2)
    delta_xy = draws_xy.normal((B, 2)) * xy_std
    l, h = delta_z_range
    delta_z = draws_z.uniform((B,), l, h)
    return torch.cat([mean_cam_t[:, :2] + delta_xy,
                      (mean_cam_t[:, 2] + delta_z)[:, None]], dim=1)
