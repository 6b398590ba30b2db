"""RGB image augmentation, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/augmentation/
rgb_augmentation.py (random_pixel_noise_per_channel :17,
random_gaussian_blur :25, augment_rgb :47): the occlusion halves are the
proxy-rep ones; per-channel pixel noise; and a separable Gaussian blur,
which augment_rgb does not call (as in the reference).
"""

import torch
import torch.nn.functional as F

from hp3d_bench.reference.utils.augmentation.proxy_rep_augmentation import (
    random_occlude_bottom_half, random_occlude_top_half,
    random_occlude_vertical_half)


def random_pixel_noise_per_channel(draws, rgb, per_channel_pixel_noise_factor=0.2):
    """Multiply each channel by a random factor in [1-f, 1+f], clamp at 1."""
    f = per_channel_pixel_noise_factor
    noise = draws.uniform((rgb.shape[0], 3), 1 - f, 1 + f)
    return torch.clamp(rgb * noise[:, :, None, None], max=1.0)


def random_gaussian_blur(draws, rgb, sigma_range=(0.2, 1.2), kernel_size=7):
    """Separable Gaussian blur with one random sigma for the batch."""
    sigma = draws.uniform((), *sigma_range)
    n = (torch.arange(kernel_size, dtype=rgb.dtype, device=rgb.device)
         - (kernel_size - 1) / 2.0)
    k = torch.exp(-0.5 * (n / sigma) ** 2)
    k = k / k.sum()
    B, C, H, W = rgb.shape
    pad = kernel_size // 2
    out = F.conv2d(rgb.reshape(B * C, 1, H, W), k[None, None, None, :],
                   padding=(0, pad))
    out = F.conv2d(out, k[None, None, :, None], padding=(pad, 0))
    return out.reshape(B, C, H, W)


def augment_rgb(draws, rgb, joints2D, joints2D_visib, rgb_augment_config):
    """The whole RGB augmentation."""
    cfg = rgb_augment_config
    d = draws.split(4)
    rgb, joints2D, joints2D_visib = random_occlude_bottom_half(
        d[0], rgb, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_BOTTOM_PROB)
    rgb, joints2D, joints2D_visib = random_occlude_top_half(
        d[1], rgb, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_TOP_PROB)
    rgb, joints2D, joints2D_visib = random_occlude_vertical_half(
        d[2], rgb, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_VERTICAL_PROB)
    rgb = random_pixel_noise_per_channel(
        d[3], rgb, per_channel_pixel_noise_factor=cfg.PIXEL_CHANNEL_NOISE)
    return rgb, joints2D, joints2D_visib
