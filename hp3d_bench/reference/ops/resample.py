"""Axis-aligned affine image resampling as two matrix products.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/resample.py
(affine_resample :132 through its separable path :87-130). The forward
affine maps INPUT pixel coords (x horizontal, y vertical, centres at
integers, like OpenCV) to OUTPUT pixel coords as `out = A @ [x, y, 1]`;
each output pixel samples the inverse-mapped source point with bilinear tent
weights or the nearest source pixel, and out-of-frame samples take a
constant pad value.

`F.grid_sample` is not used: its pixel-centre convention differs.
"""

import torch


def invert_affine(affine_trans):
    """Invert batched 2x3 affine transforms (..., 2, 3)."""
    A = affine_trans[..., :2]
    t = affine_trans[..., 2]
    inv_det = 1.0 / (A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0])
    A_inv = torch.stack([
        torch.stack([A[..., 1, 1] * inv_det, -A[..., 0, 1] * inv_det], dim=-1),
        torch.stack([-A[..., 1, 0] * inv_det, A[..., 0, 0] * inv_det], dim=-1),
    ], dim=-2)
    t_inv = -torch.einsum("...ij,...j->...i", A_inv, t)
    return torch.cat([A_inv, t_inv[..., None]], dim=-1)


def _interp_matrix(src, size, mode):
    """1-D interpolation weights W[out, in], so resampled = W @ signal.

    Bilinear: tent weights. Nearest: a one-hot at round(src), which rounds
    half to even as jnp.round does.

    :param src: (B, N_out) fractional source coordinate per output index
    :return: (B, N_out, size); rows for out-of-range sources sum below 1
    """
    grid = torch.arange(size, dtype=src.dtype, device=src.device)
    if mode == "bilinear":
        return torch.clamp(1.0 - torch.abs(src[..., None] - grid), min=0.0)
    if mode == "nearest":
        return (torch.round(src)[..., None] == grid).to(src.dtype)
    raise ValueError(f"mode must be 'bilinear' or 'nearest', got {mode!r}")


def affine_resample(images, affine_trans, out_hw, mode="bilinear", pad_val=0.0):
    """Warp a batch of images by scale+translate forward affines.

    Every transform on the port's path is axis-aligned (the off-diagonal
    terms are zero), so the warp is separable: out = Wy @ img @ Wx^T. The
    off-diagonal terms are not read. Out-of-frame samples have a total
    weight below 1; the rest of it goes to `pad_val`.

    :param images: (B, C, H, W)
    :param affine_trans: (B, 2, 3) forward transform (input px -> output px)
    :param out_hw: (OH, OW)
    :param mode: 'bilinear' or 'nearest'
    :param pad_val: constant for out-of-frame samples
    :return: (B, C, OH, OW)
    """
    H, W = images.shape[-2:]
    OH, OW = out_hw
    inv = invert_affine(affine_trans)
    xs = torch.arange(OW, dtype=affine_trans.dtype, device=images.device)
    ys = torch.arange(OH, dtype=affine_trans.dtype, device=images.device)
    src_x = inv[:, 0, 0, None] * xs + inv[:, 0, 2, None]     # (B, OW)
    src_y = inv[:, 1, 1, None] * ys + inv[:, 1, 2, None]     # (B, OH)
    Wx = _interp_matrix(src_x, W, mode)                      # (B, OW, W)
    Wy = _interp_matrix(src_y, H, mode)                      # (B, OH, H)
    out = Wy[:, None] @ images @ Wx.transpose(-1, -2)[:, None]
    if pad_val != 0.0:
        wsum = Wy.sum(-1)[:, :, None] * Wx.sum(-1)[:, None, :]  # (B, OH, OW)
        out = out + pad_val * (1.0 - wsum[:, None])
    return out


def transform_points(affine_trans, points):
    """Apply forward affines (B, 2, 3) to 2D points (B, K, 2) [x, y]."""
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("bij,bkj->bki", affine_trans, homo)
