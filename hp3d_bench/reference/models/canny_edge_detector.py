"""Canny edge detection with fixed convolution weights, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/models/canny_edge_detector.py
:52-116: separable Gaussian blur, Sobel gradients averaged over channels,
orientation rounded to 45-degree bins (half to even, as jnp.round and
torch.round both do), thresholding and directional non-max suppression.
Convolutions are cross-correlations with 'same' zero padding, as in the JAX
package.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size, std):
    """scipy.signal.windows.gaussian equivalent."""
    n = np.arange(size) - (size - 1) / 2.0
    return np.exp(-0.5 * (n / std) ** 2)


_SOBEL = np.array([[1, 0, -1],
                   [2, 0, -2],
                   [1, 0, -1]], dtype=np.float32)

# 8 directional difference filters (0, 45, ..., 315 degrees).
_DIR_FILTERS = np.stack([
    [[0, 0, 0], [0, 1, -1], [0, 0, 0]],
    [[0, 0, 0], [0, 1, 0], [0, 0, -1]],
    [[0, 0, 0], [0, 1, 0], [0, -1, 0]],
    [[0, 0, 0], [0, 1, 0], [-1, 0, 0]],
    [[0, 0, 0], [-1, 1, 0], [0, 0, 0]],
    [[-1, 0, 0], [0, 1, 0], [0, 0, 0]],
    [[0, -1, 0], [0, 1, 0], [0, 0, 0]],
    [[0, 0, -1], [0, 1, 0], [0, 0, 0]],
]).astype(np.float32)


def _conv_same(x, kernel):
    """x (B, Cin, H, W), kernel (Cout, Cin, kh, kw) -> (B, Cout, H, W)."""
    kh, kw = kernel.shape[-2:]
    return F.conv2d(x, kernel, padding=(kh // 2, kw // 2))


class CannyEdgeDetector:
    """Stateless edge detector; its weights are fixed constants on `device`."""

    def __init__(self, device, non_max_suppression=True, gaussian_filter_std=1.0,
                 gaussian_filter_size=5, threshold=0.2):
        self.non_max_suppression = non_max_suppression
        self.threshold = threshold
        g = _gaussian_window(gaussian_filter_size, gaussian_filter_std)
        g = (g / g.sum()).astype(np.float32)

        def const(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self._gauss_h = const(g[None, None, None, :])   # (1, 1, 1, k)
        self._gauss_v = const(g[None, None, :, None])   # (1, 1, k, 1)
        self._sobel_h = const(_SOBEL[None, None])
        self._sobel_v = const(_SOBEL.T[None, None])
        self._dir_filters = const(_DIR_FILTERS[:, None])  # (8, 1, 3, 3)

    def __call__(self, img):
        """:param img: (B, C, H, W) float in [0, 1]
        :return: dict with grad_magnitude, grad_orientation,
                 thresholded_grad_magnitude and (with NMS) thin_edges,
                 thresholded_thin_edges
        """
        B, C, H, W = img.shape
        flat = img.reshape(B * C, 1, H, W)
        blurred = _conv_same(_conv_same(flat, self._gauss_h), self._gauss_v)
        grad_x = _conv_same(blurred, self._sobel_h)
        grad_y = _conv_same(blurred, self._sobel_v)
        grad_x = grad_x.reshape(B, C, H, W).sum(dim=1, keepdim=True) / C
        grad_y = grad_y.reshape(B, C, H, W).sum(dim=1, keepdim=True) / C

        grad_magnitude = torch.sqrt(grad_x ** 2 + grad_y ** 2)
        grad_orientation = torch.atan2(grad_y, grad_x) * (180.0 / np.pi) + 180.0
        grad_orientation = torch.round(grad_orientation / 45.0) * 45.0
        zero = torch.zeros((), dtype=img.dtype, device=img.device)
        output = {
            "grad_magnitude": grad_magnitude,
            "grad_orientation": grad_orientation,
            "thresholded_grad_magnitude": torch.where(
                grad_magnitude < self.threshold, zero, grad_magnitude),
        }
        if self.non_max_suppression:
            all_dir = _conv_same(grad_magnitude, self._dir_filters)  # (B, 8, H, W)
            positive_idx = torch.remainder(grad_orientation / 45.0, 8.0)
            thin_edges = grad_magnitude
            for pos_i in range(4):
                neg_i = pos_i + 4
                is_oriented = (positive_idx == pos_i) | (positive_idx == neg_i)
                is_max = torch.minimum(all_dir[:, pos_i:pos_i + 1],
                                       all_dir[:, neg_i:neg_i + 1]) > 0.0
                thin_edges = torch.where(~is_max & is_oriented, zero, thin_edges)
            output["thin_edges"] = thin_edges
            output["thresholded_thin_edges"] = torch.where(
                thin_edges < self.threshold, zero, thin_edges)
        return output
