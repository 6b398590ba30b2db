"""Cropping around explicit boxes and compositing, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/image_utils.py
(batch_add_rgb_background :46, batch_crop_affine :137) for the predict path:
explicit bounding boxes, RGB and 2D joints. Box centres are (vertical,
horizontal); affines act on (x=horizontal, y=vertical) pixel coords.
"""

import torch

from hierarchicalprobabilistic3dhuman_torch.ops.resample import (
    affine_resample, transform_points)


def batch_add_rgb_background(backgrounds, rgb, seg):
    """Composite rendered bodies onto backgrounds.

    :param backgrounds: (B, 3, wh, wh)
    :param rgb: (B, 3, wh, wh)
    :param seg: (B, wh, wh)  body pixels > 0, background 0
    """
    background_pixels = (seg[:, None] == 0)
    return rgb * ~background_pixels + backgrounds * background_pixels


def _fix_aspect_ratio(heights, widths, output_wh):
    """Grow the smaller bbox side to match the output aspect ratio."""
    aspect = output_wh[1] / output_wh[0]  # h / w
    widths = torch.where(heights > widths * aspect, heights / aspect, widths)
    heights = torch.where(heights < widths * aspect, widths * aspect, heights)
    return heights, widths


def crop_affine_from_bbox(bbox_centres, bbox_heights, bbox_widths, output_wh):
    """Forward affine (input px -> output px) for a crop."""
    out_w, out_h = output_wh
    a00 = out_w / bbox_widths
    a11 = out_h / bbox_heights
    tx = out_w * 0.5 - a00 * bbox_centres[:, 1]
    ty = out_h * 0.5 - a11 * bbox_centres[:, 0]
    zeros = torch.zeros_like(a00)
    return torch.stack([torch.stack([a00, zeros, tx], dim=-1),
                        torch.stack([zeros, a11, ty], dim=-1)], dim=1)


def batch_crop_affine(output_wh, bbox_centres, bbox_heights, bbox_widths,
                      rgb=None, joints2D=None, orig_scale_factor=1.2):
    """Crop-and-resize around explicit person boxes.

    Aspect-ratio fix, scale factor, one bilinear warp of the RGB and the same
    affine applied to the 2D joints.

    :param output_wh: (w, h) of the crops
    :param bbox_centres: (B, 2) [vert, hor]
    :param bbox_heights, bbox_widths: (B,)
    :return: dict with 'rgb' (B, 3, h, w) and/or 'joints2D' (B, K, 2), plus
             'affine_trans' (B, 2, 3)
    """
    out_w, out_h = int(output_wh[0]), int(output_wh[1])
    # Degenerate-box guard, as in the JAX package: a zero-size box would
    # divide to inf in the affine.
    bbox_heights = torch.clamp(bbox_heights, min=2.0)
    bbox_widths = torch.clamp(bbox_widths, min=2.0)
    bbox_heights, bbox_widths = _fix_aspect_ratio(bbox_heights, bbox_widths,
                                                  (float(out_w), float(out_h)))
    bbox_heights = bbox_heights * orig_scale_factor
    bbox_widths = bbox_widths * orig_scale_factor
    affine = crop_affine_from_bbox(bbox_centres, bbox_heights, bbox_widths,
                                   (float(out_w), float(out_h)))
    out = {"affine_trans": affine}
    if rgb is not None:
        out["rgb"] = affine_resample(rgb, affine, (out_h, out_w))
    if joints2D is not None:
        out["joints2D"] = transform_points(affine, joints2D)
    return out
