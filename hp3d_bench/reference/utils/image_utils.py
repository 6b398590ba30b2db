"""Bounding boxes, cropping and uncropping around explicit boxes, and
compositing, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/image_utils.py
(convert_bbox_corners_to_centre_hw :26, convert_bbox_centre_hw_to_corners
:38, batch_add_rgb_background :46, bbox_from_mask :57, bbox_from_joints2d
:80, uncrop_affine_from_bbox :122, batch_crop_affine :137,
batch_uncrop_affine :236): explicit bounding boxes for predict and
evaluation, and for training boxes taken from a mask (IUV, seg or a
`bbox_determiner`) or from visible joints, with random scale and centre
jitter; RGB, IUV, segmentations and 2D joints. Box centres are (vertical,
horizontal); affines act on (x=horizontal, y=vertical) pixel coords.
"""

import torch

from hp3d_bench.reference.ops.resample import (
    affine_resample, transform_points)


def convert_bbox_corners_to_centre_hw(bbox_corners):
    """[x1, y1, x2, y2] (vert, hor) corners -> centre (vert, hor), height, width.

    :param bbox_corners: (..., 4)
    """
    centre = torch.stack([(bbox_corners[..., 0] + bbox_corners[..., 2]) / 2.0,
                          (bbox_corners[..., 1] + bbox_corners[..., 3]) / 2.0],
                         dim=-1)
    heights = bbox_corners[..., 2] - bbox_corners[..., 0]
    widths = bbox_corners[..., 3] - bbox_corners[..., 1]
    return centre, heights, widths


def convert_bbox_centre_hw_to_corners(centre, height, width):
    """Centre (vert, hor) + height/width -> [x1, y1, x2, y2]."""
    return torch.stack([centre[..., 0] - height / 2.0,
                        centre[..., 1] - width / 2.0,
                        centre[..., 0] + height / 2.0,
                        centre[..., 1] + width / 2.0], dim=-1)


def batch_add_rgb_background(backgrounds, rgb, seg):
    """Composite rendered bodies onto backgrounds.

    :param backgrounds: (B, 3, wh, wh)
    :param rgb: (B, 3, wh, wh)
    :param seg: (B, wh, wh)  body pixels > 0, background 0
    """
    background_pixels = (seg[:, None] == 0)
    return rgb * ~background_pixels + backgrounds * background_pixels


_BIG = 1e9


def bbox_from_mask(mask):
    """Tight box corners around non-zero mask pixels, batched; the whole
    image for an empty mask.

    :param mask: (B, H, W) any dtype (non-zero = foreground)
    :return: (B, 4) [row_min, col_min, row_max, col_max] float32
    """
    B, H, W = mask.shape
    fg = mask != 0
    rows = torch.arange(H, dtype=torch.float32, device=mask.device)[None, :, None]
    cols = torch.arange(W, dtype=torch.float32, device=mask.device)[None, None, :]
    big = torch.tensor(_BIG, device=mask.device)
    row_min = torch.where(fg, rows, big).amin(dim=(1, 2))
    row_max = torch.where(fg, rows, -big).amax(dim=(1, 2))
    col_min = torch.where(fg, cols, big).amin(dim=(1, 2))
    col_max = torch.where(fg, cols, -big).amax(dim=(1, 2))
    empty = ~fg.any(dim=2).any(dim=1)
    zero = torch.zeros_like(row_min)
    return torch.stack([torch.where(empty, zero, row_min),
                        torch.where(empty, zero, col_min),
                        torch.where(empty, zero + (H - 1.0), row_max),
                        torch.where(empty, zero + (W - 1.0), col_max)], dim=-1)


def bbox_from_joints2d(joints2d, joints2d_vis, fallback_wh):
    """Tight box corners around the visible joints; a box of fallback_wh
    from the first corner where it degenerates (<= 1 visible joint).

    :param joints2d: (B, K, 2) [x, y]
    :param joints2d_vis: (B, K) bool
    :return: (B, 4) [row_min, col_min, row_max, col_max]
    """
    vis = joints2d_vis[..., None]
    big = torch.tensor(_BIG, dtype=joints2d.dtype, device=joints2d.device)
    lo = torch.where(vis, joints2d, big).amin(dim=1)        # (B, 2) [x, y]
    hi = torch.where(vis, joints2d, -big).amax(dim=1)
    x_min, y_min, x_max, y_max = lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]
    degenerate = (x_min == x_max) & (y_min == y_max)
    y_max = torch.where(degenerate, y_min + fallback_wh[1], y_max)
    x_max = torch.where(degenerate, x_min + fallback_wh[0], x_max)
    return torch.stack([y_min, x_min, y_max, x_max], dim=-1)


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


def uncrop_affine_from_bbox(bbox_centres, bbox_heights, bbox_widths, output_wh):
    """Forward affine mapping a cropped image back into the original frame."""
    out_w, out_h = output_wh
    a00 = bbox_widths / out_w
    a11 = bbox_heights / out_h
    tx = bbox_centres[:, 1] - a00 * (out_w * 0.5)
    ty = bbox_centres[:, 0] - a11 * (out_h * 0.5)
    zeros = torch.zeros_like(a00)
    return torch.stack([torch.stack([a00, zeros, tx], dim=-1),
                        torch.stack([zeros, a11, ty], dim=-1)], dim=1)


def batch_crop_affine(output_wh, bbox_centres=None, bbox_heights=None,
                      bbox_widths=None, rgb=None, joints2D=None,
                      orig_scale_factor=1.2, *, iuv=None, seg=None,
                      bbox_determiner=None, joints2D_vis=None,
                      delta_scale_range=None, delta_centre_range=None,
                      out_of_frame_pad_val=0.0, draws=None):
    """Crop-and-resize around person boxes.

    The boxes are given, or taken from `bbox_determiner`, else the IUV's
    part channel, else `seg`, else the visible joints. Then the aspect-ratio
    fix, the scale factor (plus a random delta from `delta_scale_range`),
    a random centre shift from `delta_centre_range`, one warp per input
    (bilinear RGB; nearest IUV padded with `out_of_frame_pad_val`, nearest
    seg) and the same affine applied to the 2D joints. The jitter draws come
    from `draws` (utils/random_draws.py), split as the JAX function splits
    its key.

    :param output_wh: (w, h) of the crops
    :param bbox_centres: (B, 2) [vert, hor]; bbox_heights, bbox_widths (B,)
    :return: dict with 'rgb' (B, 3, h, w), 'iuv' (B, 3, h, w), 'seg'
             (B, h, w) and 'joints2D' (B, K, 2) for the inputs given, plus
             the boxes as cropped ('bbox_centres', 'bbox_heights',
             'bbox_widths', after the aspect fix, scale and jitter) and
             'affine_trans' (B, 2, 3)
    """
    out_w, out_h = int(output_wh[0]), int(output_wh[1])
    if bbox_centres is None:
        if bbox_determiner is not None:
            corners = bbox_from_mask(bbox_determiner)
        elif iuv is not None:
            corners = bbox_from_mask(iuv[:, 0])
        elif seg is not None:
            corners = bbox_from_mask(seg)
        elif joints2D is not None:
            corners = bbox_from_joints2d(joints2D, joints2D_vis, (out_w, out_h))
        else:
            raise ValueError("Need IUV, seg, joints2D or explicit bboxes")
        bbox_centres, bbox_heights, bbox_widths = \
            convert_bbox_corners_to_centre_hw(corners)
    # Degenerate-box guard, as in the JAX package: a zero-size box would
    # divide to inf in the affine.
    bbox_heights = torch.clamp(bbox_heights, min=2.0)
    bbox_widths = torch.clamp(bbox_widths, min=2.0)
    bbox_heights, bbox_widths = _fix_aspect_ratio(bbox_heights, bbox_widths,
                                                  (float(out_w), float(out_h)))
    B = bbox_centres.shape[0]
    scale_factor = orig_scale_factor
    if delta_scale_range is not None:
        draws, sub = draws.split(2)
        scale_factor = orig_scale_factor + sub.uniform((B,), *delta_scale_range)
    bbox_heights = bbox_heights * scale_factor
    bbox_widths = bbox_widths * scale_factor
    if delta_centre_range is not None:
        draws, sub = draws.split(2)
        bbox_centres = bbox_centres + sub.uniform((B, 2), *delta_centre_range)
    affine = crop_affine_from_bbox(bbox_centres, bbox_heights, bbox_widths,
                                   (float(out_w), float(out_h)))
    out = {"bbox_centres": bbox_centres, "bbox_heights": bbox_heights,
           "bbox_widths": bbox_widths, "affine_trans": affine}
    if iuv is not None:
        out["iuv"] = affine_resample(iuv, affine, (out_h, out_w), mode="nearest",
                                     pad_val=out_of_frame_pad_val)
    if rgb is not None:
        out["rgb"] = affine_resample(rgb, affine, (out_h, out_w))
    if seg is not None:
        out["seg"] = affine_resample(seg[:, None], affine, (out_h, out_w),
                                     mode="nearest")[:, 0]
    if joints2D is not None:
        out["joints2D"] = transform_points(affine, joints2D)
    return out


def batch_uncrop_affine(output_wh, uncrop_wh, bbox_centres, bbox_heights,
                        bbox_widths, iuv=None, rgb=None, seg=None,
                        out_of_frame_pad_val=0.0):
    """Inverse of batch_crop_affine: paste crops back into the original frame
    (rgb bilinear; iuv and seg nearest, iuv padded with
    `out_of_frame_pad_val`).

    :param output_wh: (w, h) of the cropped images
    :param uncrop_wh: (w, h) of the original frame
    :param bbox_centres: (B, 2) [vert, hor]; bbox_heights, bbox_widths (B,)
    :return: dict with 'iuv' (B, 3, h, w), 'rgb' (B, 3, h, w), 'seg'
             (B, h, w) for the inputs given
    """
    affine = uncrop_affine_from_bbox(bbox_centres, bbox_heights, bbox_widths,
                                     (float(output_wh[0]), float(output_wh[1])))
    oh, ow = int(uncrop_wh[1]), int(uncrop_wh[0])
    out = {}
    if iuv is not None:
        out["iuv"] = affine_resample(iuv, affine, (oh, ow), mode="nearest",
                                     pad_val=out_of_frame_pad_val)
    if rgb is not None:
        out["rgb"] = affine_resample(rgb, affine, (oh, ow))
    if seg is not None:
        out["seg"] = affine_resample(seg[:, None], affine, (oh, ow),
                                     mode="nearest")[:, 0]
    return out
