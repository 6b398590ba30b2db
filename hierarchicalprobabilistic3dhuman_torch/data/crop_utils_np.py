"""Host-side (numpy + cv2) crop used by dataset loading workers.

Same bbox/affine semantics as utils/image_utils.batch_crop_affine (and the
reference's batch_crop_opencv_affine :62-231), but runs on the CPU during data
loading where cv2.warpAffine is the right tool — device code should not be in
the input pipeline's per-item path.
"""

import numpy as np
import cv2


def crop_opencv_affine(output_wh,
                       rgb=None,
                       seg=None,
                       joints2D=None,
                       bbox_centre=None,
                       bbox_wh=None,
                       bbox_height=None,
                       bbox_width=None,
                       orig_scale_factor=1.2):
    """Crop a single example around a bbox (centre in (vert, hor) coords).

    :param rgb: (3, H, W) float or uint8
    :param seg: (H, W)
    :param joints2D: (K, 2) [x, y]
    :return: dict with cropped arrays resized to output_wh
    """
    out_w, out_h = int(output_wh[0]), int(output_wh[1])
    if bbox_wh is not None:
        bbox_height = bbox_width = float(bbox_wh)

    # Aspect-ratio fix
    aspect = out_h / out_w
    if bbox_height > bbox_width * aspect:
        bbox_width = bbox_height / aspect
    elif bbox_height < bbox_width * aspect:
        bbox_height = bbox_width * aspect
    bbox_height *= orig_scale_factor
    bbox_width *= orig_scale_factor

    affine = np.zeros((2, 3), np.float32)
    affine[0, 0] = out_w / bbox_width
    affine[1, 1] = out_h / bbox_height
    affine[0, 2] = out_w * 0.5 - affine[0, 0] * bbox_centre[1]
    affine[1, 2] = out_h * 0.5 - affine[1, 1] * bbox_centre[0]

    out = {"affine_trans": affine}
    if rgb is not None:
        warped = cv2.warpAffine(np.transpose(np.asarray(rgb), (1, 2, 0)), affine,
                                (out_w, out_h), flags=cv2.INTER_LINEAR,
                                borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        out["rgb"] = np.transpose(warped, (2, 0, 1))
    if seg is not None:
        out["seg"] = cv2.warpAffine(np.asarray(seg), affine, (out_w, out_h),
                                    flags=cv2.INTER_NEAREST,
                                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    if joints2D is not None:
        homo = np.concatenate([joints2D, np.ones((joints2D.shape[0], 1))], axis=-1)
        out["joints2D"] = homo @ affine.T
    return out
