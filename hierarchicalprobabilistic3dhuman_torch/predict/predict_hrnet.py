"""HRNet 2D keypoints for one image, whole-image box (cropped inputs).

Counterpart of hierarchicalprobabilistic3dhuman_tpu/predict/predict_hrnet.py
(get_kp_locations_confs_from_heatmaps :24, select_centremost_person_box :40
without a detector, make_hrnet_predictor :89 with ImageNet normalisation
:20-21).
"""

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_crop_affine)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_kp_locations_confs_from_heatmaps(batch_heatmaps):
    """Argmax keypoints + confidences.

    :param batch_heatmaps: (B, K, h, w)
    :return: kps (B, K, 2) [x, y] (0 where conf <= 0), confs (B, K)
    """
    B, K, h, w = batch_heatmaps.shape
    max_confs, max_idx = torch.max(batch_heatmaps.reshape(B, K, -1), dim=-1)
    x = (max_idx % w).to(torch.float32)
    y = torch.floor(max_idx.to(torch.float32) / float(w))
    kps = torch.stack([x, y], dim=-1)
    return kps * (max_confs > 0.0)[..., None], max_confs


def select_centremost_person_box(image_hw):
    """Whole-image box for already-cropped inputs.

    :return: (centre (2,) [vert, hor], height, width)
    """
    H, W = image_hw
    return np.array([H / 2.0, W / 2.0], np.float32), float(H), float(W)


def make_hrnet_predictor(hrnet, hrnet_config, device, bbox_scale_factor=1.2):
    """Per-image keypoint predictor: whole-image box -> aspect fix -> 384x288
    crop -> normalise -> HRNet -> heatmap argmax.

    :param hrnet: PoseHighResolutionNet on `device`, in eval mode
    :return: predict(image uint8 (H, W, 3) RGB numpy) -> dict joints2D
        (17, 2), joints2Dconfs (17,), cropped_image (3, 384, 288) [0, 1],
        bbox_centre (2,), bbox_height, bbox_width
    """
    in_w, in_h = hrnet_config.MODEL.IMAGE_SIZE  # (288, 384)
    aspect = float(in_h) / float(in_w)
    kp_rescale = in_w / float(hrnet_config.MODEL.HEATMAP_SIZE[0])
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=device)[:, None, None]

    @torch.inference_mode()
    def predict(image):
        H, W = image.shape[:2]
        centre, height, width = select_centremost_person_box((H, W))
        if height > width * aspect:
            width = height / aspect
        elif height < width * aspect:
            height = width * aspect
        rgb = torch.as_tensor(np.ascontiguousarray(image), device=device)
        rgb = (rgb.permute(2, 0, 1).to(torch.float32) / 255.0)[None]
        cropped = batch_crop_affine(
            (in_w, in_h), rgb=rgb,
            bbox_centres=torch.as_tensor(centre, device=device)[None],
            bbox_heights=torch.tensor([height], device=device),
            bbox_widths=torch.tensor([width], device=device),
            orig_scale_factor=bbox_scale_factor)["rgb"][0]
        heatmaps = hrnet(((cropped - mean) / std)[None])
        joints2D, confs = get_kp_locations_confs_from_heatmaps(heatmaps)
        return {"joints2D": joints2D[0] * kp_rescale,
                "joints2Dconfs": confs[0],
                "cropped_image": cropped,
                "bbox_centre": centre,
                "bbox_height": float(height),
                "bbox_width": float(width)}

    return predict
