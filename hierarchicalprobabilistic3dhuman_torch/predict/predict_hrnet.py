"""HRNet 2D-pose prediction with a pluggable person-box detector, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/predict/predict_hrnet.py
(get_kp_locations_confs_from_heatmaps :24, select_centremost_person_box :40,
_as_float_rgb :72, make_hrnet_batch_predictor :168, ImageNet normalisation
:20-21); its per-image entry points (:89, :258) are this batch predictor on
a batch of one. The detector is an interface: any callable `image (3, H,
W) float [0, 1] -> dict(boxes (N, 4) xyxy, labels (N,), scores (N,))`,
such as the keypoint bootstrap detectors of predict/keypoint_detector.py,
or None for the whole image (cropped inputs).
"""

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import span
from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_crop_affine, convert_bbox_corners_to_centre_hw)

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


def select_centremost_person_box(detections, image_hw, threshold=0.8):
    """Centre-most person box scoring above `threshold`, whole image
    fallback. Host-side numpy (detector outputs are host data).

    :param detections: dict with boxes (N, 4) xyxy, labels (N,), scores (N,)
        or None
    :return: (centre (2,) [vert, hor], height, width)
    """
    H, W = image_hw
    if detections is not None:
        boxes = np.asarray(detections["boxes"], np.float32)
        labels = np.asarray(detections["labels"])
        scores = np.asarray(detections["scores"], np.float32)
        boxes = boxes[(labels == 1) & (scores > threshold)]
        if boxes.shape[0] > 0:
            corners = torch.from_numpy(boxes[:, [1, 0, 3, 2]])  # (vert, hor)
            centres, heights, widths = (a.numpy() for a in
                                        convert_bbox_corners_to_centre_hw(corners))
            dists = (centres[:, 0] - H / 2.0) ** 2 + (centres[:, 1] - W / 2.0) ** 2
            i = int(np.argmin(dists))
            return centres[i], float(heights[i]), float(widths[i])
        print("Could not find person bounding box - using entire image!")
    return np.array([H / 2.0, W / 2.0], np.float32), float(H), float(W)


def _is_nhwc(images):
    """True for a (B, H, W, 3) batch (vs the canonical (B, 3, H, W))."""
    return images.ndim == 4 and images.shape[-1] == 3 and images.shape[1] != 3


def _as_float_rgb(images):
    """uint8 [0, 255] -> float32 [0, 1] and NHWC -> NCHW, on the tensor's
    device; float NCHW inputs pass through. Decoded photos are uint8 HWC, so
    they travel to the card as such, 4x smaller than float32."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    if _is_nhwc(images):
        images = images.permute(0, 3, 1, 2)
    return images


def _fix_box_aspect(height, width, aspect):
    """Grow the box's smaller side to the HRNet input's aspect (h / w), in
    host floats as the JAX package does before the float32 crop."""
    if height > width * aspect:
        width = height / aspect
    elif height < width * aspect:
        height = width * aspect
    return height, width


def make_hrnet_batch_predictor(hrnet, hrnet_config, device,
                               bbox_scale_factor=1.2):
    """Keypoints for B same-resolution images: per image, a person box
    (detector or whole image, selected on the host) and its aspect fix; then
    one 384x288 crop + normalise + HRNet + heatmap argmax for the batch.

    :param hrnet: callable (B, 3, 384, 288) normalised -> (B, 17, 96, 72) on
        `device`: a PoseHighResolutionNet in eval mode, or its bfloat16
        wrapper (utils/precision.py)
    :return: predict_batch(images, object_detect_fn=None,
        object_detect_threshold=0.8) -> dict joints2D (B, 17, 2),
        joints2Dconfs (B, 17), cropped_image (B, 3, 384, 288), and numpy
        bbox_centres (B, 2) float32, bbox_heights (B,), bbox_widths (B,)
        float64. `images` is (B, H, W, 3) uint8 (the cheap upload) or
        (B, 3, H, W) float [0, 1], on `device`.
    """
    in_w, in_h = hrnet_config.MODEL.IMAGE_SIZE  # (288, 384)
    aspect = float(in_h) / float(in_w)
    kp_rescale = in_w / float(hrnet_config.MODEL.HEATMAP_SIZE[0])
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=device)[:, None, None]

    @torch.inference_mode()
    def predict_batch(images, object_detect_fn=None,
                      object_detect_threshold=0.8):
        with span("predict.hrnet"):
            rgb = _as_float_rgb(images)
            B, _, H, W = rgb.shape
            centres = np.empty((B, 2), np.float32)
            # Box sizes stay in host floats, as JAX's per-image predictor
            # returns them; the crop rounds them to float32.
            heights = np.empty((B,), np.float64)
            widths = np.empty((B,), np.float64)
            for i in range(B):
                det = (object_detect_fn(rgb[i]) if object_detect_fn is not None
                       else None)
                c, h, w = select_centremost_person_box(
                    det, (H, W), threshold=object_detect_threshold)
                h, w = _fix_box_aspect(h, w, aspect)
                centres[i], heights[i], widths[i] = c, h, w

            cropped = batch_crop_affine(
                (in_w, in_h), rgb=rgb,
                bbox_centres=torch.as_tensor(centres, device=device),
                bbox_heights=torch.as_tensor(heights, dtype=torch.float32,
                                             device=device),
                bbox_widths=torch.as_tensor(widths, dtype=torch.float32,
                                            device=device),
                orig_scale_factor=bbox_scale_factor)["rgb"]
            heatmaps = hrnet((cropped - mean) / std)
            joints2D, confs = get_kp_locations_confs_from_heatmaps(heatmaps)
            return {"joints2D": joints2D * kp_rescale, "joints2Dconfs": confs,
                    "cropped_image": cropped, "bbox_centres": centres,
                    "bbox_heights": heights, "bbox_widths": widths}

    return predict_batch
