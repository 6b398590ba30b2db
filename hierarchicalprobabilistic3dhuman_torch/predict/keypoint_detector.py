"""Person localisation by HRNet keypoint bootstrap, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/predict/keypoint_detector.py
(_build_stage :59-126, _box_from_kps :128, _effective_threshold :152,
_refine :169, make_keypoint_bootstrap_detector :205, _cluster_peaks :266,
_iou_xyxy :308, make_multi_person_bootstrap_detector :317). Person boxes
come from the 2D keypoint model the pipeline already carries, not from a
separate detector with weights of its own:

  1. run HRNet on the whole frame (aspect-fixed full-image crop);
  2. take the bounding box of the confident keypoints, mapped back to
     original-image coordinates through the same crop affine;
  3. expand it by anatomical margins (COCO keypoints stop at nose and
     ankles) and run again on the refined crop.

The multi-person detector takes the top-K local heatmap maxima per joint
from the whole-frame pass, clusters them greedily into skeleton seeds (at
most one peak per joint channel per cluster), refines each seed on its own
and merges the results by box-IoU NMS.

Both return the torchvision-style dict that make_hrnet_batch_predictor's
`object_detect_fn` interface expects ({boxes xyxy, labels, scores}).
"""

import numpy as np
import torch
import torch.nn.functional as F

from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
    IMAGENET_MEAN, IMAGENET_STD, _as_float_rgb,
    get_kp_locations_confs_from_heatmaps)
from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_crop_affine)

_MIN_BOX_EXT = 8.0   # px; least box extent when keypoints all but coincide


def _build_stage(hrnet, hrnet_config, device):
    """The crop -> HRNet -> keypoints-in-the-original-image stage.

    :return: (stage, peaks_stage_factory) where `stage(image, centre, height,
        width) -> (kp_orig (K, 2), confs (K,))` is the argmax path and
        `peaks_stage_factory(P)` builds the top-P local-maxima variant
        `-> (kp_orig (K, P, 2), confs (K, P))`; both return host numpy
    """
    in_w, in_h = hrnet_config.MODEL.IMAGE_SIZE  # (288, 384)
    kp_rescale = in_w / float(hrnet_config.MODEL.HEATMAP_SIZE[0])
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=device)[:, None, None]

    def run_hrnet(image, centre, height, width):
        crop = batch_crop_affine(
            (in_w, in_h), rgb=_as_float_rgb(image)[None],
            bbox_centres=torch.as_tensor(centre, dtype=torch.float32,
                                         device=device)[None],
            bbox_heights=torch.tensor([height], dtype=torch.float32,
                                      device=device),
            bbox_widths=torch.tensor([width], dtype=torch.float32,
                                     device=device),
            orig_scale_factor=1.0)          # margins handle the context pad
        heatmaps = hrnet(((crop["rgb"][0] - mean) / std)[None])
        return crop, heatmaps

    def to_orig(crop, kp):
        """crop-resolution keypoints (..., 2) -> original-image px through
        the same (aspect-fixed) box the affine used:
        orig = centre + (p - out/2) * (box_extent / out)."""
        kp = kp * kp_rescale
        bw = crop["bbox_widths"][0]
        bh = crop["bbox_heights"][0]
        cx = crop["bbox_centres"][0, 1]
        cy = crop["bbox_centres"][0, 0]
        x = cx + (kp[..., 0] - in_w * 0.5) * (bw / in_w)
        y = cy + (kp[..., 1] - in_h * 0.5) * (bh / in_h)
        return torch.stack([x, y], dim=-1)

    @torch.inference_mode()
    def stage(image, centre, height, width):
        crop, heatmaps = run_hrnet(image, centre, height, width)
        joints2D, confs = get_kp_locations_confs_from_heatmaps(heatmaps)
        return (to_orig(crop, joints2D[0]).cpu().numpy(),
                confs[0].cpu().numpy())

    def peaks_stage_factory(P):
        @torch.inference_mode()
        def peaks_stage(image, centre, height, width):
            crop, hm = run_hrnet(image, centre, height, width)
            # Per-channel top-P local maxima: a peak is a cell equal to the
            # max of its 3x3 neighbourhood (plateau ties count as peaks;
            # clustering dedups them spatially). Equal values rank by flat
            # index, lower first, as lax.top_k ranks them (torch.topk leaves
            # their order open), hence a stable sort.
            pooled = F.max_pool2d(hm, 3, stride=1, padding=1)
            K, h, w = hm.shape[1], hm.shape[2], hm.shape[3]
            masked = torch.where(hm >= pooled, hm, -torch.inf)
            confs, idx = torch.sort(masked.reshape(K, h * w), dim=-1,
                                    descending=True, stable=True)
            confs, idx = confs[:, :P], idx[:, :P]                # (K, P)
            kp = torch.stack([(idx % w).to(torch.float32),
                              (idx // w).to(torch.float32)], dim=-1)
            return (to_orig(crop, kp).cpu().numpy(), confs.cpu().numpy())

        return peaks_stage

    return stage, peaks_stage_factory


def _box_from_kps(kp, vis, H, W, margins):
    """Confident-keypoint bbox -> margin-expanded, clamped (x0, y0, x1, y1)."""
    x0, x1 = kp[vis, 0].min(), kp[vis, 0].max()
    y0, y1 = kp[vis, 1].min(), kp[vis, 1].max()
    h, w = y1 - y0, x1 - x0
    top, bottom, sides = margins
    x0, x1 = x0 - sides * w, x1 + sides * w
    y0, y1 = y0 - top * h, y1 + bottom * h
    x0, y0 = max(0.0, float(x0)), max(0.0, float(y0))
    x1, y1 = min(float(W), float(x1)), min(float(H), float(y1))
    # Near-collinear or coincident keypoints can collapse the box to ~zero
    # extent, a degenerate affine for the re-crop: clamp to a minimum,
    # centred.
    if x1 - x0 < _MIN_BOX_EXT:
        cx = (x0 + x1) / 2.0
        x0 = max(0.0, cx - _MIN_BOX_EXT / 2.0)
        x1 = min(float(W), x0 + _MIN_BOX_EXT)
    if y1 - y0 < _MIN_BOX_EXT:
        cy = (y0 + y1) / 2.0
        y0 = max(0.0, cy - _MIN_BOX_EXT / 2.0)
        y1 = min(float(H), y0 + _MIN_BOX_EXT)
    return x0, y0, x1, y1


def _effective_threshold(confs, conf_threshold, conf_floor, rel_conf_frac):
    """Amplitude-adaptive visibility threshold:
    clip(rel_conf_frac * max_conf, conf_floor, conf_threshold).

    Heatmap peak amplitude is a property of the model, not of the scene, so
    a fixed cut would reject every detection of a weak-amplitude model; the
    clip keeps `conf_threshold` for strong models and `conf_floor` as the
    noise floor.
    """
    return float(np.clip(rel_conf_frac * float(confs.max()),
                         conf_floor, conf_threshold))


def _refine(stage, image, H, W, centre, height, width, n_iters,
            conf_threshold, min_visible, margins, conf_floor, rel_conf_frac):
    """Iterated crop -> HRNet -> confident-keypoint box from a starting crop.

    :return: the last (x0, y0, x1, y1, confs, eff_thr) that had
        `min_visible` confident keypoints, or None if no pass had (a later
        pass that loses the subject keeps the earlier box)
    """
    accepted = None
    for _ in range(max(1, int(n_iters))):
        kp, confs = stage(image, centre, height, width)
        eff = _effective_threshold(confs, conf_threshold, conf_floor,
                                   rel_conf_frac)
        vis = confs > eff
        if vis.sum() < min_visible:
            break
        x0, y0, x1, y1 = _box_from_kps(kp, vis, H, W, margins)
        accepted = (x0, y0, x1, y1, confs, eff)
        centre = np.array([(y0 + y1) / 2.0, (x0 + x1) / 2.0], np.float32)
        height, width = y1 - y0, x1 - x0
    return accepted


def _empty_detections():
    return {"boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "scores": np.zeros((0,), np.float32)}


def _as_image(image, device):
    """A detector's input, numpy or tensor (3, H, W), as a tensor on the
    HRNet's device."""
    if isinstance(image, np.ndarray):
        image = np.ascontiguousarray(image)
    return torch.as_tensor(image, device=device)


def make_keypoint_bootstrap_detector(hrnet, hrnet_config, device,
                                     conf_threshold=0.3,
                                     min_visible=6,
                                     n_iters=2,
                                     margins=(0.25, 0.10, 0.125),
                                     conf_floor=0.1,
                                     rel_conf_frac=0.35):
    """An `object_detect_fn`-compatible single-person detector from HRNet.

    :param hrnet: callable (B, 3, 384, 288) normalised -> (B, 17, 96, 72) on
        `device`
    :param conf_threshold: heatmap peak value below which a keypoint is
        invisible, for strong-amplitude models; the threshold applied is
        `_effective_threshold`'s
    :param min_visible: fewer confident keypoints than this -> no detection
        (the caller falls back to the whole frame)
    :param n_iters: localisation passes (1 = whole-frame pass only)
    :param margins: (top, bottom, sides) expansion as fractions of the raw
        keypoint box's height/width
    :param conf_floor: peaks below this never count
    :param rel_conf_frac: fraction of the image's strongest peak that other
        peaks must reach
    :return: callable image (3, H, W) float [0, 1] (tensor or numpy) ->
        {"boxes": (N, 4) xyxy, "labels": (N,), "scores": (N,)}
    """
    stage, _ = _build_stage(hrnet, hrnet_config, device)

    def detect(image):
        image = _as_image(image, device)
        H, W = int(image.shape[1]), int(image.shape[2])
        accepted = _refine(
            stage, image, H, W,
            centre=np.array([H / 2.0, W / 2.0], np.float32),
            height=float(H), width=float(W),
            n_iters=n_iters, conf_threshold=conf_threshold,
            min_visible=min_visible, margins=margins,
            conf_floor=conf_floor, rel_conf_frac=rel_conf_frac)
        if accepted is None:
            return _empty_detections()
        x0, y0, x1, y1, confs, eff = accepted
        # Acceptance happens here (>= min_visible confident keypoints), not
        # through the caller's score threshold: keypoint confidences are not
        # calibrated like detector scores, so an accepted box scores 1.0 and
        # the mean keypoint confidence rides along.
        raw = float(confs[confs > eff].mean())
        return {"boxes": np.array([[x0, y0, x1, y1]], np.float32),
                "labels": np.array([1], np.int64),       # COCO person
                "scores": np.array([1.0], np.float32),
                "kp_mean_conf": np.array([raw], np.float32)}

    return detect


def _cluster_peaks(kp, confs, conf_threshold, radius):
    """Greedy spatial clustering of per-joint heatmap peaks into skeleton
    seeds: strongest first, each to the nearest cluster centroid within
    `radius`, at most one peak per joint channel per cluster.

    :param kp: (K, P, 2) peak xy in original-image px
    :param confs: (K, P)
    :return: list of clusters, each {"pts": (n, 2), "confs": (n,), "chan",
        "cx", "cy"}, sorted by total confidence, descending
    """
    K, P = confs.shape
    entries = [(float(confs[k, p]), k, float(kp[k, p, 0]), float(kp[k, p, 1]))
               for k in range(K) for p in range(P)
               if confs[k, p] > conf_threshold]
    entries.sort(key=lambda e: -e[0])
    clusters = []
    for c, k, x, y in entries:
        best, best_d = None, radius
        for cl in clusters:
            if k in cl["chan"]:
                continue
            d = np.hypot(x - cl["cx"], y - cl["cy"])
            if d < best_d:
                best, best_d = cl, d
        if best is None:
            clusters.append({"pts": [(x, y)], "confs": [c], "chan": {k}})
        else:
            best["pts"].append((x, y))
            best["confs"].append(c)
            best["chan"].add(k)
        cl = best if best is not None else clusters[-1]
        w = np.asarray(cl["confs"])
        pts = np.asarray(cl["pts"])
        cl["cx"], cl["cy"] = (pts * (w / w.sum())[:, None]).sum(axis=0)
    for cl in clusters:
        cl["pts"] = np.asarray(cl["pts"], np.float32)
        cl["confs"] = np.asarray(cl["confs"], np.float32)
    clusters.sort(key=lambda cl: -float(cl["confs"].sum()))
    return clusters


def _iou_xyxy(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def make_multi_person_bootstrap_detector(hrnet, hrnet_config, device,
                                         conf_threshold=0.3,
                                         min_visible=6,
                                         max_people=4,
                                         n_iters=2,
                                         margins=(0.25, 0.10, 0.125),
                                         cluster_radius_frac=0.18,
                                         min_seed_joints=3,
                                         seed_min_frac=0.15,
                                         nms_iou=0.55,
                                         conf_floor=0.1,
                                         rel_conf_frac=0.35):
    """N-person keypoint bootstrap.

    The whole-frame pass takes up to `max_people` local maxima per joint
    channel; greedy clustering groups them into skeleton seeds (radius
    `cluster_radius_frac` * max(H, W)); each seed with >= `min_seed_joints`
    channels gets its own `n_iters` refinement from its peak box (floored to
    `seed_min_frac` of the frame); duplicates are merged by IoU NMS, the
    strongest mean keypoint confidence first.

    Cost: 1 peaks pass + (n_clusters * n_iters) HRNet passes per image.

    :return: callable image (3, H, W) float [0, 1] (tensor or numpy) ->
        {"boxes": (N, 4) xyxy, "labels": (N,), "scores": (N,)}
    """
    stage, peaks_factory = _build_stage(hrnet, hrnet_config, device)
    peaks_stage = peaks_factory(int(max_people))

    def detect(image):
        image = _as_image(image, device)
        H, W = int(image.shape[1]), int(image.shape[2])
        kp, confs = peaks_stage(image, np.array([H / 2.0, W / 2.0], np.float32),
                                float(H), float(W))
        eff0 = _effective_threshold(confs, conf_threshold, conf_floor,
                                    rel_conf_frac)
        clusters = _cluster_peaks(kp, confs, eff0,
                                  radius=cluster_radius_frac * max(H, W))
        clusters = [c for c in clusters if len(c["chan"]) >= min_seed_joints]

        boxes, raws = [], []
        for cl in clusters:
            pts = cl["pts"]
            x0, y0 = pts.min(axis=0)
            x1, y1 = pts.max(axis=0)
            # Seed crop: peak box + margins, floored to seed_min_frac of the
            # frame (a 3-joint seed can be a tiny cloud).
            top, bottom, sides = margins
            h, w = y1 - y0, x1 - x0
            hh = max((1 + top + bottom) * h, seed_min_frac * H, _MIN_BOX_EXT)
            ww = max((1 + 2 * sides) * w, seed_min_frac * W, _MIN_BOX_EXT)
            centre = np.array([(y0 + y1) / 2.0, (x0 + x1) / 2.0], np.float32)
            accepted = _refine(
                stage, image, H, W,
                centre=centre, height=float(hh), width=float(ww),
                n_iters=n_iters, conf_threshold=conf_threshold,
                min_visible=min_visible, margins=margins,
                conf_floor=conf_floor, rel_conf_frac=rel_conf_frac)
            if accepted is None:
                continue
            bx0, by0, bx1, by1, rconfs, reff = accepted
            boxes.append((bx0, by0, bx1, by1))
            raws.append(float(rconfs[rconfs > reff].mean()))

        # Greedy IoU NMS, strongest mean keypoint confidence first.
        order = np.argsort(-np.asarray(raws)) if raws else []
        kept, kept_raw = [], []
        for i in order:
            if len(kept) >= max_people:
                break
            if all(_iou_xyxy(boxes[i], kb) < nms_iou for kb in kept):
                kept.append(boxes[i])
                kept_raw.append(raws[i])
        if not kept:
            return _empty_detections()
        n = len(kept)
        return {"boxes": np.asarray(kept, np.float32),
                "labels": np.ones((n,), np.int64),       # COCO person
                "scores": np.ones((n,), np.float32),
                "kp_mean_conf": np.asarray(kept_raw, np.float32)}

    return detect
