"""Proxy-representation augmentation: body-part removal, occlusion, joint
noise, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/augmentation/
proxy_rep_augmentation.py (random_joints2D_deviation :28,
random_remove_bodyparts :44, random_remove_joints2D :72,
random_swap_joints2D :83, random_occlude_box :95, _occlude_half :115, the
three halves :157-172, augment_proxy_representation :175,
random_extreme_crop :213): batched masks in place of per-example loops,
every draw from a utils/random_draws.py source split as the JAX functions
split their keys.
"""

import torch

from hp3d_bench.reference.utils.label_conversions import (
    TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP)


def random_joints2D_deviation(draws, joints2D,
                              delta_j2d_dev_range=(-5, 5),
                              delta_j2d_hip_dev_range=(-15, 15)):
    """Uniform jitter on 2D joints; the hips (11, 12) take their own range."""
    B, K, _ = joints2D.shape
    draws_o, draws_h = draws.split(2)
    dev = draws_o.uniform((B, K, 2), *delta_j2d_dev_range)
    hip_dev = draws_h.uniform((B, 2, 2), *delta_j2d_hip_dev_range)
    dev[:, [11, 12]] = hip_dev
    return joints2D + dev


def random_remove_bodyparts(draws, seg, classes_to_remove,
                            probabilities_to_remove_classes,
                            joints2D_visib=None,
                            probability_to_remove_joints=0.5):
    """Randomly zero whole body-part classes, and with them hide the
    linked joints with probability_to_remove_joints.

    :param seg: (B, wh, wh) 24-part seg
    :param joints2D_visib: (B, 17) bool or None
    """
    B = seg.shape[0]
    n = len(classes_to_remove)
    draws_cls, draws_joints = draws.split(2)
    probs = torch.as_tensor(probabilities_to_remove_classes, dtype=torch.float32,
                            device=seg.device)
    remove = draws_cls.uniform((n, B)) < probs[:, None]             # (n, B)
    joint_rand = draws_joints.uniform((n, B)) < probability_to_remove_joints
    if joints2D_visib is not None:
        joints2D_visib = joints2D_visib.clone()
    for i, cls in enumerate(classes_to_remove):
        seg = torch.where(remove[i][:, None, None] & (seg == cls),
                          torch.zeros_like(seg), seg)
        if joints2D_visib is not None and cls in TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP:
            joint = TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP[cls]
            joints2D_visib[:, joint] &= ~(remove[i] & joint_rand[i])
    return seg, joints2D_visib


def random_remove_joints2D(draws, joints2D_visib, joints_to_remove,
                           probability_to_remove=0.1):
    """Randomly hide specific joints."""
    B = joints2D_visib.shape[0]
    rand = draws.uniform((len(joints_to_remove), B)) < probability_to_remove
    joints2D_visib = joints2D_visib.clone()
    for i, joint in enumerate(joints_to_remove):
        joints2D_visib[:, joint] &= ~rand[i]
    return joints2D_visib


def random_swap_joints2D(draws, joints2D, joints_to_swap, swap_probability=0.1):
    """Randomly swap left/right joint pairs."""
    B = joints2D.shape[0]
    rand = draws.uniform((len(joints_to_swap), B)) < swap_probability
    for i, (a, b) in enumerate(joints_to_swap):
        swap = rand[i][:, None]
        ja = torch.where(swap, joints2D[:, b], joints2D[:, a])
        jb = torch.where(swap, joints2D[:, a], joints2D[:, b])
        joints2D = joints2D.clone()
        joints2D[:, a] = ja
        joints2D[:, b] = jb
    return joints2D


def random_occlude_box(draws, seg, occlude_probability=0.2, occlude_box_dim=32.0):
    """Zero a random square box near the image centre."""
    B, H, W = seg.shape
    draws_p, draws_x, draws_y = draws.split(3)
    apply = draws_p.uniform((B,)) < occlude_probability
    centre = W / 2.0
    lo, hi = centre - 0.3 * W / 2.0, centre + 0.3 * W / 2.0
    cx = draws_x.uniform((B,), lo, hi)
    cy = draws_y.uniform((B,), lo, hi)
    x1 = (cx - occlude_box_dim / 2).to(torch.int32)
    x2 = (cx + occlude_box_dim / 2).to(torch.int32)
    y1 = (cy - occlude_box_dim / 2).to(torch.int32)
    y2 = (cy + occlude_box_dim / 2).to(torch.int32)
    rows = torch.arange(H, device=seg.device)[None, :, None]
    cols = torch.arange(W, device=seg.device)[None, None, :]
    in_box = ((rows >= x1[:, None, None]) & (rows < x2[:, None, None])
              & (cols >= y1[:, None, None]) & (cols < y2[:, None, None]))
    return torch.where(apply[:, None, None] & in_box, torch.zeros_like(seg), seg)


def _occlude_half(draws, img, joints2D, joints2D_visib, occlude_probability,
                  axis, jitter_div):
    """Shared bottom/top/vertical half-occlusion.

    axis: 'bottom' (rows >= t), 'top' (rows < t), 'vertical' (a random
    side of column t). img: (B, wh, wh) seg or (B, 3, wh, wh) rgb.
    """
    B = img.shape[0]
    wh = img.shape[-1]
    draws_p, draws_t, draws_side = draws.split(3)
    apply = draws_p.uniform((B,)) < occlude_probability
    jit = wh // jitter_div
    t = wh // 2 + draws_t.randint((B,), -jit, jit)

    rows = torch.arange(wh, device=img.device)
    if axis == "bottom":
        mask2d = rows[None, :, None] >= t[:, None, None]
        jmask = joints2D[..., 1] > t[:, None]
    elif axis == "top":
        mask2d = rows[None, :, None] < t[:, None, None]
        jmask = joints2D[..., 1] < t[:, None]
    else:
        side = draws_side.uniform((B,)) > 0.5
        left = rows[None, None, :] < t[:, None, None]              # columns
        mask2d = torch.where(side[:, None, None], left, ~left)
        jmask = torch.where(side[:, None], joints2D[..., 0] < t[:, None],
                            joints2D[..., 0] > t[:, None])

    full = apply[:, None, None] & mask2d
    if img.ndim == 4:
        full = full[:, None]
    img = torch.where(full, torch.zeros_like(img), img)
    joints2D_visib = joints2D_visib & ~(apply[:, None] & jmask)
    return img, joints2D, joints2D_visib


def random_occlude_bottom_half(draws, img, joints2D, joints2D_visib,
                               occlude_probability=0.05):
    return _occlude_half(draws, img, joints2D, joints2D_visib,
                         occlude_probability, "bottom", 5)


def random_occlude_top_half(draws, img, joints2D, joints2D_visib,
                            occlude_probability=0.05):
    return _occlude_half(draws, img, joints2D, joints2D_visib,
                         occlude_probability, "top", 5)


def random_occlude_vertical_half(draws, img, joints2D, joints2D_visib,
                                 occlude_probability=0.05):
    return _occlude_half(draws, img, joints2D, joints2D_visib,
                         occlude_probability, "vertical", 30)


def augment_proxy_representation(draws, seg, joints2D, joints2D_visib,
                                 proxy_rep_augment_config):
    """The whole proxy-representation augmentation."""
    cfg = proxy_rep_augment_config
    d = draws.split(7)
    seg, joints2D_visib = random_remove_bodyparts(
        d[0], seg,
        classes_to_remove=cfg.REMOVE_PARTS_CLASSES,
        probabilities_to_remove_classes=cfg.REMOVE_PARTS_PROBS,
        joints2D_visib=joints2D_visib,
        probability_to_remove_joints=cfg.REMOVE_APPENDAGE_JOINTS_PROB)
    seg = random_occlude_box(d[1], seg, occlude_probability=cfg.OCCLUDE_BOX_PROB,
                             occlude_box_dim=cfg.OCCLUDE_BOX_DIM)
    joints2D = random_swap_joints2D(d[2], joints2D,
                                    joints_to_swap=cfg.JOINTS_TO_SWAP,
                                    swap_probability=cfg.JOINTS_SWAP_PROB)
    # The same range for the hips, as the JAX package and the reference do.
    joints2D = random_joints2D_deviation(d[3], joints2D,
                                         delta_j2d_dev_range=cfg.DELTA_J2D_DEV_RANGE,
                                         delta_j2d_hip_dev_range=cfg.DELTA_J2D_DEV_RANGE)
    joints2D_visib = random_remove_joints2D(d[4], joints2D_visib,
                                            joints_to_remove=cfg.REMOVE_JOINTS_INDICES,
                                            probability_to_remove=cfg.REMOVE_JOINTS_PROB)
    seg, joints2D, joints2D_visib = random_occlude_bottom_half(
        d[5], seg, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_BOTTOM_PROB)
    draws_top, draws_vert = d[6].split(2)
    seg, joints2D, joints2D_visib = random_occlude_top_half(
        draws_top, seg, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_TOP_PROB)
    seg, joints2D, joints2D_visib = random_occlude_vertical_half(
        draws_vert, seg, joints2D, joints2D_visib,
        occlude_probability=cfg.OCCLUDE_VERTICAL_PROB)
    return seg, joints2D, joints2D_visib


def random_extreme_crop(draws, seg, extreme_crop_probability=0.05):
    """Remove the legs (classes 5-14), or the legs and arms (3-14, 19-22),
    from the seg before the box is taken from it."""
    B = seg.shape[0]
    rand = draws.uniform((B,))
    legs_only = rand < extreme_crop_probability * 0.5
    legs_arms = ((rand > extreme_crop_probability * 0.5)
                 & (rand < extreme_crop_probability))
    seg_idx = seg.to(torch.int32)
    is_leg = (seg_idx >= 5) & (seg_idx <= 14)
    is_leg_arm = (((seg_idx >= 3) & (seg_idx <= 14))
                  | ((seg_idx >= 19) & (seg_idx <= 22)))
    zero = torch.zeros_like(seg)
    seg = torch.where(legs_only[:, None, None] & is_leg, zero, seg)
    return torch.where(legs_arms[:, None, None] & is_leg_arm, zero, seg)
