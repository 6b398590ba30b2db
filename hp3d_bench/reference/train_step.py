"""The reference training step: the synthetic stage, the predictor's
forward and loss, backward and Adam, on one device.

A frozen copy of the port's train/train_pose_mf_shape_gaussian_net.py
(`make_synth_data_fn`, `TrainStep.forward_loss` and `__call__` for a
train split) without the parallel mesh and the metric sums, over the
reference's own modules: its renderer rasterizes with plain torch ops.
"""

import numpy as np
import torch

from hp3d_bench.reference.losses import PoseMFShapeGaussianLoss
from hp3d_bench.reference.ops.bingham_sampling import (
    pose_matrix_fisher_sampling, shape_gaussian_sampling)
from hp3d_bench.reference.utils.augmentation.cam_augmentation import augment_cam_t
from hp3d_bench.reference.utils.augmentation.lighting_augmentation import (
    augment_light)
from hp3d_bench.reference.utils.augmentation.proxy_rep_augmentation import (
    augment_proxy_representation, random_extreme_crop)
from hp3d_bench.reference.utils.augmentation.rgb_augmentation import augment_rgb
from hp3d_bench.reference.utils.augmentation.smpl_augmentation import (
    normal_sample_shape)
from hp3d_bench.reference.utils.cam_utils import (
    orthographic_project, perspective_project)
from hp3d_bench.reference.utils.image_utils import (
    batch_add_rgb_background, batch_crop_affine)
from hp3d_bench.reference.utils.joints2d_utils import (
    check_joints2d_occluded, check_joints2d_visibility)
from hp3d_bench.reference.utils.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP, ALL_JOINTS_TO_H36M_MAP, H36M_TO_J14,
    convert_2Djoints_to_gaussian_heatmaps_batched,
    convert_densepose_seg_to_14part_labels)
from hp3d_bench.reference.utils.rotation_utils import (
    aa_rotate_translate_points, batch_rodrigues, rot6d_to_rotmat, so3_exp)

X_AXIS = (1.0, 0.0, 0.0)
ZERO_T = (0.0, 0.0, 0.0)
# The H36M joints of the 14 3D-error joints, in the SMPL wrapper's 90.
H36M_J14 = [ALL_JOINTS_TO_H36M_MAP[j] for j in H36M_TO_J14]
# ACG proposals drawn per matrix-Fisher sample.
OVERSAMPLING = 8


def make_synth_data_fn(pose_shape_cfg, smpl_model, renderer, edge_detect_model):
    """Build the synthetic-scene stage:
    (draws, pose (B, 72), background (B, 3, D, D), texture (B, tH, tW, 3))
    -> proxy (B, 18, D, D), targets dict. Backgrounds and textures may be
    uint8 (normalised here) or float in [0, 1]."""
    cfg = pose_shape_cfg
    aug = cfg.TRAIN.SYNTH_DATA.AUGMENT
    D = cfg.DATA.PROXY_REP_SIZE
    device = renderer.faces.device
    Rx = so3_exp(torch.tensor([[np.pi, 0.0, 0.0]], device=device))[0]
    num_betas = cfg.MODEL.NUM_SMPL_BETAS
    mean_shape = torch.zeros(num_betas, device=device)
    shape_std = torch.full((num_betas,), float(aug.SMPL.SHAPE_STD), device=device)
    mean_cam_t = torch.tensor(cfg.TRAIN.SYNTH_DATA.MEAN_CAM_T, dtype=torch.float32,
                              device=device)

    def synth(draws, pose, background, texture):
        B = pose.shape[0]
        d = draws.split(8)
        if background.dtype == torch.uint8:
            background = background.to(torch.float32) / 255.0
        if texture.dtype == torch.uint8:
            texture = texture.to(torch.float32) / 255.0

        # Pose -> rotmats, the global rotation post-multiplied by a
        # 180-degree x-flip.
        rotmats = batch_rodrigues(pose.reshape(B, 24, 3))
        target_glob_rotmats = rotmats[:, 0] @ Rx
        target_pose_rotmats = rotmats[:, 1:]

        target_shape = normal_sample_shape(d[0], B, mean_shape, shape_std)
        target_cam_t = augment_cam_t(d[1], mean_cam_t.expand(B, 3),
                                     xy_std=aug.CAM.XY_STD,
                                     delta_z_range=aug.CAM.DELTA_Z_RANGE)

        smpl_out = smpl_model(body_pose=target_pose_rotmats,
                              global_orient=target_glob_rotmats[:, None],
                              betas=target_shape, pose2rot=False)
        target_vertices = smpl_out["vertices"]
        target_joints_all = smpl_out["joints"]
        target_joints_h36mlsp = target_joints_all[:, H36M_J14]
        target_reposed_vertices = smpl_model(betas=target_shape)["vertices"]

        # COCO joints projected with the un-flipped convention.
        verts_render = aa_rotate_translate_points(target_vertices, X_AXIS,
                                                  np.pi, ZERO_T)
        joints_coco = aa_rotate_translate_points(
            target_joints_all[:, ALL_JOINTS_TO_COCO_MAP], X_AXIS, np.pi, ZERO_T)
        target_joints2d_coco = perspective_project(
            joints_coco, None, target_cam_t,
            focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH, img_wh=D)
        visib = check_joints2d_visibility(target_joints2d_coco, D)

        # Textured render (RGB + IUV).
        lights = augment_light(d[2], B, aug.RGB)
        render = renderer(verts_render, cam_t=target_cam_t,
                          lights_rgb_settings=lights, textures=texture)
        iuv_in = render["iuv_images"].permute(0, 3, 1, 2)
        iuv_in = torch.round(torch.cat([iuv_in[:, :1], iuv_in[:, 1:] * 255.0],
                                       dim=1))
        rgb_in = render["rgb_images"].permute(0, 3, 1, 2)

        # Extreme-crop seg, then the jittered crop around it.
        seg_extreme = random_extreme_crop(
            d[3], iuv_in[:, 0],
            extreme_crop_probability=aug.PROXY_REP.EXTREME_CROP_PROB)
        crop = batch_crop_affine(
            (D, D), rgb=rgb_in, iuv=iuv_in, joints2D=target_joints2d_coco,
            bbox_determiner=seg_extreme,
            orig_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR,
            delta_scale_range=aug.BBOX.DELTA_SCALE_RANGE,
            delta_centre_range=aug.BBOX.DELTA_CENTRE_RANGE,
            out_of_frame_pad_val=-1.0, draws=d[4])
        iuv_in = crop["iuv"]
        target_joints2d_coco = crop["joints2D"]
        rgb_in = crop["rgb"]

        # Visibility after the crop, and the self-occlusion check.
        visib = check_joints2d_visibility(target_joints2d_coco, D, visib)
        seg14 = convert_densepose_seg_to_14part_labels(iuv_in[:, 0])
        visib = check_joints2d_occluded(seg14, visib, pixel_count_threshold=50)

        # Proxy-representation and RGB augmentations.
        seg_aug, joints2d_input, visib = augment_proxy_representation(
            d[5], iuv_in[:, 0], target_joints2d_coco, visib, aug.PROXY_REP)
        rgb_in = batch_add_rgb_background(background, rgb_in, seg_aug)
        rgb_in, joints2d_input, visib = augment_rgb(
            d[6], rgb_in, joints2d_input, visib, aug.RGB)

        # Edges + heatmaps -> the 18-channel proxy.
        edge_out = edge_detect_model(rgb_in)
        edge_in = (edge_out["thresholded_thin_edges"] if cfg.DATA.EDGE_NMS
                   else edge_out["thresholded_grad_magnitude"])
        heatmaps = convert_2Djoints_to_gaussian_heatmaps_batched(
            joints2d_input, D, std=cfg.DATA.HEATMAP_GAUSSIAN_STD)
        heatmaps = heatmaps * visib[:, :, None, None]
        proxy = torch.cat([edge_in, heatmaps], dim=1)

        targets = {
            "pose_params_rotmats": target_pose_rotmats,
            "glob_rotmats": target_glob_rotmats,
            "shape_params": target_shape,
            "verts": target_vertices,
            "joints3D": target_joints_h36mlsp,
            "joints2D": target_joints2d_coco,
            "joints2D_vis": visib,
            "reposed_verts": target_reposed_vertices,
        }
        return proxy, targets

    return synth


class TrainStep:
    """One training step: synthetic batch -> forward -> loss -> backward
    and Adam. Calling it returns the loss, on the device."""

    def __init__(self, model, cfg, smpl_model, renderer, edge_detect_model,
                 loss_stage_cfg, optimizer):
        self.model = model
        self.smpl_model = smpl_model
        self.optimizer = optimizer
        self.synth = make_synth_data_fn(cfg, smpl_model, renderer,
                                        edge_detect_model)
        self.criterion = PoseMFShapeGaussianLoss(
            loss_stage_cfg, img_wh=cfg.DATA.PROXY_REP_SIZE)
        self.j2d_loss_on = loss_stage_cfg.J2D_LOSS_ON
        self.num_samples = cfg.LOSS.NUM_SAMPLES

    def forward_loss(self, draws, proxy, targets):
        B = proxy.shape[0]
        N = self.num_samples
        smpl = self.smpl_model
        pred = self.model(proxy)

        pred_glob_rotmats = rot6d_to_rotmat(pred["glob"])
        mode = smpl(body_pose=pred["pose_rotmats_mode"],
                    global_orient=pred_glob_rotmats[:, None],
                    betas=pred["shape_mean"], pose2rot=False)
        joints_all = mode["joints"]
        joints_h36mlsp = joints_all[:, H36M_J14]
        joints_coco = aa_rotate_translate_points(
            joints_all[:, ALL_JOINTS_TO_COCO_MAP], X_AXIS, np.pi, ZERO_T)
        j2d_mode = orthographic_project(joints_coco, pred["cam"])

        j2d_mode_sets = j2d_mode[:, None]
        if "samples" in self.j2d_loss_on:
            draws_pose, draws_shape = draws.split(2)
            draws_eps, draws_w = draws_pose.split(2)
            J, lanes = pred["pose_params_U"].shape[1], N * OVERSAMPLING
            shape_mean = pred["shape_mean"]
            eps = draws_eps.normal((B, J, lanes, 4))
            w = draws_w.uniform((B, J, lanes))
            shape_eps = draws_shape.normal((B, N, shape_mean.shape[1]))
            pose_samples = pose_matrix_fisher_sampling(
                pred["pose_params_U"], pred["pose_params_S"],
                pred["pose_params_V"], N, b=1.5,
                oversampling_ratio=OVERSAMPLING, eps=eps, w=w)
            shape_samples = shape_gaussian_sampling(
                shape_mean, torch.exp(pred["shape_log_std"]), N, eps=shape_eps)
            flat = smpl(body_pose=pose_samples.reshape(B * N, J, 3, 3),
                        global_orient=pred_glob_rotmats[:, None, None]
                        .expand(B, N, 1, 3, 3).reshape(B * N, 1, 3, 3),
                        betas=shape_samples.reshape(B * N, -1),
                        pose2rot=False)["joints"][:, ALL_JOINTS_TO_COCO_MAP]
            flat = aa_rotate_translate_points(flat, X_AXIS, np.pi, ZERO_T)
            cam_rep = pred["cam"].repeat_interleave(N, dim=0)
            j2d_samples = orthographic_project(flat, cam_rep).reshape(B, N, -1, 2)
            if self.j2d_loss_on == "means+samples":
                j2d_for_loss = torch.cat([j2d_mode_sets, j2d_samples], dim=1)
                j2d_sets = N + 1
            else:
                j2d_for_loss = j2d_samples
                j2d_sets = N
        else:
            j2d_for_loss = j2d_mode_sets
            j2d_sets = 1

        pred_dict = {
            "pose_params_F": pred["pose_params_F"],
            "pose_params_U": pred["pose_params_U"],
            "pose_params_S": pred["pose_params_S"],
            "pose_params_V": pred["pose_params_V"],
            "shape_mean": pred["shape_mean"],
            "shape_log_std": pred["shape_log_std"],
            "verts": mode["vertices"],
            "joints3D": joints_h36mlsp,
            "joints2D": j2d_for_loss,
            "glob_rotmats": pred_glob_rotmats,
        }
        loss, _ = self.criterion(targets, pred_dict, j2d_sets=j2d_sets)
        return loss

    def __call__(self, draws, pose, background, texture):
        draws_synth, draws_fwd = draws.split(2)
        with torch.no_grad():
            proxy, targets = self.synth(draws_synth, pose, background, texture)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.forward_loss(draws_fwd, proxy, targets)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
