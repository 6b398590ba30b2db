"""The reference of the batched predict service (`--no_vis`): HRNet
keypoints on a batch of cropped photos, then the predict core without a
render, on one device.

A frozen copy of the port's predict/predict_pose_mf_shape_gaussian_net.py
(`build_proxy_representation`, `make_predict_core` with render_vis=False)
without the parallel mesh, over the reference's own modules; the keypoints
come from the reference's copy of predict/predict_hrnet.py.
"""

import torch

from hp3d_bench.reference.utils.image_utils import batch_crop_affine
from hp3d_bench.reference.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps_batched)
from hp3d_bench.reference.utils.rotation_utils import (
    batch_rodrigues, rot6d_to_rotmat)
from hp3d_bench.reference.utils.sampling_utils import (
    compute_vertex_uncertainties_by_sampling)

# Joints never removed by the confidence threshold.
ALWAYS_VISIBLE_JOINTS = [0, 1, 2, 3, 4, 5, 6, 11, 12]


def build_proxy_representation(cropped_rgb, cropped_joints2D, joints2Dconfs,
                               edge_detect_model, pose_shape_cfg,
                               joints2Dvisib_threshold=0.75):
    """18-channel proxy: Canny edges + confidence-masked joint heatmaps."""
    edge_out = edge_detect_model(cropped_rgb)
    edges = (edge_out["thresholded_thin_edges"] if pose_shape_cfg.DATA.EDGE_NMS
             else edge_out["thresholded_grad_magnitude"])
    heatmaps = convert_2Djoints_to_gaussian_heatmaps_batched(
        cropped_joints2D, pose_shape_cfg.DATA.PROXY_REP_SIZE,
        std=pose_shape_cfg.DATA.HEATMAP_GAUSSIAN_STD)
    visib = joints2Dconfs > joints2Dvisib_threshold
    visib[:, ALWAYS_VISIBLE_JOINTS] = True
    return torch.cat([edges, heatmaps * visib[:, :, None, None]], dim=1)


def make_predict_core(pose_shape_model, pose_shape_cfg, smpl_model,
                      edge_detect_model, hrnet_cfg, joints2Dvisib_threshold=0.75,
                      num_uncertainty_samples=50):
    """core(hr_cropped, joints2D, confs, generator) -> the service's outputs:
    pose_rotmats_mode, shape_mean, cam, per_vertex_3Dvar."""
    proxy_size = pose_shape_cfg.DATA.PROXY_REP_SIZE
    in_w, in_h = hrnet_cfg.MODEL.IMAGE_SIZE

    @torch.inference_mode()
    def core(hr_cropped, joints2D, confs, generator):
        B = hr_cropped.shape[0]
        device = hr_cropped.device
        cropped = batch_crop_affine(
            (proxy_size, proxy_size), joints2D=joints2D, rgb=hr_cropped,
            bbox_centres=torch.as_tensor([in_h * 0.5, in_w * 0.5],
                                         dtype=torch.float32,
                                         device=device).expand(B, 2),
            bbox_heights=torch.full((B,), float(in_h), device=device),
            bbox_widths=torch.full((B,), float(in_h), device=device),
            orig_scale_factor=1.0)
        proxy = build_proxy_representation(cropped["rgb"], cropped["joints2D"],
                                           confs, edge_detect_model,
                                           pose_shape_cfg,
                                           joints2Dvisib_threshold)
        pred = pose_shape_model(proxy)
        if pred["glob"].shape[-1] == 3:
            glob_rotmats = batch_rodrigues(pred["glob"])
        else:
            glob_rotmats = rot6d_to_rotmat(pred["glob"])
        per_vertex_3Dvar, _, _ = compute_vertex_uncertainties_by_sampling(
            pred["pose_params_U"], pred["pose_params_S"],
            pred["pose_params_V"], pred["shape_mean"], glob_rotmats,
            num_uncertainty_samples, smpl_model, generator=generator)
        return {"pose_rotmats_mode": pred["pose_rotmats_mode"],
                "shape_mean": pred["shape_mean"], "cam": pred["cam"],
                "per_vertex_3Dvar": per_vertex_3Dvar}

    return core
