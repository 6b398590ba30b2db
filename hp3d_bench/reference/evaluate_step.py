"""The reference evaluation step (SSP-3D and 3DPW batches), on one
device.

A frozen copy of the port's evaluate/evaluate_pose_mf_shape_gaussian_net.py
(`gender_codes`, `sample_draws`, `make_eval_step`) without the parallel
mesh, over the reference's own modules: its silhouettes are rasterized
with plain torch ops, and its predictor runs the pose head's SVD the
predictor was built with (the LAPACK-sign SVD for a reference checkpoint).
"""

import numpy as np
import torch

from hp3d_bench.reference.models.smpl import NUM_BODY_JOINTS, smpl_forward_mixed
from hp3d_bench.reference.ops.bingham_sampling import (
    pose_matrix_fisher_sampling, shape_gaussian_sampling)
from hp3d_bench.reference.utils.cam_utils import orthographic_project
from hp3d_bench.reference.utils.joints2d_utils import undo_keypoint_normalisation
from hp3d_bench.reference.utils.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP, ALL_JOINTS_TO_H36M_MAP, H36M_TO_J14)
from hp3d_bench.reference.utils.rotation_utils import (
    aa_rotate_translate_points, batch_rodrigues, rot6d_to_rotmat, so3_exp)

_X_FLIP = np.pi
X_AXIS = (1.0, 0.0, 0.0)
ZERO_T = (0.0, 0.0, 0.0)
# Proposals per requested sample of the matrix-Fisher sampler, and its b.
OVERSAMPLING = 8
BINGHAM_B = 1.5
# The samples' generator seed (the JAX package's rng_seed default).
RNG_SEED = 0

_GENDER_CODES = {"n": 0, "neutral": 0, "m": 1, "male": 1, "f": 2, "female": 2}

# Per-frame values the host keeps when the metrics run on the device.
_DUMP_KEYS = ("frame_metrics", "pred_glob_rotmats", "pred_pose_rotmats_mode",
              "pred_shape_mean", "pred_cam")



def gender_codes(genders):
    """Dataset gender labels ('m', 'female', ...) -> int32 codes: 0 neutral
    (and anything unknown), 1 male, 2 female."""
    return np.array([_GENDER_CODES.get(str(g).strip(), 0) for g in genders],
                    np.int32)


def sample_draws(generator, batch_size, num_samples, num_betas, device):
    """One batch's random draws for the samples: the matrix-Fisher sampler's
    Gaussian and uniform proposals and the shape sampler's Gaussians.

    :return: dict pose_eps (B, 23, N*8, 4), pose_w (B, 23, N*8),
        shape_eps (B, N, num_betas)
    """
    lanes = num_samples * OVERSAMPLING

    def draw(fn, shape):
        return fn(shape, generator=generator, dtype=torch.float32, device=device)

    return {"pose_eps": draw(torch.randn, (batch_size, NUM_BODY_JOINTS, lanes, 4)),
            "pose_w": draw(torch.rand, (batch_size, NUM_BODY_JOINTS, lanes)),
            "shape_eps": draw(torch.randn, (batch_size, num_samples, num_betas))}


def make_eval_step(pose_shape_model, smpl_neutral, smpl_male, smpl_female,
                   edge_detect_model, pose_shape_cfg, num_samples,
                   compute_joints2d, compute_silhouettes, compute_samples,
                   silhouette_renderer, static_gender=None,
                   frame_metrics_fn=None):
    """Build the per-batch evaluation function.

    static_gender (None | 0 | 1 | 2): when the whole batch shares one gender
    (the evaluation loop gender-sorts the dataset, so this is the common
    case), only that gender's SMPL targets are computed; None runs
    smpl_forward_mixed.

    frame_metrics_fn (metric_sums.make_eval_frame_metrics_fn result): when
    given, the per-frame metric values are computed in the step and
    returned under out["frame_metrics"], and the bulky vertex, sample and
    silhouette tensors are dropped from the outputs.

    :return: step(draws, image, heatmaps, target_pose, target_shape,
        gender_code, target_joints2d, target_silhouette) -> dict of tensors;
        draws as sample_draws returns them (None without samples)
    """
    img_wh = pose_shape_cfg.DATA.PROXY_REP_SIZE
    smpls = (smpl_neutral, smpl_male, smpl_female)

    def _step(draws, image, heatmaps, target_pose, target_shape, gender_code,
              target_joints2d, target_silhouette):
        B = image.shape[0]
        device = image.device
        h36m_map = torch.as_tensor(ALL_JOINTS_TO_H36M_MAP, device=device)
        j14_map = torch.as_tensor(H36M_TO_J14, device=device)
        coco_map = torch.as_tensor(ALL_JOINTS_TO_COCO_MAP, device=device)
        out = {}

        # ---- proxy representation ----
        edge_out = edge_detect_model(image)
        edges = (edge_out["thresholded_thin_edges"] if pose_shape_cfg.DATA.EDGE_NMS
                 else edge_out["thresholded_grad_magnitude"])
        proxy = torch.cat([edges, heatmaps], dim=1)

        # ---- gendered targets with pre-flipped global rotation ----
        target_rotmats = batch_rodrigues(target_pose.reshape(B, 24, 3))
        Rx = so3_exp(torch.tensor([[_X_FLIP, 0.0, 0.0]], device=device))[0]
        full_rotmats = torch.cat([(Rx @ target_rotmats[:, 0])[:, None],
                                  target_rotmats[:, 1:]], dim=1)
        if static_gender is not None:
            smpl_target = smpls[static_gender]
            posed = smpl_target(body_pose=full_rotmats[:, 1:],
                                global_orient=full_rotmats[:, 0:1],
                                betas=target_shape, pose2rot=False)
            reposed = smpl_target(betas=target_shape)
        else:
            plist = [s.params for s in smpls]
            posed = smpl_forward_mixed(plist, gender_code,
                                       body_pose=full_rotmats[:, 1:],
                                       global_orient=full_rotmats[:, 0:1],
                                       betas=target_shape, pose2rot=False)
            reposed = smpl_forward_mixed(plist, gender_code, betas=target_shape)
        out["target_verts"] = posed["vertices"]
        out["target_reposed_verts"] = reposed["vertices"]
        out["target_joints3D"] = posed["joints"][:, h36m_map][:, j14_map]

        # ---- prediction ----
        pred = pose_shape_model(proxy)
        glob_rotmats = (batch_rodrigues(pred["glob"]) if pred["glob"].shape[-1] == 3
                        else rot6d_to_rotmat(pred["glob"]))
        cam_wp = pred["cam"]
        ortho_scale = torch.cat([cam_wp[:, 0:1]] * 2, dim=-1)
        cam_t = torch.cat([cam_wp[:, 1:], torch.full((B, 1), 2.5, device=device)],
                          dim=-1)

        mode = smpl_neutral(body_pose=pred["pose_rotmats_mode"],
                            global_orient=glob_rotmats[:, None],
                            betas=pred["shape_mean"], pose2rot=False)
        verts_mode = mode["vertices"]
        joints_mode = mode["joints"]
        out["pred_verts"] = verts_mode
        out["pred_joints3D"] = joints_mode[:, h36m_map][:, j14_map]
        reposed_mean = smpl_neutral(betas=pred["shape_mean"])["vertices"]
        out["pred_reposed_verts"] = reposed_mean
        out["pred_glob_rotmats"] = glob_rotmats
        out["pred_pose_rotmats_mode"] = pred["pose_rotmats_mode"]
        out["pred_shape_mean"] = pred["shape_mean"]
        out["pred_cam"] = cam_wp

        def project_coco(joints, cam):
            coco = aa_rotate_translate_points(joints[:, coco_map], X_AXIS,
                                              _X_FLIP, ZERO_T)
            return undo_keypoint_normalisation(orthographic_project(coco, cam),
                                               img_wh)

        if compute_joints2d:
            out["pred_joints2D"] = project_coco(joints_mode, cam_wp)

        def silhouettes(verts, cam_t, scale):
            render = silhouette_renderer(
                aa_rotate_translate_points(verts, X_AXIS, _X_FLIP, ZERO_T),
                cam_t=cam_t, orthographic_scale=scale)
            return (torch.round(render["iuv_images"][..., 0]) > 0).to(torch.float32)

        if compute_silhouettes:
            out["pred_silhouettes"] = silhouettes(verts_mode, cam_t, ortho_scale)

        # ---- samples ----
        if compute_samples:
            pose_samples = pose_matrix_fisher_sampling(
                pred["pose_params_U"], pred["pose_params_S"],
                pred["pose_params_V"], num_samples, b=BINGHAM_B,
                oversampling_ratio=OVERSAMPLING, eps=draws["pose_eps"],
                w=draws["pose_w"])
            shape_eps = draws["shape_eps"]
            N = pose_samples.shape[1]
            shape_samples = shape_gaussian_sampling(
                pred["shape_mean"], torch.exp(pred["shape_log_std"]), N,
                eps=shape_eps)
            flat_shape = shape_samples.reshape(B * N, -1)
            flat_glob = glob_rotmats[:, None].expand(B, N, 3, 3).reshape(B * N, 1, 3, 3)
            sampled = smpl_neutral(body_pose=pose_samples.reshape(B * N, 23, 3, 3),
                                   global_orient=flat_glob, betas=flat_shape,
                                   pose2rot=False)
            verts_s = sampled["vertices"].reshape(B, N, -1, 3)
            joints_s = sampled["joints"].reshape(B, N, -1, 3)
            joints3d_s = joints_s[:, :, h36m_map][:, :, j14_map]
            reposed_s = smpl_neutral(betas=flat_shape)["vertices"].reshape(B, N, -1, 3)
            # inject the mode as sample 0 (reference :172-179)
            verts_s = torch.cat([verts_mode[:, None], verts_s[:, 1:]], dim=1)
            joints3d_s = torch.cat([out["pred_joints3D"][:, None],
                                    joints3d_s[:, 1:]], dim=1)
            reposed_s = torch.cat([reposed_mean[:, None], reposed_s[:, 1:]],
                                  dim=1)
            out["pred_verts_samples"] = verts_s
            out["pred_joints3D_samples"] = joints3d_s
            out["pred_reposed_verts_samples"] = reposed_s

            if compute_joints2d:
                j2d_s = project_coco(joints_s.reshape(B * N, -1, 3),
                                     cam_wp.repeat_interleave(N, dim=0))
                out["pred_joints2Dsamples"] = j2d_s.reshape(B, N, -1, 2)

            if compute_silhouettes:
                sil = silhouettes(verts_s.reshape(B * N, -1, 3),
                                  cam_t.repeat_interleave(N, dim=0),
                                  ortho_scale.repeat_interleave(N, dim=0))
                out["pred_silhouettessamples"] = sil.reshape(B, N, img_wh, img_wh)

        if frame_metrics_fn is not None:
            pred_m = {k[len("pred_"):]: v for k, v in out.items()
                      if k.startswith("pred_")}
            target_m = {k[len("target_"):]: v for k, v in out.items()
                        if k.startswith("target_")}
            target_m["joints2D"] = target_joints2d
            target_m["silhouettes"] = target_silhouette
            out["frame_metrics"] = frame_metrics_fn(pred_m, target_m)
            out = {k: v for k, v in out.items() if k in _DUMP_KEYS}
        return out

    def step(*args):
        with torch.inference_mode():
            return _step(*args)

    return step
