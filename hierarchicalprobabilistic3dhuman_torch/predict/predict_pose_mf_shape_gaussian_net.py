"""Per-image predict: image folder -> proxy -> distribution -> figures.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/predict/
predict_pose_mf_shape_gaussian_net.py (jet_colormap :61,
build_proxy_representation :77, make_predict_core :99, the per-image loop
:265-463 with its figure). Per image: HRNet keypoints, 256^2 crop, Canny +
Gaussian joint heatmaps (the 18-channel proxy), the distribution predictor,
SMPL mode and T-pose meshes, per-vertex uncertainty from pose samples, jet
colours, and ONE batched render of the 6 views through the rasterizer
kernel, composited over the crop.
"""

import os

import cv2
import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.ops.resample import affine_resample
from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
    make_hrnet_predictor)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer)
from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_add_rgb_background, batch_crop_affine)
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps_batched)
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
    aa_rotate_translate_points, rot6d_to_rotmat)
from hierarchicalprobabilistic3dhuman_torch.utils.sampling_utils import (
    compute_vertex_uncertainties_by_sampling)

# Joints never removed by the confidence threshold.
ALWAYS_VISIBLE_JOINTS = [0, 1, 2, 3, 4, 5, 6, 11, 12]

# matplotlib 'jet' segment anchors (piecewise-linear per channel).
_JET = (
    ([0.0, 0.35, 0.66, 0.89, 1.0], [0.0, 0.0, 1.0, 1.0, 0.5]),
    ([0.0, 0.125, 0.375, 0.64, 0.91, 1.0], [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]),
    ([0.0, 0.11, 0.34, 0.65, 1.0], [0.5, 1.0, 1.0, 0.0, 0.0]),
)

LIGHTS_RGB = {
    "location": [0.0, -0.8, -2.0],
    "ambient_color": [0.5, 0.5, 0.5],
    "diffuse_color": [0.3, 0.3, 0.3],
    "specular_color": [0.0, 0.0, 0.0],
}
FIXED_CAM_T = [0.0, -0.2, 2.5]
FIXED_SCALE = [0.95, 0.95]
X_AXIS = [1.0, 0.0, 0.0]
Y_AXIS = [0.0, 1.0, 0.0]
ZERO_T = [0.0, 0.0, 0.0]


def _interp(t, xs, ys):
    """jnp.interp for increasing knots xs."""
    xs = torch.as_tensor(xs, dtype=t.dtype, device=t.device)
    ys = torch.as_tensor(ys, dtype=t.dtype, device=t.device)
    i = torch.clamp(torch.searchsorted(xs, t, right=True), 1, len(xs) - 1)
    x0, y0 = xs[i - 1], ys[i - 1]
    return y0 + ((t - x0) / (xs[i] - x0)) * (ys[i] - y0)


def jet_colormap(values, vmin=0.0, vmax=0.2):
    """matplotlib-jet colours by piecewise-linear evaluation of the jet
    segment data.

    :param values: (...,) uncertainty values
    :return: (..., 3) RGB in [0, 1]
    """
    t = torch.clamp((values - vmin) / (vmax - vmin), 0.0, 1.0).contiguous()
    return torch.stack([_interp(t, xs, ys) for xs, ys in _JET], dim=-1)


def build_proxy_representation(cropped_rgb, cropped_joints2D, joints2Dconfs,
                               edge_detect_model, pose_shape_cfg,
                               joints2Dvisib_threshold=0.75):
    """18-channel proxy: Canny edges + confidence-masked joint heatmaps.

    :param cropped_rgb: (B, 3, D, D)
    :param cropped_joints2D: (B, 17, 2)
    :param joints2Dconfs: (B, 17)
    :return: proxy (B, 18, D, D)
    """
    edge_out = edge_detect_model(cropped_rgb)
    edges = (edge_out["thresholded_thin_edges"] if pose_shape_cfg.DATA.EDGE_NMS
             else edge_out["thresholded_grad_magnitude"])
    heatmaps = convert_2Djoints_to_gaussian_heatmaps_batched(
        cropped_joints2D, pose_shape_cfg.DATA.PROXY_REP_SIZE,
        std=pose_shape_cfg.DATA.HEATMAP_GAUSSIAN_STD)
    visib = joints2Dconfs > joints2Dvisib_threshold
    visib[:, ALWAYS_VISIBLE_JOINTS] = True
    return torch.cat([edges, heatmaps * visib[:, :, None, None]], dim=1)


def six_views(verts_mode, reposed_verts, vertex_colours, pred_cam_t,
              pred_scale):
    """The 6 meshes the figure shows per image, stacked for ONE render: the
    mode mesh at the predicted camera, then three 90-degree turns about y
    and the T-pose and its turn at a fixed camera. Meshes are in the camera
    frame (already turned by pi about x).

    :param verts_mode, reposed_verts: (B, 6890, 3)
    :param vertex_colours: (B, 6890, 3) jet colours of the uncertainty
    :param pred_cam_t: (B, 3); pred_scale: (B, 2)
    :return: dict of renderer arguments for 6B meshes, view-major per image
    """
    B = verts_mode.shape[0]
    device = verts_mode.device
    views = [verts_mode]
    for _ in range(3):
        views.append(aa_rotate_translate_points(views[-1], Y_AXIS, -np.pi / 2,
                                                ZERO_T))
    views += [reposed_verts, aa_rotate_translate_points(reposed_verts, Y_AXIS,
                                                        -np.pi / 2, ZERO_T)]
    grey = torch.full((B, 6890, 3), 0.7, device=device)

    def stack(per_view):
        return torch.stack(per_view, dim=1).reshape((6 * B,) + per_view[0].shape[1:])

    def const(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return {
        "vertices": stack(views),
        "verts_features": stack([vertex_colours] * 4 + [grey] * 2),
        "cam_t": stack([pred_cam_t] + [const(FIXED_CAM_T).expand(B, 3)] * 5),
        "orthographic_scale": stack([pred_scale]
                                    + [const(FIXED_SCALE).expand(B, 2)] * 5),
        "lights_rgb_settings": {k: const(v).expand(6 * B, 3)
                                for k, v in LIGHTS_RGB.items()},
    }


def make_predict_core(pose_shape_model, pose_shape_cfg, smpl_model,
                      edge_detect_model, body_vis_renderer, hrnet_cfg,
                      joints2Dvisib_threshold=0.75, num_uncertainty_samples=50):
    """Everything between the HRNet output and the figure, for a batch of B
    images: crop, proxy, predictor, SMPL mode + T-pose, uncertainty
    sampling, jet colours, the 6-view render and the front composite.

    :return: core(hr_cropped (B, 3, 384, 288), joints2D (B, 17, 2),
        confs (B, 17), generator=None, eps=None, w=None) -> dict of batched
        outputs (rgb_views / iuv_views are (B, 6, wh, wh, 3)). `eps`/`w` are
        optional pre-drawn sampler draws (see ops/bingham_sampling.py).
    """
    proxy_size = pose_shape_cfg.DATA.PROXY_REP_SIZE
    in_w, in_h = hrnet_cfg.MODEL.IMAGE_SIZE  # (288, 384)
    wh = body_vis_renderer.img_wh

    @torch.inference_mode()
    def core(hr_cropped, joints2D, confs, generator=None, eps=None, w=None):
        B = hr_cropped.shape[0]
        device = hr_cropped.device

        def const(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        cropped = batch_crop_affine(
            (proxy_size, proxy_size), joints2D=joints2D, rgb=hr_cropped,
            bbox_centres=const([in_h * 0.5, in_w * 0.5]).expand(B, 2),
            bbox_heights=torch.full((B,), float(in_h), device=device),
            bbox_widths=torch.full((B,), float(in_h), device=device),
            orig_scale_factor=1.0)
        proxy = build_proxy_representation(cropped["rgb"], cropped["joints2D"],
                                           confs, edge_detect_model,
                                           pose_shape_cfg,
                                           joints2Dvisib_threshold)
        pred = pose_shape_model(proxy)
        glob_rotmats = rot6d_to_rotmat(pred["glob"])

        smpl_mode = smpl_model(body_pose=pred["pose_rotmats_mode"],
                               global_orient=glob_rotmats[:, None],
                               betas=pred["shape_mean"], pose2rot=False)
        verts_mode = aa_rotate_translate_points(smpl_mode["vertices"], X_AXIS,
                                                np.pi, ZERO_T)
        per_vertex_3Dvar, verts_samples, _ = \
            compute_vertex_uncertainties_by_sampling(
                pred["pose_params_U"], pred["pose_params_S"],
                pred["pose_params_V"], pred["shape_mean"], glob_rotmats,
                num_uncertainty_samples, smpl_model, generator=generator,
                eps=eps, w=w)

        cam_wp = pred["cam"]
        pred_scale = cam_wp[:, 0:1].expand(B, 2)
        pred_cam_t = torch.cat([cam_wp[:, 1:],
                                torch.full((B, 1), 2.5, device=device)], dim=-1)

        reposed = smpl_model(betas=pred["shape_mean"])
        reposed_verts = aa_rotate_translate_points(reposed["vertices"], X_AXIS,
                                                   np.pi, ZERO_T)
        vis = body_vis_renderer(**six_views(
            verts_mode, reposed_verts, jet_colormap(per_vertex_3Dvar),
            pred_cam_t, pred_scale))
        rgb_views = vis["rgb_images"].reshape(B, 6, wh, wh, 3)
        iuv_views = vis["iuv_images"].reshape(B, 6, wh, wh, 3)

        # Composite the front view over the cropped input.
        scale_aff = const([[wh / proxy_size, 0.0, 0.0],
                           [0.0, wh / proxy_size, 0.0]]).expand(B, 2, 3)
        cropped_vis = affine_resample(cropped["rgb"], scale_aff, (wh, wh))
        front = batch_add_rgb_background(
            cropped_vis, rgb_views[:, 0].permute(0, 3, 1, 2),
            torch.round(iuv_views[:, 0, :, :, 0]))
        return {
            "proxy": proxy,
            "cropped_joints2D": cropped["joints2D"],
            "pose_rotmats_mode": pred["pose_rotmats_mode"],
            "shape_mean": pred["shape_mean"],
            "cam": cam_wp,
            "per_vertex_3Dvar": per_vertex_3Dvar,
            "verts_samples": verts_samples,
            "verts_mode": verts_mode,
            "rgb_views": rgb_views,
            "iuv_views": iuv_views,
            "front": front,
            "cropped_vis": cropped_vis,
        }

    return core


def _figure(out, confs, proxy_size, wh):
    """The reference's 2 x 4 figure: crop, proxy with joints, front
    composite and the 5 other views (host numpy + cv2)."""
    front_np = out["front"][0].permute(1, 2, 0).cpu().numpy()
    views_np = out["rgb_views"][0].cpu().numpy()
    cropped_np = out["cropped_vis"][0].permute(1, 2, 0).cpu().numpy()
    proxy_np = out["proxy"][0].sum(dim=0).cpu().numpy()
    proxy_np = cv2.resize(np.stack([proxy_np] * 3, axis=-1), (wh, wh))
    proxy_u8 = np.clip(proxy_np * 255, 0, 255).astype(np.uint8)
    j2d_np = out["cropped_joints2D"][0].cpu().numpy()
    confs_np = confs.cpu().numpy()
    for jn in range(j2d_np.shape[0]):
        hv = j2d_np[jn] * wh / proxy_size
        cv2.circle(proxy_u8, (int(hv[0]), int(hv[1])), 3, (255, 0, 0), -1)
        cv2.putText(proxy_u8, str(jn), (int(hv[0]) + 4, int(hv[1]) + 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 0, 0), lineType=2)
        cv2.putText(proxy_u8, f"{jn} {confs_np[jn]:.2f}", (10, 16 * (jn + 1)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 0, 0), lineType=2)

    fig = np.zeros((2 * wh, 4 * wh, 3), np.float32)
    fig[:wh, :wh] = cropped_np
    fig[wh:, :wh] = proxy_u8.astype(np.float32) / 255.0
    fig[:wh, wh:2 * wh] = front_np
    fig[wh:, wh:2 * wh] = views_np[1]
    fig[:wh, 2 * wh:3 * wh] = views_np[2]
    fig[wh:, 2 * wh:3 * wh] = views_np[3]
    fig[:wh, 3 * wh:] = views_np[4]
    fig[wh:, 3 * wh:] = views_np[5]
    return fig


def predict_pose_mf_shape_gaussian_net(pose_shape_model, pose_shape_cfg,
                                       smpl_model, hrnet, hrnet_cfg,
                                       edge_detect_model, image_dir, save_dir,
                                       device, joints2Dvisib_threshold=0.75,
                                       visualise_wh=512,
                                       num_uncertainty_samples=50):
    """Run prediction on every .jpg/.png in image_dir (already cropped
    around the person) and write one figure per image to save_dir. The
    sampler's draws come from a generator seeded with 0.

    :return: {fname: dict pose_mode (23, 3, 3), shape_mean (10,), cam (3,),
        per_vertex_uncertainty (6890,)} as numpy
    """
    os.makedirs(save_dir, exist_ok=True)
    renderer = TexturedIUVRenderer(img_wh=visualise_wh, device=device)
    hrnet_predictor = make_hrnet_predictor(
        hrnet, hrnet_cfg, device,
        bbox_scale_factor=pose_shape_cfg.DATA.BBOX_SCALE_FACTOR)
    core = make_predict_core(
        pose_shape_model, pose_shape_cfg, smpl_model, edge_detect_model,
        renderer, hrnet_cfg, joints2Dvisib_threshold=joints2Dvisib_threshold,
        num_uncertainty_samples=num_uncertainty_samples)
    generator = torch.Generator(device=device).manual_seed(0)

    results = {}
    for image_fname in sorted(f for f in os.listdir(image_dir)
                              if f.endswith((".jpg", ".png"))):
        image_bgr = cv2.imread(os.path.join(image_dir, image_fname))
        if image_bgr is None:
            raise ValueError(f"{image_fname}: cv2.imread failed")
        hrnet_output = hrnet_predictor(cv2.cvtColor(image_bgr, cv2.COLOR_BGR2RGB))
        out = core(hrnet_output["cropped_image"][None],
                   hrnet_output["joints2D"][None],
                   hrnet_output["joints2Dconfs"][None], generator=generator)

        fig = _figure(out, hrnet_output["joints2Dconfs"],
                      pose_shape_cfg.DATA.PROXY_REP_SIZE, visualise_wh)
        cv2.imwrite(os.path.join(save_dir, image_fname),
                    np.clip(fig[:, :, ::-1] * 255, 0, 255).astype(np.uint8))
        results[image_fname] = {
            "pose_mode": out["pose_rotmats_mode"][0].cpu().numpy(),
            "shape_mean": out["shape_mean"][0].cpu().numpy(),
            "cam": out["cam"][0].cpu().numpy(),
            "per_vertex_uncertainty": out["per_vertex_3Dvar"][0].cpu().numpy(),
        }
    return results
