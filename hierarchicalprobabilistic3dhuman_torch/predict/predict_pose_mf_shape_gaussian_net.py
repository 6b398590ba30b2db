"""Predict: image folder -> proxy -> distribution -> figures / outputs.npz.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/predict/
predict_pose_mf_shape_gaussian_net.py (jet_colormap :61,
build_proxy_representation :77, make_predict_core :99, the figure, uncrop
composite and samples figure of its per-image driver :265-463,
_prefetch_images :466, predict_folder_batched :521), with one folder driver
for every batch size. Per image: HRNet keypoints, 256^2 crop, Canny +
Gaussian joint heatmaps (the 18-channel proxy), the distribution predictor,
SMPL mode and T-pose meshes, per-vertex uncertainty from pose samples, and,
with figures on, jet colours and ONE batched render of the 6 views per
image through the rasterizer kernel, composited over the crop.

On a parallel Mesh of the "sample" axis alone (JAX's cli/predict.py:194-202
puts every device there) every rank runs the whole path on every image and
the SMPL of the uncertainty samples splits over the ranks
(utils/sampling_utils.py); rank 0 alone renders and writes the figures and
outputs.npz, the other ranks return the same results.
"""

import os
import queue
import threading
import time
import zipfile

import cv2
import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.ops.resample import affine_resample
from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
    make_hrnet_batch_predictor)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer)
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import count, span
from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_add_rgb_background, batch_crop_affine, batch_uncrop_affine)
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps_batched)
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
    aa_rotate_translate_points, batch_rodrigues, rot6d_to_rotmat)
from hierarchicalprobabilistic3dhuman_torch.utils.sampling_utils import (
    compute_vertex_uncertainties_by_sampling, joints2D_error_sorted_verts_sampling)

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
# Sample meshes shown in the samples figure: those of least 2D joint error.
SAMPLES_SHOWN = 8
# Decoded images the decode thread may hold ahead of the card.
PREFETCH_DEPTH = 8


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
                      joints2Dvisib_threshold=0.75, num_uncertainty_samples=50,
                      render_vis=True, mesh=None):
    """Everything between the HRNet output and the figure, for a batch of B
    images: crop, proxy, predictor, SMPL mode, uncertainty sampling and,
    with `render_vis`, the T-pose, jet colours, the 6-view render and the
    front composite. With render_vis=False no render is made at all (the
    batched --no_vis serving path), and `body_vis_renderer` may be None.
    With a parallel `mesh` the uncertainty samples split over its "sample"
    axis (every rank gets every output).

    :return: core(hr_cropped (B, 3, 384, 288), joints2D (B, 17, 2),
        confs (B, 17), generator=None, eps=None, w=None) -> dict of batched
        outputs (rgb_views / iuv_views are (B, 6, wh, wh, 3)). `eps`/`w` are
        optional pre-drawn sampler draws (see ops/bingham_sampling.py).
    """
    proxy_size = pose_shape_cfg.DATA.PROXY_REP_SIZE
    in_w, in_h = hrnet_cfg.MODEL.IMAGE_SIZE  # (288, 384)

    @torch.inference_mode()
    def core(hr_cropped, joints2D, confs, generator=None, eps=None, w=None):
        with span("predict.core"):
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
            if pred["glob"].shape[-1] == 3:
                glob_rotmats = batch_rodrigues(pred["glob"])
            else:
                glob_rotmats = rot6d_to_rotmat(pred["glob"])

            smpl_mode = smpl_model(body_pose=pred["pose_rotmats_mode"],
                                   global_orient=glob_rotmats[:, None],
                                   betas=pred["shape_mean"], pose2rot=False)
            verts_mode = aa_rotate_translate_points(smpl_mode["vertices"], X_AXIS,
                                                    np.pi, ZERO_T)
            per_vertex_3Dvar, verts_samples, joints_samples = \
                compute_vertex_uncertainties_by_sampling(
                    pred["pose_params_U"], pred["pose_params_S"],
                    pred["pose_params_V"], pred["shape_mean"], glob_rotmats,
                    num_uncertainty_samples, smpl_model, generator=generator,
                    eps=eps, w=w, mesh=mesh)

            cam_wp = pred["cam"]
            pred_scale = cam_wp[:, 0:1].expand(B, 2)
            pred_cam_t = torch.cat([cam_wp[:, 1:],
                                    torch.full((B, 1), 2.5, device=device)], dim=-1)
            out = {
                "proxy": proxy,
                "cropped_joints2D": cropped["joints2D"],
                "pose_rotmats_mode": pred["pose_rotmats_mode"],
                "shape_mean": pred["shape_mean"],
                "cam": cam_wp,
                "pred_cam_t": pred_cam_t,
                "pred_scale": pred_scale,
                "per_vertex_3Dvar": per_vertex_3Dvar,
                "verts_samples": verts_samples,
                "joints_samples": joints_samples,
                "verts_mode": verts_mode,
            }
            if not render_vis:
                return out

            wh = body_vis_renderer.img_wh
            reposed = smpl_model(betas=pred["shape_mean"])
            reposed_verts = aa_rotate_translate_points(reposed["vertices"], X_AXIS,
                                                       np.pi, ZERO_T)
            views = six_views(verts_mode, reposed_verts,
                              jet_colormap(per_vertex_3Dvar), pred_cam_t, pred_scale)
            vis = body_vis_renderer(**views)
            rgb_views = vis["rgb_images"].reshape(B, 6, wh, wh, 3)
            iuv_views = vis["iuv_images"].reshape(B, 6, wh, wh, 3)

            # Composite the front view over the cropped input.
            scale_aff = const([[wh / proxy_size, 0.0, 0.0],
                               [0.0, wh / proxy_size, 0.0]]).expand(B, 2, 3)
            cropped_vis = affine_resample(cropped["rgb"], scale_aff, (wh, wh))
            front = batch_add_rgb_background(
                cropped_vis, rgb_views[:, 0].permute(0, 3, 1, 2),
                torch.round(iuv_views[:, 0, :, :, 0]))
            out.update({
                "rgb_views": rgb_views,
                "iuv_views": iuv_views,
                "front": front,
                "cropped_vis": cropped_vis,
                "verts_rot90": views["vertices"].reshape(B, 6, -1, 3)[:, 1],
            })
            return out

    return core


def samples_views(verts_samples, joints_samples, proxy, cam_wp, verts_mode,
                  verts_rot90, pred_cam_t, pred_scale):
    """The meshes of the samples figure for one image (the core's outputs
    sliced to batch 1), stacked for ONE render as six_views stacks the figure's:
    the mode mesh and the SAMPLES_SHOWN sample meshes of least 2D joint
    error, from the front at the predicted camera, then the same turned 90
    degrees at the fixed camera, all grey.

    The light settings are broadcast from the first component of each
    (v[0:1]), as the JAX package's `_samples_core` broadcasts them (:352),
    so this render's light sits at the origin.

    :return: dict of renderer arguments for 2n meshes, n = 1 + the samples
    """
    sorted_verts = joints2D_error_sorted_verts_sampling(
        verts_samples[0], joints_samples[0], proxy[:, 1:], cam_wp)[:SAMPLES_SHOWN]
    sorted_verts = aa_rotate_translate_points(sorted_verts, X_AXIS, np.pi,
                                              ZERO_T)
    rot90_samples = aa_rotate_translate_points(sorted_verts, Y_AXIS,
                                               -np.pi / 2, ZERO_T)
    front = torch.cat([verts_mode, sorted_verts], dim=0)
    n = front.shape[0]
    device = front.device

    def const(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return {
        "vertices": torch.cat([front, verts_rot90, rot90_samples], dim=0),
        "cam_t": torch.cat([pred_cam_t.expand(n, 3),
                            const(FIXED_CAM_T).expand(n, 3)], dim=0),
        "orthographic_scale": torch.cat([pred_scale.expand(n, 2),
                                         const(FIXED_SCALE).expand(n, 2)], dim=0),
        "lights_rgb_settings": {k: const(v[0:1]).expand(2 * n, 3)
                                for k, v in LIGHTS_RGB.items()},
        "verts_features": torch.full((2 * n, 6890, 3), 0.7, device=device),
    }


@torch.inference_mode()
def samples_core(body_vis_renderer, verts_samples, joints_samples, proxy,
                 cam_wp, verts_mode, verts_rot90, cropped_vis, pred_cam_t,
                 pred_scale):
    """The samples figure's renders for one image (see samples_views): one
    render of 2n meshes, the front renders composited over the crop.

    :return: front_samples (n, 3, wh, wh), rot_samples (n, wh, wh, 3)
    """
    vis = body_vis_renderer(**samples_views(
        verts_samples, joints_samples, proxy, cam_wp, verts_mode, verts_rot90,
        pred_cam_t, pred_scale))
    srgb, siuv = vis["rgb_images"], vis["iuv_images"]
    n, wh = srgb.shape[0] // 2, body_vis_renderer.img_wh
    front_samples = batch_add_rgb_background(
        cropped_vis.expand(n, 3, wh, wh), srgb[:n].permute(0, 3, 1, 2),
        torch.round(siuv[:n, :, :, 0]))
    return front_samples, srgb[n:]


def uncrop_front(rgb_views, iuv_views, bbox_centres, bbox_whs, orig_hw):
    """The front views pasted back into the photos' frame, through the
    square boxes (side `bbox_whs`) the crops came from.

    :param rgb_views, iuv_views: (B, 6, wh, wh, 3)
    :param bbox_centres: (B, 2) [vert, hor]; bbox_whs: (B,), on their device
    :param orig_hw: (H, W) of the photos
    :return: dict rgb (B, 3, H, W), iuv (B, 3, H, W)
    """
    wh = rgb_views.shape[2]
    return batch_uncrop_affine(
        (wh, wh), (orig_hw[1], orig_hw[0]), bbox_centres, bbox_whs, bbox_whs,
        rgb=rgb_views[:, 0].permute(0, 3, 1, 2),
        iuv=iuv_views[:, 0].permute(0, 3, 1, 2))


def _uncrop_composite(unc_rgb, unc_seg, orig_image):
    """The uncropped front render over the photo, BGR uint8 for cv2.

    :param unc_rgb: (3, H, W) [0, 1]; unc_seg: (H, W); orig_image: (H, W, 3)
    """
    bg = (unc_seg == 0)[:, :, None]
    composite = unc_rgb.transpose(1, 2, 0) * 255 * ~bg + orig_image * bg
    return np.clip(composite[:, :, ::-1], 0, 255).astype(np.uint8)


def _figure(cropped, proxy, front, views, wh):
    """The reference's 2 x 4 figure: crop, proxy, front composite and the
    5 other views (host numpy, HWC [0, 1])."""
    fig = np.zeros((2 * wh, 4 * wh, 3), np.float32)
    fig[:wh, :wh] = cropped
    fig[wh:, :wh] = proxy
    fig[:wh, wh:2 * wh] = front
    fig[wh:, wh:2 * wh] = views[1]
    fig[:wh, 2 * wh:3 * wh] = views[2]
    fig[wh:, 2 * wh:3 * wh] = views[3]
    fig[:wh, 3 * wh:] = views[4]
    fig[wh:, 3 * wh:] = views[5]
    return fig


def _proxy_with_joints(proxy_sum, cropped_joints2D, confs, proxy_size, wh):
    """The figure's proxy panel: the summed proxy with the joints
    and their confidences drawn on it (cv2)."""
    proxy_np = cv2.resize(np.stack([proxy_sum] * 3, axis=-1), (wh, wh))
    proxy_u8 = np.clip(proxy_np * 255, 0, 255).astype(np.uint8)
    for jn in range(cropped_joints2D.shape[0]):
        hv = cropped_joints2D[jn] * wh / proxy_size
        cv2.circle(proxy_u8, (int(hv[0]), int(hv[1])), 3, (255, 0, 0), -1)
        cv2.putText(proxy_u8, str(jn), (int(hv[0]) + 4, int(hv[1]) + 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 0, 0), lineType=2)
        cv2.putText(proxy_u8, f"{jn} {confs[jn]:.2f}", (10, 16 * (jn + 1)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 0, 0), lineType=2)
    return proxy_u8.astype(np.float32) / 255.0


def _write_rgb(path, image):
    """Write an RGB [0, 1] float image as a PNG/JPEG (BGR uint8 for cv2)."""
    cv2.imwrite(path, np.clip(image[:, :, ::-1] * 255, 0, 255).astype(np.uint8))


def _samples_figure(front_samples, rot_samples, wh):
    """The 3 x 6 samples grid: each sample's front composite, then its
    90-degree turn."""
    rows, cols = 3, 6
    fig = np.zeros((rows * wh, cols * wh, 3), np.float32)
    for i in range(front_samples.shape[0]):
        r, c = (2 * i) // cols, (2 * i) % cols
        fig[r * wh:(r + 1) * wh, c * wh:(c + 1) * wh] = front_samples[i]
        r, c = (2 * i + 1) // cols, (2 * i + 1) % cols
        fig[r * wh:(r + 1) * wh, c * wh:(c + 1) * wh] = rot_samples[i]
    return fig


def _result(out, i):
    """The outputs kept per image, as numpy."""
    return {"pose_mode": out["pose_rotmats_mode"][i],
            "shape_mean": out["shape_mean"][i],
            "cam": out["cam"][i],
            "per_vertex_uncertainty": out["per_vertex_3Dvar"][i]}


def _prefetch_images(image_dir, fnames):
    """Decode/load images on a background thread; yields (fname, uint8 HWC
    RGB). An exception in the thread is raised in the consumer.

    Input formats (extension-driven):
      .png/.jpg/.jpeg  cv2 decode (BGR -> RGB)
      .npy             one pre-decoded uint8 HWC RGB image (no decode)
      .npz             a pack of pre-decoded images: entry name = output
                       fname, value = uint8 HWC RGB (build with
                       data/pack_predict_inputs.py)
    npy yields are renamed *.png so the figures keep image extensions; npz
    entry names are used verbatim.
    """
    q = queue.Queue(maxsize=PREFETCH_DEPTH)
    end = object()

    def worker():
        try:
            for fname in fnames:
                path = os.path.join(image_dir, fname)
                if fname.endswith(".npy"):
                    q.put((fname[:-len(".npy")] + ".png",
                           np.ascontiguousarray(np.load(path))))
                elif fname.endswith(".npz"):
                    with np.load(path) as pack:
                        for key in pack.files:
                            q.put((key, pack[key]))
                else:
                    bgr = cv2.imread(path)
                    if bgr is None:
                        raise ValueError(f"{path}: cv2.imread failed "
                                         "(corrupt or unsupported image)")
                    q.put((fname, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _stream_chunks(image_dir, fnames, batch_size, pin):
    """Chunks of at most `batch_size` images of one resolution from
    _prefetch_images (which decodes on its thread): full chunks as they
    fill, then each resolution's remainder (not padded).

    :param pin: put each chunk's stack in page-locked memory (for an
        asynchronous copy to the card)
    :return: generator of (items [(fname, uint8 HWC)], stack (B, H, W, 3)
        uint8 tensor)
    """
    def stacked(items):
        stack = torch.from_numpy(np.stack([rgb for _, rgb in items]))
        return items, (stack.pin_memory() if pin else stack)

    accum = {}
    for fname, rgb in _prefetch_images(image_dir, fnames):
        items = accum.setdefault(rgb.shape[:2], [])
        items.append((fname, rgb))
        if len(items) == batch_size:
            yield stacked(items)
            accum[rgb.shape[:2]] = []
    for res in sorted(accum):
        if accum[res]:
            yield stacked(accum[res])


class _Fetch:
    """Device outputs on their way to the host: copies enqueued without
    waiting (into page-locked memory on the card), and an event after them,
    so that the host waits for this chunk's outputs only, not for work
    enqueued after it."""

    def __init__(self, tensors):
        self.host = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
        self.event = None
        if any(v.is_cuda for v in tensors.values()):
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self):
        if self.event is not None:
            count("host_syncs")
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


def _check_sample_mesh(mesh):
    """Whether this rank writes (no mesh, or rank 0); predict meshes hold
    the "sample" axis alone."""
    if mesh is None:
        return True
    if mesh.shape["data"] != 1:
        raise ValueError(f"predict shards the samples only; got {mesh.shape}")
    return mesh.is_main


def _list_inputs(image_dir):
    """The folder's inputs, sorted; refuses a .npy beside an image of the
    same stem (both would write <stem>.png)."""
    fnames = sorted(f for f in os.listdir(image_dir)
                    if f.endswith((".jpg", ".jpeg", ".png", ".npy", ".npz")))
    npy_as_png = {f[:-len(".npy")] + ".png" for f in fnames
                  if f.endswith(".npy")}
    collisions = npy_as_png.intersection(fnames)
    if collisions:
        raise ValueError(
            f"{image_dir}: pre-decoded .npy inputs collide with images of "
            f"the same stem ({sorted(collisions)[:5]}...): outputs would "
            "silently overwrite each other. Remove one of each pair (the "
            ".npy is a pre-decoded copy of the image, keep either).")
    return fnames


def _count_inputs(image_dir, fnames):
    """Images in the folder, counting an .npz pack's entries unread."""
    n = 0
    for f in fnames:
        if f.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(image_dir, f)) as z:
                n += len(z.namelist())
        else:
            n += 1
    return n


def predict_folder_batched(pose_shape_model, pose_shape_cfg, smpl_model,
                           hrnet, hrnet_cfg, edge_detect_model, image_dir,
                           save_dir, device, batch_size=8,
                           object_detect_fn=None, joints2Dvisib_threshold=0.75,
                           visualise_wh=512, save_vis=True,
                           visualise_uncropped=True, visualise_samples=False,
                           num_uncertainty_samples=50, mesh=None):
    """Folder prediction with B images per batched HRNet and core call, for
    every batch size (1 included) and with or without figures.

      * images are decoded on a thread and grouped by resolution into
        chunks of at most `batch_size` (the last of a resolution may be
        smaller: nothing here is compiled per shape, so nothing is padded);
        each chunk travels to the card as one uint8 stack;
      * dispatch is lag-one: chunk N+1's work is enqueued before chunk N's
        outputs are read on the host, and those outputs travel back behind
        an event of their own;
      * with save_vis=False no render is made, and the distribution and
        uncertainty outputs go to save_dir/outputs.npz (the serving path);
        with save_vis the 2 x 4 figure of each image is written, with
        `visualise_uncropped` its front render pasted into the photo
        (<name>_uncrop.png) and with `visualise_samples` the 3 x 6 samples
        figure (<name>_samples.png);
      * with a parallel `mesh` of the "sample" axis alone, the uncertainty
        samples split over its ranks; rank 0 alone renders and writes.

    :return: {fname: {pose_mode, shape_mean, cam, per_vertex_uncertainty}}
    """
    main = _check_sample_mesh(mesh)
    save_vis = save_vis and main
    fnames = _list_inputs(image_dir)
    os.makedirs(save_dir, exist_ok=True)
    renderer = (TexturedIUVRenderer(device, img_wh=visualise_wh,
                                    projection_type="orthographic",
                                    render_rgb=True)
                if save_vis else None)
    core = make_predict_core(
        pose_shape_model, pose_shape_cfg, smpl_model, edge_detect_model,
        renderer, hrnet_cfg, joints2Dvisib_threshold=joints2Dvisib_threshold,
        num_uncertainty_samples=num_uncertainty_samples, render_vis=save_vis,
        mesh=mesh)
    hrnet_batch = make_hrnet_batch_predictor(
        hrnet, hrnet_cfg, device,
        bbox_scale_factor=pose_shape_cfg.DATA.BBOX_SCALE_FACTOR)
    generator = torch.Generator(device=device).manual_seed(0)
    scale_factor = pose_shape_cfg.DATA.BBOX_SCALE_FACTOR
    proxy_size = pose_shape_cfg.DATA.PROXY_REP_SIZE
    wh = visualise_wh

    results = {}
    n_total = _count_inputs(image_dir, fnames)
    n_done = 0
    t_start = time.monotonic()
    t_first = None

    def dispatch(images):
        """Enqueue one chunk's work on the card; start its outputs home."""
        hr = hrnet_batch(images, object_detect_fn=object_detect_fn,
                         object_detect_threshold=pose_shape_cfg.DATA
                         .BBOX_THRESHOLD)
        out = core(hr["cropped_image"], hr["joints2D"], hr["joints2Dconfs"],
                   generator=generator)
        wanted = {k: out[k] for k in ("pose_rotmats_mode", "shape_mean", "cam",
                                      "per_vertex_3Dvar")}
        if save_vis:
            wanted.update(front=out["front"], rgb_views=out["rgb_views"],
                          cropped_vis=out["cropped_vis"],
                          proxy=out["proxy"].sum(dim=1),
                          cropped_joints2D=out["cropped_joints2D"],
                          joints2Dconfs=hr["joints2Dconfs"])
            if visualise_uncropped:
                # The box side in host float64, then float32.
                whs = (np.maximum(hr["bbox_heights"], hr["bbox_widths"])
                       * scale_factor).astype(np.float32)
                unc = uncrop_front(
                    out["rgb_views"], out["iuv_views"],
                    torch.as_tensor(hr["bbox_centres"], device=device),
                    torch.as_tensor(whs, device=device), images.shape[1:3])
                wanted.update(unc_rgb=unc["rgb"], unc_seg=unc["iuv"][:, 0])
            if visualise_samples:
                # Each image's samples figure from its own slices.
                fronts, rots = zip(*(samples_core(renderer, *(
                    out[k][i:i + 1] for k in (
                        "verts_samples", "joints_samples", "proxy", "cam",
                        "verts_mode", "verts_rot90", "cropped_vis",
                        "pred_cam_t", "pred_scale")))
                    for i in range(images.shape[0])))
                wanted.update(front_samples=torch.stack(fronts),
                              rot_samples=torch.stack(rots))
        return _Fetch(wanted)

    def materialize(items, fetch):
        nonlocal n_done, t_first
        out = fetch.numpy()
        if t_first is None:
            t_first = time.monotonic()
            print(f"First batch done in {t_first - t_start:.1f}s "
                  f"(includes warm-up).", flush=True)
        for i, (fname, _) in enumerate(items):
            results[fname] = _result(out, i)
        n_done += len(items)
        print(f"Predicted {n_done}/{n_total} images "
              f"({time.monotonic() - t_start:.1f}s elapsed).", flush=True)
        if not save_vis:
            return
        for i, (fname, orig_image) in enumerate(items):
            proxy = _proxy_with_joints(out["proxy"][i], out["cropped_joints2D"][i],
                                       out["joints2Dconfs"][i], proxy_size, wh)
            path = os.path.join(save_dir, fname)
            _write_rgb(path, _figure(
                out["cropped_vis"][i].transpose(1, 2, 0), proxy,
                out["front"][i].transpose(1, 2, 0), out["rgb_views"][i], wh))
            if visualise_uncropped:
                cv2.imwrite(os.path.splitext(path)[0] + "_uncrop.png",
                            _uncrop_composite(out["unc_rgb"][i],
                                              out["unc_seg"][i], orig_image))
            if visualise_samples:
                _write_rgb(os.path.splitext(path)[0] + "_samples.png",
                           _samples_figure(
                               out["front_samples"][i].transpose(0, 2, 3, 1),
                               out["rot_samples"][i], wh))

    pending = None
    for items, stack in _stream_chunks(image_dir, fnames, batch_size,
                                       pin=torch.device(device).type == "cuda"):
        fetch = dispatch(stack.to(device, non_blocking=True))
        if pending is not None:
            materialize(*pending)
        pending = (items, fetch)
    if pending is not None:
        materialize(*pending)

    t_end = time.monotonic()
    if t_first is not None and n_done > batch_size:
        steady = (n_done - batch_size) / max(t_end - t_first, 1e-9)
        print(f"Done: {n_done} images in {t_end - t_start:.1f}s "
              f"({steady:.1f} img/s steady-state after the first batch).",
              flush=True)

    if not save_vis and main:
        np.savez(os.path.join(save_dir, "outputs.npz"),
                 fnames=np.asarray(sorted(results)),
                 **{k: np.stack([results[f][k] for f in sorted(results)])
                    for k in ("pose_mode", "shape_mean", "cam",
                              "per_vertex_uncertainty")})
    return results
