"""Evaluation driver for the 3DPW / SSP-3D benchmarks, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/evaluate/
evaluate_pose_mf_shape_gaussian_net.py (_ReorderedDataset :42,
_make_eval_step :71, evaluate_pose_mf_shape_gaussian_net :294), itself the
behavioural equivalent of the reference's evaluate/
evaluate_poseMF_shapeGaussian_net.py:19-258:

  * one step per batch computes the proxy representation, the gendered
    targets, the prediction, the samples, the joints-2D projections and the
    silhouettes, on the batch's device;
  * batch size > 1 is supported everywhere (the reference is locked to 1);
    the dataset is iterated gender-sorted so almost every batch runs the
    single-gender step, and a mixed batch runs smpl_forward_mixed;
  * the N per-sample silhouettes are one batched render: each SSP-3D batch
    makes two rasterizer calls, B mode meshes then B*N sample meshes, 256^2
    orthographic with the 3 IUV attributes (the CUDA kernel on the card);
  * the mode is injected as sample 0, matching the reference (:172-179);
  * per-frame metrics are computed on the device (metrics/metric_sums.py)
    unless on_device_metrics=False, which fetches the tensors to the host
    tracker as the reference does.

Sampling draws come from a torch.Generator seeded with RNG_SEED, one set per
batch (sample_draws), where the JAX driver splits its key once per batch.

On a parallel Mesh (JAX's mesh= at :74-108, :226-256, :282, :328-332) every
rank loads the same global batch and draws; the step runs on this rank's
rows (parallel/make_sharded_eval_step) and, of each row's N samples, on
this rank's part, split after the sampler ran on all N x 8 lanes; the mode
stays sample 0 on sample index 0. The best-sample metrics take the
minimum over the samples gathered from "sample", the sample sums are
summed over the world, and the per-frame values come back over "data" in
frame order, so every rank's tracker sees the global batch. A batch size
that does not divide the data axis raises (JAX's CLI quietly drops the
mesh then, cli/evaluate.py:122-124). Rank 0 alone writes the per-frame
files.
"""

import os

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.data.loader import DataLoader
from hierarchicalprobabilistic3dhuman_torch.metrics import EvalMetricsTracker
from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
    make_eval_frame_metrics_fn)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import (
    NUM_BODY_JOINTS, smpl_forward_mixed)
from hierarchicalprobabilistic3dhuman_torch.ops.bingham_sampling import (
    pose_matrix_fisher_sampling, shape_gaussian_sampling)
from hierarchicalprobabilistic3dhuman_torch.parallel.sharded_train import (
    make_sharded_eval_step)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer)
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import count, span
from hierarchicalprobabilistic3dhuman_torch.utils.cam_utils import (
    orthographic_project)
from hierarchicalprobabilistic3dhuman_torch.utils.joints2d_utils import (
    undo_keypoint_normalisation)
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP, ALL_JOINTS_TO_H36M_MAP, H36M_TO_J14)
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
    aa_rotate_translate_points, batch_rodrigues, rot6d_to_rotmat, so3_exp)

_X_FLIP = np.pi
X_AXIS = (1.0, 0.0, 0.0)
ZERO_T = (0.0, 0.0, 0.0)
# Proposals per requested sample of the matrix-Fisher sampler, and its b.
OVERSAMPLING = 8
BINGHAM_B = 1.5
# The samples' generator seed (the JAX driver's rng_seed default).
RNG_SEED = 0

_GENDER_CODES = {"n": 0, "neutral": 0, "m": 1, "male": 1, "f": 2, "female": 2}

# Per-frame values the host keeps when the metrics run on the device.
_DUMP_KEYS = ("frame_metrics", "pred_glob_rotmats", "pred_pose_rotmats_mode",
              "pred_shape_mean", "pred_cam")


class _ReorderedDataset:
    """Index-permutation view of a dataset; items gain 'orig_index' so
    per-frame artifacts can be restored to dataset order after the
    gender-sorted pass."""

    def __init__(self, dataset, order):
        self.dataset = dataset
        self.order = np.asarray(order)

    def __len__(self):
        return len(self.order)

    def __getitem__(self, index):
        orig = int(self.order[index])
        item = dict(self.dataset[orig])
        item["orig_index"] = orig
        return item


def gender_codes(genders):
    """Dataset gender labels ('m', 'female', ...) -> int32 codes: 0 neutral
    (and anything unknown), 1 male, 2 female."""
    return np.array([_GENDER_CODES.get(str(g).strip(), 0) for g in genders],
                    np.int32)


def _dataset_gender_codes(eval_dataset):
    """(len,) int32 gender codes from the dataset's label array, or None."""
    genders = getattr(eval_dataset, "gender",
                      getattr(eval_dataset, "genders", None))
    return None if genders is None else gender_codes(genders)


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
                   frame_metrics_fn=None, mesh=None):
    """Build the per-batch evaluation function.

    static_gender (None | 0 | 1 | 2): when the whole batch shares one gender
    (the driver gender-sorts the dataset so this is the common case), only
    that gender's SMPL targets are computed; None runs smpl_forward_mixed.

    frame_metrics_fn (metric_sums.make_eval_frame_metrics_fn result): when
    given, the per-frame metric values are computed in the step and
    returned under out["frame_metrics"], and the bulky vertex, sample and
    silhouette tensors are dropped from the outputs.

    mesh (a parallel Mesh): the step takes the global batch and its draws
    and returns every frame's outputs on every rank (see the module
    docstring); frame_metrics_fn must then be built with the same mesh.

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
            mode_here = True
            if mesh is not None:    # this rank's samples, after the sampler
                own = mesh.samples(num_samples)
                pose_samples, shape_eps = pose_samples[:, own], shape_eps[:, own]
                mode_here = own.start == 0
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
            if mode_here:
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
        elif mesh is not None:
            # The host tracker takes every sample: gather them over "sample".
            sizes = mesh.sample_sizes(num_samples)
            out = {k: (mesh.all_gather(v, "sample", dim=1, sizes=sizes)
                       if "samples" in k else v) for k, v in out.items()}
        return out

    if mesh is not None:
        _step = make_sharded_eval_step(_step, mesh)

    def step(*args):
        with span("eval.step"), torch.inference_mode():
            return _step(*args)

    return step


def _to_host(tree):
    """Tensors (in nested dicts) -> numpy arrays; each copy a blocking
    read (counter `host_syncs`)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    count("host_syncs")
    return tree.detach().cpu().numpy()


def evaluate_pose_mf_shape_gaussian_net(pose_shape_model,
                                        pose_shape_cfg,
                                        smpl_neutral,
                                        smpl_male,
                                        smpl_female,
                                        edge_detect_model,
                                        metrics,
                                        eval_dataset,
                                        device,
                                        batch_size=1,
                                        num_workers=2,
                                        num_samples_for_metrics=10,
                                        save_path=None,
                                        save_per_frame_metrics=False,
                                        sort_by_gender=True,
                                        on_device_metrics=True,
                                        mesh=None):
    """Run evaluation; prints final metrics and returns them as a dict.

    :param pose_shape_model: the distribution predictor, in eval mode, on
        `device`, as are the SMPL models and the edge detector
    :param sort_by_gender: iterate the dataset grouped by gender so almost
        every batch is single-gender and runs a step with ONE target-SMPL
        forward. Metric sums are order-invariant; per-frame npy dumps are
        restored to dataset order before saving.
    :param on_device_metrics: compute the per-frame metrics in the step and
        fetch a few numbers per frame, instead of fetching the vertex,
        sample and silhouette tensors to the host tracker (the reference
        behaviour, kept under on_device_metrics=False).
    :param mesh: optional parallel Mesh: the dataset batch shards over
        "data" and the samples over "sample" (see the module docstring);
        the batch size must divide the data axis
    """
    if mesh is not None:
        n_data = mesh.shape["data"]
        if batch_size % n_data:
            raise ValueError(
                f"batch_size={batch_size} must divide the mesh data axis "
                f"({n_data}) for dataset-sharded eval")
    main = mesh is None or mesh.is_main
    dataset_codes = _dataset_gender_codes(eval_dataset) if sort_by_gender else None
    sorted_pass = dataset_codes is not None and len(np.unique(dataset_codes)) > 1
    if sorted_pass:
        # drop_last=True drops the DATASET-ORDER tail; gender-sorting must
        # not change WHICH frames are evaluated, only their order — so
        # truncate to a batch multiple in dataset order first, then sort.
        n_keep = (len(eval_dataset) // batch_size) * batch_size
        eval_dataset = _ReorderedDataset(
            eval_dataset, np.argsort(dataset_codes[:n_keep], kind="stable"))
    loader = DataLoader(eval_dataset, batch_size=batch_size, shuffle=False,
                        drop_last=True, num_workers=num_workers)

    D = pose_shape_cfg.DATA.PROXY_REP_SIZE
    save_per_frame_metrics = save_per_frame_metrics and main
    tracker = EvalMetricsTracker(metrics, img_wh=D, save_path=save_path,
                                 save_per_frame_metrics=save_per_frame_metrics)
    tracker.initialise_metric_sums()
    tracker.initialise_per_frame_metric_lists()

    compute_joints2d = any("joints2D" in m for m in metrics)
    compute_silhouettes = any("silhouette" in m for m in metrics)
    compute_samples = any("samples" in m for m in metrics)
    silhouette_renderer = (TexturedIUVRenderer(device, img_wh=D,
                                               projection_type="orthographic",
                                               render_rgb=False)
                           if compute_silhouettes else None)
    frame_metrics_fn = (make_eval_frame_metrics_fn(
        metrics, mesh=mesh, num_samples=num_samples_for_metrics)
        if on_device_metrics else None)

    steps = {}

    def get_step(static_gender):
        if static_gender not in steps:
            steps[static_gender] = make_eval_step(
                pose_shape_model, smpl_neutral, smpl_male, smpl_female,
                edge_detect_model, pose_shape_cfg, num_samples_for_metrics,
                compute_joints2d, compute_silhouettes, compute_samples,
                silhouette_renderer, static_gender=static_gender,
                frame_metrics_fn=frame_metrics_fn, mesh=mesh)
        return steps[static_gender]

    generator = torch.Generator(device=device).manual_seed(RNG_SEED)
    num_betas = pose_shape_cfg.MODEL.NUM_SMPL_BETAS

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    fname_per_frame, pose_per_frame, shape_per_frame, cam_per_frame = [], [], [], []
    orig_index_per_frame = []

    for batch in loader:
        B = batch["image"].shape[0]
        gender_code = gender_codes(batch["gender"])
        uniq = np.unique(gender_code)
        step = get_step(int(uniq[0]) if len(uniq) == 1 else None)
        draws = (sample_draws(generator, B, num_samples_for_metrics, num_betas,
                              device) if compute_samples else None)
        # A requested joints2D/silhouette metric with no ground truth in the
        # batch must fail loudly; zero-filling is only a placeholder for
        # metric sets that never read these tensors.
        if compute_joints2d and "keypoints" not in batch:
            raise KeyError(
                "joints2D metrics requested but the dataset batch has no "
                "'keypoints' ground truth")
        if compute_silhouettes and "silhouette" not in batch:
            raise KeyError(
                "silhouette metrics requested but the dataset batch has no "
                "'silhouette' ground truth")
        target_j2d = tensor(batch.get("keypoints", np.zeros((B, 17, 2))))
        target_sil = tensor(batch.get("silhouette", np.zeros((B, D, D))))
        out = _to_host(step(draws, tensor(batch["image"]), tensor(batch["heatmaps"]),
                            tensor(batch["pose"]), tensor(batch["shape"]),
                            torch.as_tensor(gender_code, device=device),
                            target_j2d, target_sil))

        if on_device_metrics:
            tracker.update_per_batch_device(out["frame_metrics"], B)
        else:
            pred_dict = {"verts": out["pred_verts"],
                         "reposed_verts": out["pred_reposed_verts"],
                         "joints3D": out["pred_joints3D"]}
            target_dict = {"verts": out["target_verts"],
                           "reposed_verts": out["target_reposed_verts"],
                           "joints3D": out["target_joints3D"]}
            if "joints2D-L2E" in metrics:
                pred_dict["joints2D"] = out["pred_joints2D"]
                target_dict["joints2D"] = np.asarray(batch["keypoints"])
            if "silhouette-IOU" in metrics:
                pred_dict["silhouettes"] = out["pred_silhouettes"]
                target_dict["silhouettes"] = np.asarray(batch["silhouette"])
            if compute_samples:
                pred_dict["verts_samples"] = out["pred_verts_samples"]
                pred_dict["reposed_verts_samples"] = out["pred_reposed_verts_samples"]
                pred_dict["joints3D_samples"] = out["pred_joints3D_samples"]
            if "joints2Dsamples-L2E" in metrics:
                pred_dict["joints2Dsamples"] = out["pred_joints2Dsamples"]
            if "silhouettesamples-IOU" in metrics:
                pred_dict["silhouettessamples"] = out["pred_silhouettessamples"]
            tracker.update_per_batch(pred_dict, target_dict, B)

        if save_per_frame_metrics:
            fname_per_frame.append(np.asarray(batch["fname"]))
            pose_per_frame.append(np.concatenate(
                [out["pred_glob_rotmats"][:, None], out["pred_pose_rotmats_mode"]],
                axis=1))
            shape_per_frame.append(out["pred_shape_mean"])
            cam_per_frame.append(out["pred_cam"])
        if sorted_pass:
            orig_index_per_frame.append(np.asarray(batch["orig_index"]))

    restore = None
    if sorted_pass and orig_index_per_frame:
        restore = np.argsort(np.concatenate(orig_index_per_frame, axis=0),
                             kind="stable")
    final_metrics = tracker.compute_final_metrics(frame_order=restore)

    if save_per_frame_metrics and save_path is not None:
        arrays = {"fname_per_frame": np.concatenate(fname_per_frame, axis=0),
                  "pose_per_frame": np.concatenate(pose_per_frame, axis=0),
                  "shape_per_frame": np.concatenate(shape_per_frame, axis=0),
                  "cam_per_frame": np.concatenate(cam_per_frame, axis=0)}
        if restore is not None:
            arrays = {k: v[restore] for k, v in arrays.items()}
        for name, arr in arrays.items():
            np.save(os.path.join(save_path, f"{name}.npy"), arr)
    if mesh is not None:
        mesh.barrier()
    return final_metrics
