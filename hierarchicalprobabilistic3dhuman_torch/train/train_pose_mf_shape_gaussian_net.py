"""Training driver: on-the-fly synthetic scenes and the two-stage
distribution loss, on one device.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/train/
train_pose_mf_shape_gaussian_net.py (make_synth_data_fn :64-183,
make_train_step :186-337 as TrainStep, train_pose_mf_shape_gaussian_net
:340-513):

  * the synthetic stage builds a batch where its tensors are: SMPL targets
    and reposed targets, COCO joints projected, random lights, the
    perspective textured render through ops/rasterizer_cuda.py (K1 and its
    boxes kernel on the card), the extreme crop, the jittered crop,
    visibility and occlusion, proxy and RGB augmentation, Canny and
    heatmaps; uint8 textures and backgrounds are normalised there;
  * a train step runs that stage under no_grad, then the predictor in train
    mode, its loss (stage 2 back-propagates the 2D-joint loss through the
    matrix-Fisher samples), backward and Adam; a val step runs in eval
    mode under no_grad; both compute the metric sums where the tensors are;
  * the loop switches stages at LOSS.STAGE_CHANGE_EPOCH, keeps one step in
    flight (step N is dispatched before step N-1's scalars are read),
    tracks the best weights, and saves the reference's checkpoint dict
    every EPOCHS_PER_SAVE epochs.

Every draw comes from a utils/random_draws.py source split as the JAX
driver splits its keys; a run uses one torch.Generator on its device.

On a parallel Mesh (JAX's make_train_step(mesh=...) :186-267 and loop
:405-477) every rank gets the same global batch from its loader and the
same draws, and:
  * runs the synthetic stage on the whole batch, then keeps its rows (the
    synthetic stage is duplicated on every rank; JAX shards it);
  * in stage 2 draws the sampler's proposals for the whole batch, keeps
    its rows, runs the sampler on all N x 8 lanes of them, then keeps its
    part of the N samples: only the SMPL of the samples is split over
    "sample", as JAX constrains the samples only after the sampler;
  * holds the 2D joints of its samples, and of the mode on sample index 0
    alone, so each 2D-joint set of the global batch is counted once;
  * back-propagates its share of the global loss (losses/) through the
    predictor's DDP, whose BatchNorms are synced over "data";
  * returns the global loss, terms and metric sums, all-reduced.
Rank 0 alone writes the checkpoints and log.pkl; the others wait.
"""

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.data.loader import DataLoader
from hierarchicalprobabilistic3dhuman_torch.losses import PoseMFShapeGaussianLoss
from hierarchicalprobabilistic3dhuman_torch.metrics import (
    TrainingLossesAndMetricsTracker)
from hierarchicalprobabilistic3dhuman_torch.metrics.train_loss_and_metrics_tracker import (
    all_reduce_sums)
from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
    make_metric_sums_fn)
from hierarchicalprobabilistic3dhuman_torch.ops.bingham_sampling import (
    pose_matrix_fisher_sampling, shape_gaussian_sampling)
from hierarchicalprobabilistic3dhuman_torch.parallel.sharded_train import (
    data_parallel, make_sharded_train_step)
from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
    checkpoint_path, load_training_info_from_checkpoint,
    save_training_checkpoint, state_dict_on_cpu)
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation.cam_augmentation import (
    augment_cam_t)
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation.lighting_augmentation import (
    augment_light)
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation.proxy_rep_augmentation import (
    augment_proxy_representation, random_extreme_crop)
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation.rgb_augmentation import (
    augment_rgb)
from hierarchicalprobabilistic3dhuman_torch.utils.augmentation.smpl_augmentation import (
    normal_sample_shape)
from hierarchicalprobabilistic3dhuman_torch.utils.cam_utils import (
    orthographic_project, perspective_project)
from hierarchicalprobabilistic3dhuman_torch.utils.image_utils import (
    batch_add_rgb_background, batch_crop_affine)
from hierarchicalprobabilistic3dhuman_torch.utils.joints2d_utils import (
    check_joints2d_occluded, check_joints2d_visibility)
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP, ALL_JOINTS_TO_H36M_MAP, H36M_TO_J14,
    convert_2Djoints_to_gaussian_heatmaps_batched,
    convert_densepose_seg_to_14part_labels)
from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
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
    """One step: synthetic batch -> forward -> loss (-> backward and Adam);
    the JAX package's make_train_step.

    `synth` and `forward_loss` are the stages, also called on their own
    (timings, tests). Calling the step returns (loss, metric_sums, terms)
    with metrics_to_track, else (loss, metric_data, targets, terms); the
    tensors stay on the device. parallel/make_sharded_train_step sets
    `mesh` (and `ddp`, the predictor's DistributedDataParallel, on a train
    step): the step then takes the global batch and returns the global
    loss, terms and sums (metric_data and targets stay this rank's rows).
    """

    mesh = None
    ddp = None

    def __init__(self, pose_shape_model, pose_shape_cfg, smpl_model, renderer,
                 edge_detect_model, loss_stage_cfg, optimizer, train,
                 metrics_to_track=None):
        self.model = pose_shape_model
        self.smpl_model = smpl_model
        self.optimizer = optimizer
        self.train = train
        D = pose_shape_cfg.DATA.PROXY_REP_SIZE
        self.synth = make_synth_data_fn(pose_shape_cfg, smpl_model, renderer,
                                        edge_detect_model)
        self.criterion = PoseMFShapeGaussianLoss(loss_stage_cfg, img_wh=D)
        self.j2d_loss_on = loss_stage_cfg.J2D_LOSS_ON
        self.num_samples = pose_shape_cfg.LOSS.NUM_SAMPLES
        self.metric_sums = (None if metrics_to_track is None
                            else make_metric_sums_fn(metrics_to_track, D))

    def forward_loss(self, draws, proxy, targets):
        """:return: loss, metric data (the mode's outputs and, in stage 2,
        the samples' 2D joints), the unweighted loss terms"""
        B = proxy.shape[0]
        N = self.num_samples
        smpl = self.smpl_model
        mesh = self.mesh
        mode_here = mesh is None or mesh.sample_index == 0
        pred = (self.model if self.ddp is None else self.ddp)(proxy)

        pred_glob_rotmats = rot6d_to_rotmat(pred["glob"])
        mode = smpl(body_pose=pred["pose_rotmats_mode"],
                    global_orient=pred_glob_rotmats[:, None],
                    betas=pred["shape_mean"], pose2rot=False)
        joints_all = mode["joints"]
        joints_h36mlsp = joints_all[:, H36M_J14]
        joints_coco = aa_rotate_translate_points(
            joints_all[:, ALL_JOINTS_TO_COCO_MAP], X_AXIS, np.pi, ZERO_T)
        j2d_mode = orthographic_project(joints_coco, pred["cam"])   # [-1, 1]

        j2d_samples = None
        j2d_mode_sets = j2d_mode[:, None] if mode_here else j2d_mode[:, None][:, :0]
        if "samples" in self.j2d_loss_on:
            draws_pose, draws_shape = draws.split(2)
            draws_eps, draws_w = draws_pose.split(2)
            J, lanes = pred["pose_params_U"].shape[1], N * OVERSAMPLING
            shape_mean = pred["shape_mean"]
            # The global batch's draws, in the 1-rank order; this rank's rows.
            B_all = B if mesh is None else B * mesh.shape["data"]
            eps = draws_eps.normal((B_all, J, lanes, 4))
            w = draws_w.uniform((B_all, J, lanes))
            shape_eps = draws_shape.normal((B_all, N, shape_mean.shape[1]))
            if mesh is not None:
                eps, w, shape_eps = (mesh.take_rows(t) for t in (eps, w, shape_eps))
            pose_samples = pose_matrix_fisher_sampling(
                pred["pose_params_U"], pred["pose_params_S"],
                pred["pose_params_V"], N, b=1.5,
                oversampling_ratio=OVERSAMPLING, eps=eps, w=w)
            if mesh is not None:    # this rank's samples, after the sampler
                own = mesh.samples(N)
                pose_samples, shape_eps = pose_samples[:, own], shape_eps[:, own]
            n = pose_samples.shape[1]
            shape_samples = shape_gaussian_sampling(
                shape_mean, torch.exp(pred["shape_log_std"]), n, eps=shape_eps)
            flat = smpl(body_pose=pose_samples.reshape(B * n, J, 3, 3),
                        global_orient=pred_glob_rotmats[:, None, None]
                        .expand(B, n, 1, 3, 3).reshape(B * n, 1, 3, 3),
                        betas=shape_samples.reshape(B * n, -1),
                        pose2rot=False)["joints"][:, ALL_JOINTS_TO_COCO_MAP]
            flat = aa_rotate_translate_points(flat, X_AXIS, np.pi, ZERO_T)
            cam_rep = pred["cam"].repeat_interleave(n, dim=0)
            j2d_samples = orthographic_project(flat, cam_rep).reshape(B, n, -1, 2)
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
        loss, terms = self.criterion(targets, pred_dict, mesh=mesh,
                                     j2d_sets=j2d_sets)
        metric_data = {
            "verts": mode["vertices"],
            "joints3D": joints_h36mlsp,
            "joints2D": j2d_mode,
            "glob_rotmats": pred_glob_rotmats,
            "shape_mean": pred["shape_mean"],
        }
        if j2d_samples is not None:
            metric_data["joints2Dsamples"] = j2d_samples
        return loss, metric_data, terms

    def __call__(self, draws, pose, background, texture):
        draws_synth, draws_fwd = draws.split(2)
        mesh = self.mesh
        # The synthetic batch carries no parameter dependence.
        with torch.no_grad():
            proxy, targets = self.synth(draws_synth, pose, background, texture)
            if mesh is not None:
                proxy, targets = mesh.take_rows(proxy), mesh.take_rows(targets)
        if self.train:
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            loss, metric_data, terms = self.forward_loss(draws_fwd, proxy, targets)
            # DDP averages the ranks' gradients; the shares' gradients sum
            # to the global one.
            (loss if self.ddp is None else loss * mesh.size).backward()
            self.optimizer.step()
        else:
            self.model.eval()
            with torch.no_grad():
                loss, metric_data, terms = self.forward_loss(draws_fwd, proxy,
                                                             targets)
        with torch.no_grad():
            metric_data = {k: v.detach() for k, v in metric_data.items()}
            terms = {k: v.detach() for k, v in terms.items()}
            # Reposed mean vertices for the PVE-T metrics.
            reposed_mean = self.smpl_model(
                betas=metric_data["shape_mean"])["vertices"]
            metric_data["reposed_verts"] = reposed_mean
            loss = loss.detach()
            if mesh is not None:
                names = list(terms)
                total = mesh.all_reduce(torch.stack([loss] + [terms[k] for k in names]))
                loss, terms = total[0], dict(zip(names, total[1:]))
            if self.metric_sums is not None:
                sums = self.metric_sums(metric_data, targets, reposed_mean,
                                        targets["reposed_verts"])
                if mesh is not None:
                    sums = all_reduce_sums(mesh, sums)
                return loss, sums, terms
        return loss, metric_data, targets, terms


def batch_to_device(batch, device):
    """A loader batch's pose, background and texture as tensors on the
    device; on the card through pinned memory, copied asynchronously."""
    out = []
    for key in ("pose", "background", "texture"):
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        out.append(t.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" else t)
    return out


def train_pose_mf_shape_gaussian_net(pose_shape_model,
                                     pose_shape_cfg,
                                     smpl_model,
                                     edge_detect_model,
                                     renderer,
                                     train_dataset,
                                     val_dataset,
                                     optimizer,
                                     metrics,
                                     model_save_dir,
                                     logs_save_path,
                                     device,
                                     save_val_metrics=("PVE-SC", "MPJPE-PA"),
                                     checkpoint=None,
                                     rng_seed=0,
                                     num_epochs=None,
                                     loaders=None,
                                     mesh=None):
    """The training loop. The model's and the optimiser's state are resumed
    by the caller; `checkpoint` gives the epoch and best-weights
    bookkeeping. Returns the best weights' state dict (on the CPU).

    :param loaders: optional {"train": iterable, "val": iterable} of dict
        batches (pose/texture/background numpy arrays) in place of the
        default DataLoaders
    :param mesh: optional parallel Mesh: every rank's loaders give the same
        global batches, each step runs sharded (see the module docstring),
        and rank 0 alone writes checkpoints and log.pkl
    """
    cfg = pose_shape_cfg
    save_val_metrics = list(save_val_metrics)
    num_epochs = num_epochs or cfg.TRAIN.NUM_EPOCHS
    main = mesh is None or mesh.is_main
    ddp = None
    if mesh is not None:
        n_data = mesh.shape["data"]
        assert cfg.TRAIN.BATCH_SIZE % n_data == 0, (
            f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} must divide the mesh "
            f"data axis ({n_data})")
        ddp = data_parallel(pose_shape_model, mesh)
    if loaders is None:
        loaders = {
            "train": DataLoader(train_dataset, batch_size=cfg.TRAIN.BATCH_SIZE,
                                shuffle=True, drop_last=True,
                                num_workers=cfg.TRAIN.NUM_WORKERS, seed=rng_seed),
            "val": DataLoader(val_dataset, batch_size=cfg.TRAIN.BATCH_SIZE,
                              shuffle=True, drop_last=True,
                              num_workers=cfg.TRAIN.NUM_WORKERS, seed=rng_seed + 1),
        }

    if checkpoint is not None:
        current_epoch, best_epoch, best_model_wts, best_epoch_val_metrics = \
            load_training_info_from_checkpoint(checkpoint, save_val_metrics)
        load_logs = True
    else:
        current_epoch = 0
        best_epoch = 0
        best_epoch_val_metrics = {m: float("inf") for m in save_val_metrics}
        best_model_wts = state_dict_on_cpu(pose_shape_model)
        load_logs = False

    tracker = TrainingLossesAndMetricsTracker(
        metrics_to_track=list(metrics), img_wh=cfg.DATA.PROXY_REP_SIZE,
        log_save_path=logs_save_path, load_logs=load_logs,
        current_epoch=current_epoch, save_logs=main)

    steps = {}
    for stage, stage_cfg in ((1, cfg.LOSS.STAGE1), (2, cfg.LOSS.STAGE2)):
        stage_metrics = list(metrics)
        if stage == 2 and "joints2Dsamples-L2E" not in stage_metrics:
            stage_metrics.append("joints2Dsamples-L2E")
        for split in ("train", "val"):
            step = TrainStep(
                pose_shape_model, cfg, smpl_model, renderer, edge_detect_model,
                stage_cfg, optimizer, train=(split == "train"),
                metrics_to_track=stage_metrics)
            if mesh is not None:
                step = make_sharded_train_step(step, mesh, ddp)
            steps[(stage, split)] = step

    draws = Draws(torch.Generator(device=device).manual_seed(rng_seed))
    current_loss_stage = 1
    for epoch in range(current_epoch, num_epochs):
        print(f"\nEpoch {epoch}/{num_epochs - 1}")
        print("-" * 10)
        tracker.initialise_loss_metric_sums()

        if epoch >= cfg.LOSS.STAGE_CHANGE_EPOCH and current_loss_stage == 1:
            current_loss_stage = 2
            if "joints2Dsamples-L2E" not in tracker.metrics_to_track:
                tracker.metrics_to_track.append("joints2Dsamples-L2E")
            print("Stage 2 loss config active. Tracking:", tracker.metrics_to_track)

        for split in ("train", "val"):
            step = steps[(current_loss_stage, split)]
            # Reading a loss blocks until the card has finished its step:
            # keep one step in flight and account for step N-1 after
            # dispatching step N.
            pending = None

            def resolve(p):
                p_split, p_loss, p_sums, p_bs = p
                tracker.update_per_batch_sums(
                    split=p_split, loss=float(p_loss), batch_size=p_bs,
                    metric_sums={k: float(v) for k, v in p_sums.items()})

            for batch in loaders[split]:
                loss, metric_sums, _ = step(draws, *batch_to_device(batch, device))
                if pending is not None:
                    resolve(pending)
                pending = (split, loss, metric_sums, batch["pose"].shape[0])
            if pending is not None:
                resolve(pending)

        tracker.update_per_epoch()

        if tracker.determine_save_model_weights_this_epoch(save_val_metrics,
                                                           best_epoch_val_metrics):
            for metric in save_val_metrics:
                best_epoch_val_metrics[metric] = \
                    tracker.epochs_history["val_" + metric][-1]
            best_model_wts = state_dict_on_cpu(pose_shape_model)
            best_epoch = epoch
            print("Best model weights updated:", best_epoch_val_metrics)

        if epoch % cfg.TRAIN.EPOCHS_PER_SAVE == 0 and main:
            save_training_checkpoint(
                checkpoint_path(model_save_dir, epoch),
                epoch=epoch, best_epoch=best_epoch,
                best_epoch_val_metrics=best_epoch_val_metrics,
                model_state_dict=state_dict_on_cpu(pose_shape_model),
                best_model_state_dict=best_model_wts,
                optimiser_state_dict=optimizer.state_dict())
            print(f"Model saved! Best val metrics: {best_epoch_val_metrics} "
                  f"in epoch {best_epoch}")
        if mesh is not None:
            mesh.barrier()

    print("Training completed. Best val metrics:", best_epoch_val_metrics)
    return best_model_wts
