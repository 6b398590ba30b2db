#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build the CUDA rasterizer from csrc/ and print the card's name and
     power limit;
  2. hold the rasterizer kernel against its plain torch version on the card
     (mask and depth bit-equal, attrs within 1e-5), and the face_boxes kernel
     that packs its fourth table against its own (boxes equal): 6 synthetic-SMPL meshes
     at 512^2, A=12, as the renderer packs them (run twice: the outputs must
     be identical); a hand-made scene of shared edges and equal-depth ties
     (all outputs equal); a scene of slivers, off-screen faces and a face
     larger than the image; and the evaluation shape, 1 mesh at 256^2, A=3
     (the training shape is phase 7's);
  3. drive the main path through the user's entry point,
     `run_predict_torch.py --cropped_images` on 3 demo photos at full width
     (HRNet-W48, ResNet-18, 50 samples, 512^2 renders, random weights), with
     the kernels' launch counters read around it (one launch of each per
     image), and
     check its figures and outputs; then check the predict core on the card
     against the same core on the CPU (plain rasterizer) on small inputs from
     3 seeds, with the kernel given the CPU's own tables, and report why
     colours differ where they do;
  4. time the per-image predict and its stages; the kernel at the predict
     and evaluation shapes beside its bound at each (the bytes it must move
     and the pixel-face tests the function needs); the device launches of
     one kernel call, counted from a profile; the rasterize step (tables +
     kernel) and its parts on the host's clock and the card's, at the
     predict shape; and the kernel's plain version at the predict shape;
  5. the batched and figure paths, each driven with the launch counts set
     to 0 just before it and read just after: (a) both kernels against their
     plain versions on the tables of the batched figure's render (4 images,
     24 meshes at 512^2) and of the samples figure's (18 meshes), built by
     the path from one batched HRNet + core call; (b) `run_predict_torch.py
     --batch_size 4 --no_vis` on the 12 demo photos (no launch,
     outputs.npz, outputs within 1e-4 of the per-image driver's); (c) the
     same with figures and uncrops (one launch of each kernel a chunk); (d)
     the per-image samples and uncrop figures on one photo (two launches);
     (e) a demo photo pasted into a 960x720 canvas through both keypoint
     detectors (boxes on the card within 1 px of the CPU's, same weights),
     and through the batched --no_vis driver with the single-person one
     (box and outputs within 1e-4 of the per-image driver's); (f) the
     kernels at the two new shapes beside their bounds, --no_vis img/s at
     batch 1, 4 and 8 and with the bfloat16 HRNet, ms/image with figures at
     batch 4 on one chunk, a chunk's HRNet and core times and launches, and
     the bfloat16 HRNet against float32;
  6. the evaluation entry point at full width (ResNet-18 on the 256^2 proxy,
     10 samples, SSP-3D's six metrics, random weights saved as a reference
     .tar so --svd_impl auto takes the LAPACK-sign SVD, synthetic SMPL), on
     synthetic SSP-3D and 3DPW folders of the 512^2 demo photos (16
     frames): (a) both kernels against their plain versions on one batch's
     silhouette tables, 8 mode meshes and 80 sample meshes at 256^2, A=3;
     (b) `run_evaluate_torch.py --dataset ssp3d` at batch 8 and at batch 1
     (4 frames), two launches of each kernel a batch, finite metrics and
     per-frame files in dataset order; (c) the eval step on the card against
     the CPU (3D metrics within 1e-4 relative, IOUs within 2e-3); (d)
     `--dataset 3dpw`, no launch; (e) frames/s at batch 1 and 8, one step's
     profile, the predictor with each 3x3 SVD, the kernels at the two eval
     shapes beside their bounds; (f) the LAPACK-sign SVD on the card
     against the CPU on 2,000 matrices;
  7. training at full width (ResNet-18 on the 256^2 proxy, EMBED_DIM 256,
     batch 72, 8 samples in stage 2, random weights, synthetic SMPL and the
     synthetic fallback dataset's poses, backgrounds and 1200 x 800 uint8
     atlases): (a) both kernels against their plain versions on one
     stage-1 batch's render tables, built by the driver's
     make_synth_data_fn (72 meshes at 256^2, A=12, perspective); (b)
     `run_train_torch.py -O LOSS.STAGE_CHANGE_EPOCH 1 --num_epochs 2` (4
     train and 2 val steps an epoch, stage 1 then stage 2; one launch of
     each kernel a step, 12), its log.pkl and epoch_000.tar (the
     reference's keys, loaded strict=True), then `-R 0` (epoch 1 again, 6
     launches); (c) a stage-2 step at B=4, 64^2 on the card against the
     CPU (the same weights, draws, proxy and targets), and the card's
     synthetic batch against the CPU's; (d) train img/s per stage at B=72,
     the step split into synth / forward / backward / Adam, launches and
     the busy share from a profile, the upload of a loader batch, and the
     kernels at the path's tables beside their bounds and plain versions;
  8. the ResNet-50 predictor (MODEL.NUM_RESNET_LAYERS 50, full width) and
     the JAX package's checkpoint layouts: (a) `run_train_torch.py -O
     MODEL.NUM_RESNET_LAYERS 50 LOSS.STAGE_CHANGE_EPOCH 1 --num_epochs 2`
     at B=72 (12 launches of each kernel), its experiment checked as in
     7b, and both kernels held to their plain versions on the tables of
     the run's last render; (b) its epoch 1 written in the JAX package's
     layout (a pickle with optax's state, by the port's writer) into a
     second experiment, `-R 1` there (6 launches), and one step resumed
     from that file against one resumed from the reference-layout file
     (loss and weights within 1e-6 relative); (c) `run_predict_torch.py`
     on 3 demo photos and `run_evaluate_torch.py --dataset ssp3d
     --batch_size 8` on phase 6's folder, each with the same ResNet-50
     weights as a reference .tar and as flax variables written by the
     port's save_variables (outputs, metrics and per-frame files within
     1e-6); (d) train img/s per stage at B=72 with the split, launches and
     busy share as in 7d, SSP-3D frames/s at batch 8, the load time of
     each checkpoint format, and K1 on 8a's tables beside its bound;
  9. the training data path at full width (ResNet-18 as in phase 7,
     random weights, synthetic SMPL): (a) synthetic source files in the
     real ones' shapes (432 poses as train/val npz files of 288 and 144; a
     textures npz of 8 grey and 40 non-grey 1200 x 800 atlases; 160 train
     and 40 val background jpgs of 640 x 480), packed by the port's
     pack_training_stores into train/ and val/ with per-vertex texels (the
     three counts differ on purpose), the sampler built with g++; (b)
     `run_train_torch.py -O LOSS.STAGE_CHANGE_EPOCH 1 --num_epochs 2
     --native_data_dir` (12 launches of each kernel), its experiment
     checked as in 7b, and both kernels held to their plain versions on the
     tables of the run's last render; (c) the sampler: every record of 20
     batches its own store's, one seed and one thread twice give equal
     bytes, no window twice in sequential mode with 2 threads; (d)
     --profile_dir on one training epoch from stores of 72 records a split
     and on `run_evaluate_torch.py --dataset ssp3d --batch_size 8` on phase
     6's folder: each trace parses and holds the card's kernel events, K1's
     among them, with the wall time without and with the profiler; (e)
     pw3d_eval_extract on a synthetic 2-person sequence, card vs CPU; (f)
     the sampler's batch ms, the upload of a packed and of a fallback
     batch, train img/s per stage fed from each, and K1 on 9b's tables
     beside its bound;
 10. the multi-device paths (parallel/) at full width: (a) the CLIs'
     multi-process path on this card at world 1 through NCCL,
     `run_train_torch.py --coordinator_address 127.0.0.1:<port>
     --num_processes 1 --process_id 0` for 2 epochs and `-R 0`, and
     run_evaluate_torch.py's run with the same flags on phase 6's SSP-3D
     folder at batch 8, each under deterministic algorithms beside the
     plain `--num_devices 1` run: checkpoints, Adam's state, log.pkl,
     metrics and per-frame files bit-equal; (b) two ranks of this script
     on this card through gloo (deterministic) against one rank: train
     steps at B = 72 (stages 1 and 2 at data 2, stage 2 at data 1 x
     sample 2) on the loss, terms and metric sums (1e-5 relative) and
     every gradient, BatchNorm statistic and weight after Adam (max(1e-5,
     10 x the tensor's float32 floor)), the SSP-3D eval step at data 2 and
     at sample 2 (B = 8, 10 samples; frame metrics 1e-5, IOU counts 2e-3),
     the predict core at sample 2 (N = 50, 25 / 25, 6 views at 512^2;
     1e-5); both kernels held to their plain versions on rank 0's tables of
     each path, their launches counted per rank; (c) times on the host
     clock (median of 5) beside the card's name and power limit: train
     img/s per stage of the world-1 DDP step and of the plain step, the
     gradient all-reduce at world 1 over NCCL at ResNet-18's and
     ResNet-50's parameter counts, and the gloo ranks' step and all-reduce
     (a correctness run on one card, not a scaling number).
     Each phase logs its wall time.

`python3 chip_smoke.py --rank SPEC RANK` is one rank of a group that
run_ranks starts (10b, and the CPU tests' gloo groups): it reads SPEC,
joins the group, runs one scenario and saves its result beside SPEC.

The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(REPO, "demo")
DEMO_PHOTOS = ("00000.png", "00003.png", "00007.png")
# Phase 5: the batch size of the batched paths, and the demo photo pasted
# into a larger canvas (rows, columns) for the detectors.
BATCH = 4
DETECTOR_PHOTO = "00007.png"
CANVAS_HW = (720, 960)
# The figures' view size (the CLI's default) and the 2 x 4 figure's shape.
FIGURE_WH = 512
FIGURE_SHAPE = (2 * FIGURE_WH, 4 * FIGURE_WH, 3)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per (pixel, face) test: w0, w1, z (2 mul + 2 add each),
# w2 (2 sub), 4 coverage compares, z < best.
OPS_PER_TEST = 19
# Geometry rows of the packed tables that the rasterizer reads (of 16).
GEOM_ROWS_READ = 9
# float32 operations per face of the face_boxes rule: denom 7, degenerate 2,
# scale 3, rho 5, two plane errors 19 each and their sum, E 9, and per axis
# min/max 4, margin 8, first and last 6, their NaN tests and clamps 6.
OPS_PER_FACE_BOX = 113
# Seeds of the predict core's card-vs-CPU check, and the least share of the
# pixels covered on both devices whose colours agree to 1e-3. Over seeds
# 0-11 on an H100 80GB HBM3 (700 W) the share was 0.999032-0.999861, 1 to 7
# pixels of about 7,200; 0.998 allows twice the worst of those.
CORE_SEEDS = (3, 4, 5)
CORE_RGB_SHARE = 0.998


class Scene(NamedTuple):
    """A rasterizer input: screen vertices (B, V, 3), faces (F, 3), vertex
    attributes (B, V, A), and the tables packed from them."""
    screen: torch.Tensor
    faces: torch.Tensor
    vert_attrs: torch.Tensor
    tables: tuple


def make_scene(screen, faces, vert_attrs, hw):
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        pack_face_tables)
    return Scene(screen, faces, vert_attrs,
                 pack_face_tables(screen, faces, vert_attrs, hw))


def log(msg):
    print(msg, flush=True)


def timed_phase(tag, fn, *args):
    """fn(*args), its wall time logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{tag}] took {time.perf_counter() - t0:.1f} s")
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, repeats=5, inner=1):
    """Median over `repeats` of CUDA-event time per call of fn(), after one
    warm-up call; `inner` calls per timed repeat."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def figure_renderer(device, img_wh):
    """The renderer of the predict figures: orthographic, shaded colours."""
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    return TexturedIUVRenderer(device, img_wh=img_wh,
                               projection_type="orthographic", render_rgb=True)


def silhouette_renderer(device, img_wh):
    """The renderer of the evaluation's silhouettes: orthographic, IUV."""
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    return TexturedIUVRenderer(device, img_wh=img_wh,
                               projection_type="orthographic", render_rgb=False)


def render_scene(renderer, views):
    """The Scene one renderer call packs for the meshes of `views` (the
    renderer arguments six_views and samples_views build)."""
    screen, vert_attrs = renderer.raster_inputs(
        views["vertices"], views["cam_t"], views["orthographic_scale"],
        views["verts_features"])
    return make_scene(screen, renderer.faces, vert_attrs,
                      (renderer.img_wh, renderer.img_wh))


def predict_scene(device, img_wh=512, seed=0, batch=1):
    """The 6 views the predict path renders for each of `batch` images
    (posed x4 rotations + T-pose x2) in one call, on synthetic SMPL with
    seeded random poses, packed by the renderer: A = 12 attributes.

    :return: Scene with screen (6 batch, 7829, 3), faces (13774, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        X_AXIS, ZERO_T, jet_colormap, six_views)
    from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
        aa_rotate_translate_points)

    rng = np.random.RandomState(seed)
    smpl = SMPL.synthetic(device)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    betas = tensor(rng.randn(batch, 10))
    posed = smpl(betas=betas, body_pose=tensor(rng.randn(batch, 69) * 0.2))
    views = six_views(
        aa_rotate_translate_points(posed["vertices"], X_AXIS, np.pi, ZERO_T),
        aa_rotate_translate_points(smpl(betas=betas)["vertices"], X_AXIS,
                                   np.pi, ZERO_T),
        jet_colormap(tensor(rng.rand(batch, 6890) * 0.2)),
        tensor([[0.0, -0.1, 2.5]] * batch), tensor([[0.9, 0.9]] * batch))
    return render_scene(figure_renderer(device, img_wh), views)


def samples_scene(device, img_wh=512, seed=6):
    """The samples figure's 18 meshes for one image (the mode and the 8
    samples of least 2D joint error, front and turned), as samples_views
    builds them from the path's 50 seeded synthetic-SMPL pose samples and a
    proxy of one bright pixel per joint, packed by the renderer: A = 12.

    :return: Scene with screen (18, 7829, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        X_AXIS, Y_AXIS, ZERO_T, samples_views)
    from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
        aa_rotate_translate_points)

    rng = np.random.RandomState(seed)
    smpl = SMPL.synthetic(device)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    meshes = 1 + 50   # the mode and the samples
    betas = tensor(np.repeat(rng.randn(1, 10), meshes, axis=0))
    out = smpl(betas=betas, body_pose=tensor(rng.randn(meshes, 69) * 0.2))
    verts_mode = aa_rotate_translate_points(out["vertices"][:1], X_AXIS, np.pi,
                                            ZERO_T)
    proxy = torch.zeros((1, 18, 256, 256), device=device)
    proxy[0, 1 + np.arange(17), rng.randint(40, 216, 17),
          rng.randint(40, 216, 17)] = 1.0
    return render_scene(figure_renderer(device, img_wh), samples_views(
        out["vertices"][None, 1:], out["joints"][None, 1:], proxy,
        tensor([[0.9, 0.02, -0.05]]), verts_mode,
        aa_rotate_translate_points(verts_mode, Y_AXIS, -np.pi / 2, ZERO_T),
        tensor([[0.02, -0.05, 2.5]]), tensor([[0.9, 0.9]])))


def eval_scene(device, seed=1):
    """The evaluation shape: one posed synthetic-SMPL mesh at 256^2,
    orthographic, A = 3 (the IUV attributes).

    :return: Scene with screen (1, 7829, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    views = predict_scene(device, img_wh=256, seed=seed)
    iuv = TexturedIUVRenderer(device, img_wh=256).verts_iuv[None]
    return make_scene(views.screen[:1].contiguous(), views.faces, iuv,
                      (256, 256))


def silhouette_scene(device, batch=8, img_wh=256, seed=7):
    """The evaluation's silhouette render: `batch` synthetic-SMPL meshes
    with seeded poses and shapes, flipped and placed as the eval step places
    them, packed by the renderer's silhouette mode: A = 3 (IUV).

    :return: Scene with screen (batch, 7829, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
        aa_rotate_translate_points)

    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    verts = SMPL.synthetic(device)(betas=tensor(rng.randn(batch, 10)),
                                   body_pose=tensor(rng.randn(batch, 69) * 0.3),
                                   global_orient=tensor(rng.randn(batch, 3) * 0.2)
                                   )["vertices"]
    renderer = silhouette_renderer(device, img_wh)
    screen, iuv = renderer.raster_inputs(
        aa_rotate_translate_points(verts, (1.0, 0.0, 0.0), np.pi, (0.0, 0.0, 0.0)),
        tensor(np.c_[rng.randn(batch, 2) * 0.05, np.full(batch, 2.5)]),
        tensor(np.repeat(rng.uniform(0.7, 1.0, (batch, 1)), 2, axis=1)))
    return make_scene(screen, renderer.faces, iuv, (img_wh, img_wh))


def train_cfg(img_wh=256, num_samples=8):
    """The training configuration (the defaults: ResNet-18, EMBED_DIM 256,
    batch 72) at proxy size img_wh, the focal length scaled with it (300 px
    at 256^2) so the body fills the image at any size."""
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose_shape_cfg_defaults)
    cfg = get_pose_shape_cfg_defaults()
    cfg.DATA.PROXY_REP_SIZE = img_wh
    cfg.LOSS.NUM_SAMPLES = num_samples
    cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH = 300.0 * img_wh / 256
    return cfg


def train_parts(device, cfg, seed=0):
    """The predictor (weights drawn from a CPU generator, so every device
    gets the same ones), synthetic SMPL, the perspective renderer and Canny
    of the training configuration `cfg`, on `device`."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    model = build_pose_shape_model(cfg, "jacobi")
    init_weights(model, torch.Generator().manual_seed(seed))
    renderer = TexturedIUVRenderer(
        device, img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="perspective",
        perspective_focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH,
        render_rgb=True)
    edge = CannyEdgeDetector(device, non_max_suppression=cfg.DATA.EDGE_NMS,
                             gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
                             gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
                             threshold=cfg.DATA.EDGE_THRESHOLD)
    return model.to(device), SMPL.synthetic(device), renderer, edge


def train_batch(batch, img_wh, seed):
    """One batch as the training loader hands it over: seeded poses,
    uint8 backgrounds and 1200 x 800 uint8 texture atlases of the synthetic
    fallback dataset (numpy)."""
    from hierarchicalprobabilistic3dhuman_torch.data.loader import DataLoader
    from hierarchicalprobabilistic3dhuman_torch.data.on_the_fly_smpl_train_dataset import (
        OnTheFlySMPLTrainDataset)
    dataset = OnTheFlySMPLTrainDataset.synthetic(n=batch, img_wh=img_wh, seed=seed)
    return next(iter(DataLoader(dataset, batch_size=batch, num_workers=0)))


class CallRecorder:
    """The training renderer, keeping the arguments of its last call (no
    launch of its own, so a path's kernel counts stay the path's)."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.faces = None if renderer is None else renderer.faces

    def __call__(self, vertices, cam_t=None, textures=None, **kwargs):
        self.last = (vertices.detach(), cam_t.detach(), textures.detach())
        return self.renderer(vertices, cam_t=cam_t, textures=textures, **kwargs)

    def scene(self):
        """The Scene (packed tables) of the last call."""
        vertices, cam_t, textures = self.last
        screen, vert_attrs = self.renderer.raster_inputs(vertices, cam_t,
                                                         textures=textures)
        wh = self.renderer.img_wh
        return make_scene(screen, self.faces, vert_attrs, (wh, wh))


def train_scene(device, batch=72, img_wh=256, seed=2):
    """The training render's tables: one stage-1 synthetic batch of `batch`
    meshes from the synthetic fallback dataset, built by the driver's
    make_synth_data_fn (random shapes, cameras and lights, perspective
    projection, atlases sampled per vertex): A = 12.

    :return: Scene with screen (batch, 7829, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        batch_to_device, make_synth_data_fn)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    device = torch.device(device)
    cfg = train_cfg(img_wh)
    _, smpl, renderer, edge = train_parts(device, cfg)
    recorder = CallRecorder(renderer)
    synth = make_synth_data_fn(cfg, smpl, recorder, edge)
    with torch.no_grad():
        synth(Draws(torch.Generator(device=device).manual_seed(seed)),
              *batch_to_device(train_batch(batch, img_wh, seed), device))
    return recorder.scene()


def triangle_scene(device):
    """Shared edges through pixel centres and exact depth ties: a square split
    on its diagonal into two faces at one depth, the same square again at the
    same depth with other attributes (ties -> lower index), a nearer face over
    part of it, and a face behind znear."""
    verts = torch.tensor([[
        [8.5, 8.5, 2.0], [40.5, 8.5, 2.0], [40.5, 40.5, 2.0], [8.5, 40.5, 2.0],
        [8.5, 8.5, 2.0], [40.5, 8.5, 2.0], [40.5, 40.5, 2.0], [8.5, 40.5, 2.0],
        [20.5, 4.5, 1.0], [60.5, 30.5, 1.0], [24.5, 56.5, 1.0],
        [0.0, 0.0, -1.0], [63.0, 0.0, -1.0], [0.0, 63.0, -1.0],
    ]], device=device)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7],
                          [8, 9, 10], [11, 12, 13]], device=device)
    attrs = torch.tensor([[[1.0, 0.0, 0.0]] * 4 + [[0.0, 1.0, 0.0]] * 4
                          + [[0.0, 0.0, 1.0]] * 3 + [[1.0, 1.0, 1.0]] * 3],
                         device=device)
    return make_scene(verts, faces, attrs, (64, 64))


SLIVER_HW = (200, 232)


def sliver_scene(device, seed=4):
    """Faces that strain the per-face boxes, on a 200 x 232 image, A = 3:
    slivers whose 2 x area |denom| runs from 1e-8 to 1e-3, all but collinear
    faces along lines of pixel centres (their rounded planes cover pixels
    far from their vertices), long thin faces across many tiles, faces partly and wholly off the image, a face behind znear,
    and one face larger than the image behind them all.

    :return: Scene with screen (2, V, 3)
    """
    rng = np.random.RandomState(seed)
    H, W = SLIVER_HW
    tris = [[[-300.0, -200.0, 5.0], [900.0, -100.0, 5.0], [100.0, 1200.0, 6.0]]]
    for denom in np.logspace(-8, -3, 36):
        # Base of length `base` at a random place and angle, apex at height
        # denom / base above a random point of it.
        base = 10.0 ** rng.uniform(-3, 2.3)
        centre = rng.rand(2) * [W, H] * (0.02 if rng.rand() < 0.3 else 1.0)
        angle = rng.uniform(0, 2 * np.pi)
        along = np.array([np.cos(angle), np.sin(angle)])
        across = np.array([-along[1], along[0]])
        pts = [centre, centre + base * along,
               centre + rng.rand() * base * along + denom / base * across]
        tris.append([[*q, rng.uniform(1.0, 4.0)] for q in pts])
    lines = [(1, 1), (1, -1), (2, 1), (1, 2), (3, -1), (1, 0), (0, 1), (-2, 3)]
    for _ in range(64):
        # All but collinear, along a line through pixel centres: the third
        # vertex sits on the segment's line, a few float32 steps off. denom
        # is then rounding noise, and the rounded planes cover pixel centres
        # on the line well beyond the vertices (84 px seen).
        step = np.array(lines[rng.randint(len(lines))])
        n = rng.randint(3, 40)
        p0 = np.array([rng.randint(40, W - 40), rng.randint(40, H - 40)],
                      np.float32) + np.float32(0.5)
        p1 = (p0 + n * step).astype(np.float32)
        p2 = (p0 + rng.randint(0, n + 1) * step).astype(np.float32)
        axis, sign = rng.randint(2), rng.choice([-1.0, 1.0])
        for _ in range(rng.randint(1, 9)):
            p2[axis] = np.nextafter(p2[axis], np.float32(sign * np.inf))
        tris.append([[*q, rng.uniform(1.0, 4.0)] for q in (p0, p1, p2)])
    for _ in range(12):                       # long and thin, across tiles
        a, b = rng.rand(2) * [W, H], rng.rand(2) * [W, H]
        tris.append([[*a, rng.uniform(1.0, 4.0)], [*b, rng.uniform(1.0, 4.0)],
                     [*(b + rng.randn(2) * 0.4), rng.uniform(1.0, 4.0)]])
    for _ in range(12):                       # partly and wholly off-screen
        centre = (rng.rand(2) * 2.0 - 0.5) * [W, H]
        tris.append([[*(centre + rng.randn(2) * 40.0), rng.uniform(1.0, 4.0)]
                     for _ in range(3)])
    tris.append([[-50.0, -60.0, 2.0], [-10.0, -80.0, 2.0], [-30.0, -5.0, 2.0]])
    tris.append([[20.0, 20.0, -1.0], [120.0, 30.0, -1.0], [60.0, 150.0, -1.0]])
    one = np.asarray(tris, np.float32)                     # (F, 3, 3)
    other = one.copy()                                     # a second mesh,
    other[1:, :, :2] += rng.randn(len(one) - 1, 1, 2).astype(np.float32) * 3
    verts = torch.as_tensor(np.stack([one, other]).reshape(2, -1, 3),
                            device=device)
    faces = torch.arange(3 * len(one), device=device).reshape(-1, 3)
    attrs = torch.as_tensor(rng.rand(2, 3 * len(one), 3).astype(np.float32),
                            device=device)
    return make_scene(verts, faces, attrs, SLIVER_HW)


def pixel_face_tests(screen, faces, hw):
    """The pixel-face tests the rasterizer needs: for each non-degenerate
    face, the pixel centres inside its screen bounding box, clipped to the
    image (no face can cover a pixel outside its box)."""
    H, W = hw
    fv = screen[:, faces]                                # (B, F, 3, 3)
    x, y = fv[..., 0], fv[..., 1]
    area2 = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
             - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))

    def centres(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1)
        return torch.clamp(last - first + 1, min=0).to(torch.int64)

    tests = (centres(x.amin(-1), x.amax(-1), W)
             * centres(y.amin(-1), y.amax(-1), H))
    return int(tests[area2.abs() > 1e-9].sum())


def box_tests(face_boxes):
    """The pixel-face tests the kernel makes: the sum of the areas of the
    per-face boxes (a diagnostic of the design, not part of the bound)."""
    b = face_boxes.to(torch.int64)
    return int((torch.clamp(b[..., 1] - b[..., 0] + 1, min=0)
                * torch.clamp(b[..., 3] - b[..., 2] + 1, min=0)).sum())


def boxes_differ(tag, name, scene):
    """Largest difference of the face_boxes kernel's boxes from its plain
    version's on a scene (they must be equal, and the scene's tables, packed
    on the card, hold them)."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_cuda, face_boxes_plain, face_vertices)
    fv, _ = face_vertices(scene.screen, scene.faces)
    hw = scene.tables.image_hw
    kb, pb = face_boxes_cuda(fv, hw), face_boxes_plain(fv, hw)
    diff = int((kb - pb).abs().max())
    log(f"[{tag}] {name} scene, face_boxes {tuple(kb.shape)}: max abs "
        f"diff from the plain version {diff} (tol 0)")
    if diff or not torch.equal(kb, scene.tables.face_boxes):
        raise AssertionError(f"face_boxes kernel disagrees with its plain "
                             f"version on the {name} scene")
    return diff


def hold_to_plain(tag, name, scene):
    """Both kernels against their plain versions on a scene: mask and depth
    bit-equal, attrs within 1e-5, boxes equal.

    :return: covered pixels, attrs max abs diff, boxes max abs diff, the
        kernel's outputs
    """
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda, rasterize_packed_plain)
    box_diff = boxes_differ(tag, name, scene)
    ka, kd, km = rasterize_packed_cuda(scene.tables)
    pa, pd, pm = rasterize_packed_plain(scene.tables)
    torch.cuda.synchronize()
    mask_diff = int((km != pm).sum())
    depth_equal = bool(torch.equal(kd, pd))
    attr_err = float((ka - pa).abs().max())
    log(f"[{tag}] {name} scene {tuple(ka.shape)}: covered pixels "
        f"{int(km.sum())}, mask differs at {mask_diff}, depth bit-equal "
        f"{depth_equal}, attrs max abs diff {attr_err:.3e} (tol 1e-5)")
    if mask_diff or not depth_equal or not attr_err <= 1e-5:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"the {name} scene")
    return int(km.sum()), attr_err, box_diff, (ka, kd, km)


def phase_kernel_vs_plain(device):
    """:return: the predict, eval and train scenes with their covered
    pixels, the largest attrs difference and the largest box difference"""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda, rasterize_packed_plain)

    scenes = {}
    worst = 0.0
    worst_box = 0
    for name, build in (("predict", predict_scene), ("sliver", sliver_scene),
                        ("eval", eval_scene)):
        scene = build(device)
        covered, attr_err, box_diff, kernel_out = hold_to_plain(
            "phase 2", name, scene)
        worst, worst_box = max(worst, attr_err), max(worst_box, box_diff)
        if name == "predict":
            again = rasterize_packed_cuda(scene.tables)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(kernel_out, again))
            log(f"[phase 2] predict scene run twice: outputs identical {same}")
            if not same:
                raise AssertionError("two runs on the same tables differ")
        scenes[name] = (scene, covered)

    worst_box = max(worst_box, boxes_differ("phase 2", "triangle",
                                            triangle_scene(device)))
    tri = triangle_scene(device).tables
    ta, td, tm = rasterize_packed_cuda(tri)
    qa, qd, qm = rasterize_packed_plain(tri)
    torch.cuda.synchronize()
    ok = torch.equal(tm, qm) and torch.equal(td, qd) and torch.equal(ta, qa)
    log(f"[phase 2] triangle scene: covered {int(tm.sum())} px, outputs equal "
        f"{ok}; tie winner attrs at (35, 10) {ta[0, 35, 10].tolist()}")
    if not ok or ta[0, 35, 10].tolist() != [1.0, 0.0, 0.0]:
        raise AssertionError("kernel disagrees on shared edges / depth ties")
    del scenes["sliver"]
    return scenes, worst, worst_box


def run_path(tag, what, fn, expect):
    """Drive one path with both kernels' launch counts set to 0 just before
    it and read just after; each count must equal `expect`.

    :return: fn's result, the counts
    """
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_cuda, rasterize_packed_cuda)
    rasterize_packed_cuda.launches = face_boxes_cuda.launches = 0
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rasterize": rasterize_packed_cuda.launches,
                "face_boxes": face_boxes_cuda.launches}
    log(f"[{tag}] {what}: {wall:.2f} s; kernel launches {launches}, "
        f"expected {expect} of each")
    if set(launches.values()) != {expect}:
        raise AssertionError(f"{what}: expected {expect} launches of each "
                             f"kernel, got {launches}")
    return result, launches


def check_results(tag, results, fnames):
    """Every photo has finite outputs of the expected shapes."""
    if sorted(results) != sorted(fnames):
        raise AssertionError(f"results for {sorted(results)}")
    for fname, res in results.items():
        for k, shape in (("pose_mode", (23, 3, 3)), ("shape_mean", (10,)),
                         ("cam", (3,)), ("per_vertex_uncertainty", (6890,))):
            if res[k].shape != shape or not np.isfinite(res[k]).all():
                raise AssertionError(f"[{tag}] {fname}/{k}: shape "
                                     f"{res[k].shape}, finite "
                                     f"{np.isfinite(res[k]).all()}")


def check_image(path, shape):
    """A written figure of the given shape that is not blank."""
    import cv2
    img = cv2.imread(path)
    if img is None or img.shape != shape or img.std() < 1.0:
        raise AssertionError(f"{path}: missing, blank or not of shape {shape} "
                             f"({None if img is None else img.shape})")
    return img


def demo_folder(workdir, name, photos):
    image_dir = os.path.join(workdir, name)
    os.makedirs(image_dir)
    for f in photos:
        shutil.copy(os.path.join(DEMO, f), image_dir)
    return image_dir


def phase_main_path(workdir):
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import main

    image_dir = demo_folder(workdir, "demo3", DEMO_PHOTOS)
    save_dir = os.path.join(workdir, "out")
    argv = ["--image_dir", image_dir, "--save_dir", save_dir,
            "--cropped_images", "--device", "cuda"]
    results, launches = run_path(
        "phase 3", f"run_predict_torch.py on {len(DEMO_PHOTOS)} demo photos",
        lambda: main(argv), expect=len(DEMO_PHOTOS))
    check_results("phase 3", results, DEMO_PHOTOS)
    for fname, res in results.items():
        fig = check_image(os.path.join(save_dir, fname), (1024, 2048, 3))
        rot = np.einsum("jab,jcb->jac", res["pose_mode"], res["pose_mode"])
        log(f"[phase 3] {fname}: figure {fig.shape}, |R R^T - I| "
            f"{np.abs(rot - np.eye(3)).max():.2e}, uncertainty mean "
            f"{res['per_vertex_uncertainty'].mean():.4f}")
    return argv, launches


def core_render_scene(out, smpl, renderer):
    """The Scene of the core's 6-view render (6 B meshes), rebuilt from its
    outputs as make_predict_core builds it."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        X_AXIS, ZERO_T, jet_colormap, six_views)
    from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
        aa_rotate_translate_points)

    cam = out["cam"]
    B = cam.shape[0]
    reposed = aa_rotate_translate_points(
        smpl(betas=out["shape_mean"])["vertices"], X_AXIS, np.pi, ZERO_T)
    views = six_views(
        out["verts_mode"], reposed, jet_colormap(out["per_vertex_3Dvar"]),
        torch.cat([cam[:, 1:], torch.full((B, 1), 2.5, device=cam.device)], -1),
        cam[:, 0:1].expand(B, 2))
    return render_scene(renderer, views)


def face_depths(geom, px, py, znear=1e-3):
    """Depth of every face of one mesh's packed geometry (16, Fp) at pixel
    centres (px, py) (N,), +inf where the face does not cover the pixel:
    (N, Fp). Same expressions as the plain rasterizer."""
    px, py = px[:, None], py[:, None]
    w0 = px * geom[0] + py * geom[1] + geom[2]
    w1 = px * geom[3] + py * geom[4] + geom[5]
    w2 = 1.0 - w0 - w1
    z = px * geom[6] + py * geom[7] + geom[8]
    covered = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > znear)
    return torch.where(covered, z, torch.inf)


def explain_rgb_differences(flip, card, cpu):
    """Why colours differ at `flip` between the devices' renders. Each such
    pixel is one of three kinds:
      - shading: the same face won on both geometries, and its interpolated
        attributes differ (the shading normal most: short where the face's
        three vertex normals point apart, which makes it sensitive to noise);
      - edge: another face won, and one of the two winners does not cover
        the pixel on the other device's geometry (noise moved a face edge
        across the pixel centre);
      - depth order: another face won, and both winners cover the pixel on
        both geometries (a near tie in depth that noise reordered).

    :param flip: (V, H, W) bool, pixels covered on both with rgb off by >1e-3
    :param card, cpu: dicts of each device's packed "tables" and rendered
        "attrs" (V, H, W, 12) [IUV | normal | camera position | colour]
    :return: dict of counts, the largest depth gap of a reordered pair, and
        the largest attribute differences where the same face won
    """
    idx = flip.nonzero()
    kinds = []
    for v in idx[:, 0].unique().tolist():
        rc = idx[idx[:, 0] == v][:, 1:].to(torch.float32)
        py, px = rc[:, 0] + 0.5, rc[:, 1] + 0.5
        z_cpu = face_depths(cpu["tables"][0][v].cpu(), px, py)
        z_card = face_depths(card["tables"][0][v].cpu(), px, py)
        win_cpu, win_card = z_cpu.argmin(1), z_card.argmin(1)
        rows = torch.arange(len(px))
        both_cover = (torch.isfinite(z_cpu[rows, win_card])
                      & torch.isfinite(z_card[rows, win_cpu]))
        kinds.append((win_cpu == win_card, both_cover,
                      (z_cpu[rows, win_card] - z_cpu[rows, win_cpu]).abs()))
    same, both_cover, gap = (torch.cat(k) for k in zip(*kinds)) if kinds else (
        torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.bool),
        torch.zeros(0))
    reordered = ~same & both_cover
    diff = (card["attrs"] - cpu["attrs"]).abs()[flip][same]
    normal_len = torch.linalg.vector_norm(cpu["attrs"][..., 3:6], dim=-1)
    covered = cpu["attrs"][..., 0] > 0
    return {
        "pixels": len(idx),
        "shading": int(same.sum()),
        "edge": int((~same & ~both_cover).sum()),
        "depth_order": int(reordered.sum()),
        "max_depth_gap": float(gap[reordered].max()) if reordered.any() else 0.0,
        "normal_diff": float(diff[:, 3:6].max()) if same.any() else 0.0,
        "colour_diff": float(diff[:, 9:12].max()) if same.any() else 0.0,
        "normal_len_there": (float(normal_len[flip][same].median())
                             if same.any() else float("nan")),
        "normal_len_all": float(normal_len[covered].median()),
    }


def phase_core_cuda_vs_cpu():
    """The predict core on the card (kernel) and on the CPU (plain versions),
    same weights, inputs and sampler draws, renders at 128^2, for each seed.

    The devices' float results differ by rounding (convolutions,
    reductions), so the meshes' vertices differ by float noise. Each seed
    shows that this, not the kernel, moves the colours: the kernel given the
    CPU's own tables renders what the CPU renders, bit for bit on mask and
    depth; and each pixel whose colour differs by more than 1e-3 is counted
    by its kind (see explain_rgb_differences).
    """
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda, rasterize_packed_plain)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core)

    cfg = get_pose_shape_cfg_defaults()
    hrnet_cfg = get_pose2d_hrnet_cfg_defaults()
    hw = (128, 128)
    for seed in CORE_SEEDS:
        model = init_weights(PoseMFShapeGaussianNet(),
                             torch.Generator().manual_seed(seed))
        rng = np.random.RandomState(seed)
        inputs = (rng.rand(1, 3, 384, 288).astype(np.float32),
                  (rng.rand(1, 17, 2) * [288, 384]).astype(np.float32),
                  rng.rand(1, 17).astype(np.float32),
                  rng.randn(1, 23, 400, 4).astype(np.float32),
                  rng.rand(1, 23, 400).astype(np.float32))
        outs, tables = {}, {}
        for dev in ("cuda", "cpu"):
            smpl = SMPL.synthetic(dev)
            renderer = figure_renderer(dev, hw[0])
            core = make_predict_core(
                model.to(dev).eval(), cfg, smpl,
                CannyEdgeDetector(dev, threshold=0.0), renderer, hrnet_cfg)
            t = [torch.as_tensor(a, device=dev) for a in inputs]
            with torch.inference_mode():
                out = core(*t[:3], eps=t[3], w=t[4])
                scene = core_render_scene(out, smpl, renderer)
            tables[dev] = scene.tables
            out["screen"] = scene.screen
            outs[dev] = {k: v.float().cpu() for k, v in out.items()}
        a, b = outs["cuda"], outs["cpu"]
        errs = {k: float((a[k] - b[k]).abs().max())
                for k in ("pose_rotmats_mode", "shape_mean", "cam",
                          "per_vertex_3Dvar", "verts_mode")}
        screen_err = (a["screen"] - b["screen"]).abs().amax((0, 1)).tolist()
        mask_a = a["iuv_views"][0, ..., 0] > 0
        mask_b = b["iuv_views"][0, ..., 0] > 0
        agree = float((mask_a == mask_b).float().mean())
        both = mask_a & mask_b
        rgb_err = (a["rgb_views"][0] - b["rgb_views"][0]).abs().amax(-1)
        rgb_share = float((rgb_err[both] <= 1e-3).float().mean())

        # The kernel on the CPU's own tables against the CPU's render.
        pa, pd, pm = rasterize_packed_plain(tables["cpu"])
        ka, kd, km = rasterize_packed_cuda(tables["cpu"].to("cuda"))
        same_tables_ok = (torch.equal(km.cpu(), pm) and torch.equal(kd.cpu(), pd)
                          and float((ka.cpu() - pa).abs().max()) <= 1e-5)
        rebuilt_ok = torch.equal(pm, mask_b)
        why = explain_rgb_differences(
            both & (rgb_err > 1e-3),
            {"tables": tables["cuda"],
             "attrs": rasterize_packed_cuda(tables["cuda"])[0].cpu()},
            {"tables": tables["cpu"], "attrs": pa})
        log(f"[phase 3] core cuda vs cpu, seed {seed}: max abs {errs} (tol "
            f"1e-4); screen vertices differ by at most (x, y, z) "
            f"{[f'{e:.2e}' for e in screen_err]}; render mask agreement "
            f"{agree:.6f} (tol 0.999); {int(both.sum())} pixels covered on "
            f"both, the share of them with rgb within "
            f"1e-3 {rgb_share:.6f} (tol {CORE_RGB_SHARE}), max "
            f"{float(rgb_err[both].max()):.2e}")
        log(f"[phase 3]   kernel on the CPU's tables equals the CPU render: "
            f"{same_tables_ok}; rebuilt render mask equals the core's: "
            f"{rebuilt_ok}; {why['pixels']} pixels with rgb off by >1e-3: "
            f"{why['shading']} shading (the same face won; its shading "
            f"normal differs by up to {why['normal_diff']:.3e}, its colour "
            f"by up to {why['colour_diff']:.3e}; interpolated normal length "
            f"there, median, {why['normal_len_there']:.3f}, over all covered "
            f"pixels {why['normal_len_all']:.3f}), {why['edge']} edge, "
            f"{why['depth_order']} depth order (largest depth gap "
            f"{why['max_depth_gap']:.3e})")
        if (max(errs.values()) > 1e-4 or agree < 0.999
                or rgb_share < CORE_RGB_SHARE or not same_tables_ok
                or not rebuilt_ok):
            raise AssertionError("predict core on the card disagrees with the "
                                 "CPU")


def device_profile(fn, calls=1):
    """`calls` calls of fn() under torch.profiler, after a warm-up call.

    The profiler can lose device events, above all from a window as short
    as one kernel call, so nothing may fail on what its rows lack.

    :return: the device's events (kernels, memsets, copies) as the
        profiler's averaged rows, the sum of their times in ms, their count,
        and the host-clock time of the calls in ms, ending in a sync
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"rows": rows, "wall_ms": wall_ms,
            "device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "launches": sum(e.count for e in rows)}


def profile_core(fn):
    """One predict-core call under torch.profiler: device time, busy share
    of the host-clock wall time, kernel launches, and the top device ops."""
    p = device_profile(fn)
    log(f"[phase 4] profile of one predict core (profiler on): wall "
        f"{p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
        f"({p['device_ms'] / p['wall_ms']:.1%}), {p['launches']} kernel launches")
    for e in sorted(p["rows"], key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[phase 4]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def rasterizer_device_launches(tables, calls=16, attempts=5):
    """What one rasterize_packed_cuda call launches on the card, counted
    from a profile of `calls` calls in a row: the keys' memset and the two
    kernels. A profile counts only if it is whole, that is if it shows
    `calls` launches of each kernel and a multiple of `calls` of every other
    event; the profiler is asked up to `attempts` times for one.

    :return: the device launches per call, or None where the profiler gave
        no whole profile
    """
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda)
    for attempt in range(1, attempts + 1):
        p = device_profile(lambda: rasterize_packed_cuda(tables), calls=calls)
        names = [f"{e.key[:40]} x{e.count}" for e in p["rows"]]
        whole = (all(e.count % calls == 0 for e in p["rows"])
                 and all(sum(e.count for e in p["rows"] if kernel in e.key)
                         == calls for kernel in ("raster_faces", "resolve")))
        log(f"[phase 4] {calls} rasterize_packed_cuda calls, profile "
            f"{attempt}: {p['launches']} device launches {names}"
            f"{'' if whole else ' (events lost, not counted)'}")
        if whole:
            return p["launches"] // calls
    log(f"[phase 4] the profiler gave no whole profile of the rasterizer in "
        f"{attempts} attempts: device_launches_per_call not measured")
    return None


def once_ms(fn):
    """CUDA-event time of one call of fn(), in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def host_and_card_ms(fn, repeats=5, inner=20):
    """Per call of fn(), on the host's clock, medians over `repeats` of
    `inner` calls in a row from an idle card: the time the host takes to
    enqueue it, and the time until the card has finished it."""
    fn()
    enqueue, finished = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3 / inner)
        finished.append((t2 - t0) * 1e3 / inner)
    return statistics.median(enqueue), statistics.median(finished)


def time_raster_step(name, scene, tag="phase 4"):
    """The rasterize step as the renderer runs it, tables and kernels, and
    its parts: all four tables (pack_face_tables), the fourth alone from its
    kernel and from its plain version, and the rasterizer on packed tables."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_cuda, face_boxes_plain, face_vertices, pack_face_tables,
        rasterize, rasterize_packed_cuda)
    inputs = (scene.screen, scene.faces, scene.vert_attrs)
    hw = scene.tables.image_hw
    fv, _ = face_vertices(scene.screen, scene.faces)
    for part, fn in (
            ("pack_face_tables", lambda: pack_face_tables(*inputs, hw)),
            ("face_boxes_cuda", lambda: face_boxes_cuda(fv, hw)),
            ("face_boxes_plain", lambda: face_boxes_plain(fv, hw)),
            ("rasterize_packed_cuda", lambda: rasterize_packed_cuda(scene.tables)),
            ("rasterize (tables + kernels)", lambda: rasterize(*inputs, hw))):
        enqueue_ms, finished_ms = host_and_card_ms(fn)
        p = device_profile(fn)
        log(f"[{tag}] rasterize step {name}, {part}: host enqueues it in "
            f"{enqueue_ms:.4f} ms, finished on the card after "
            f"{finished_ms:.4f} ms; {p['launches']} device launches, device "
            f"busy {p['device_ms']:.4f} ms")


def time_face_boxes(scenes, tag="phase 4"):
    """The face_boxes kernel at the three shapes beside its bound (6
    coordinates read and 4 indices written per face over the memory rate;
    OPS_PER_FACE_BOX operations per face over the float32 rate), and its
    plain version at the predict shape."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_cuda, face_boxes_plain, face_vertices)
    out = {}
    for name, (scene, _) in scenes.items():
        fv, _ = face_vertices(scene.screen, scene.faces)
        hw = scene.tables.image_hw
        n_faces = fv.shape[0] * fv.shape[1]
        ms = median_ms(lambda: face_boxes_cuda(fv, hw), inner=20)
        bytes_ms = n_faces * (6 * 4 + 4 * 4) / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_faces * OPS_PER_FACE_BOX / PEAK_F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"[{tag}] face_boxes {name}, {n_faces} faces: kernel {ms:.4f} "
            f"ms; bound {bound_ms:.5f} ms (bytes {n_faces * 40} -> "
            f"{bytes_ms:.5f} ms, operations -> {ops_ms:.5f} ms); kernel at "
            f"{ms / bound_ms:.1f}x its bound")
        out[name] = {"kernel_ms": ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if name == "predict":
            out["plain_ms"] = median_ms(lambda: face_boxes_plain(fv, hw), inner=20)
            log(f"[{tag}] face_boxes predict: plain version "
                f"{out['plain_ms']:.4f} ms")
    return out


def phase_timing(argv, scenes):
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_plain)
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_parser, build_predictor)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
        make_hrnet_predictor)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core, predict_pose_mf_shape_gaussian_net)
    import cv2

    # Per-image predict, the whole loop (host clock ending in a sync),
    # stage by stage with CUDA events.
    kwargs = build_predictor(build_parser().parse_args(argv))
    n = len(DEMO_PHOTOS)
    per_image = []
    for _ in range(6):                                   # 1 warm-up + 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_pose_mf_shape_gaussian_net(**kwargs)
        torch.cuda.synchronize()
        per_image.append((time.perf_counter() - t0) * 1e3 / n)
    predict_ms = statistics.median(per_image[1:])

    # Stages of one image on the card: HRNet keypoints, then the core.
    device = kwargs["device"]
    image = cv2.cvtColor(cv2.imread(os.path.join(DEMO, DEMO_PHOTOS[0])),
                         cv2.COLOR_BGR2RGB)
    hrnet_predictor = make_hrnet_predictor(
        kwargs["hrnet"], kwargs["hrnet_cfg"], device,
        bbox_scale_factor=kwargs["pose_shape_cfg"].DATA.BBOX_SCALE_FACTOR)
    hrnet_ms = median_ms(lambda: hrnet_predictor(image))
    kp = hrnet_predictor(image)
    core = make_predict_core(
        kwargs["pose_shape_model"], kwargs["pose_shape_cfg"],
        kwargs["smpl_model"], kwargs["edge_detect_model"],
        figure_renderer(device, 512), kwargs["hrnet_cfg"])
    generator = torch.Generator(device=device).manual_seed(0)
    core_ms = median_ms(lambda: core(kp["cropped_image"][None],
                                     kp["joints2D"][None],
                                     kp["joints2Dconfs"][None],
                                     generator=generator))

    profile_core(lambda: core(kp["cropped_image"][None], kp["joints2D"][None],
                              kp["joints2Dconfs"][None], generator=generator))

    log(f"[phase 4] per-image predict: median {predict_ms:.2f} ms/image "
        f"(runs {[round(t, 2) for t in per_image]}); stages of one image: "
        f"HRNet keypoints {hrnet_ms:.2f} ms, predict core {core_ms:.2f} ms, "
        f"the rest (decode, figure, PNG write) ~"
        f"{predict_ms - hrnet_ms - core_ms:.2f} ms")

    out = {"predict_ms": predict_ms}
    for name, (scene, covered) in scenes.items():
        out[name] = time_rasterizer("phase 4", name, scene, covered)
    predict = scenes["predict"][0]
    out["device_launches_per_call"] = rasterizer_device_launches(predict.tables)
    time_raster_step("predict", scenes["predict"][0])
    out["face_boxes"] = time_face_boxes(scenes)
    out["plain_ms"] = median_ms(lambda: rasterize_packed_plain(predict.tables))
    log(f"[phase 4] rasterize predict: plain version {out['plain_ms']:.2f} ms")
    return out


def time_rasterizer(tag, name, scene, covered):
    """K1 on a scene's packed tables, median of 5 x 20 calls, beside its
    bound (raster_bound)."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda)
    tables = scene.tables
    H, W = tables.image_hw
    kernel_ms = median_ms(lambda: rasterize_packed_cuda(tables), inner=20)
    bound = raster_bound(scene, covered)
    made = box_tests(tables.face_boxes)
    B, A = tables.geom_t.shape[0], tables.face_attrs.shape[-1] // 3
    log(f"[{tag}] rasterize {name} {B}x{H}x{W} A={A}: kernel "
        f"{kernel_ms:.4f} ms; bound {bound['ms']:.4f} ms (bytes "
        f"{bound['bytes']} -> {bound['bytes_ms']:.4f} ms; "
        f"{bound['tests']} pixel-face tests x {OPS_PER_TEST} ops + "
        f"{covered} covered px x {5 * A} ops -> "
        f"{bound['ops_ms']:.4f} ms); kernel at "
        f"{kernel_ms / bound['ms']:.1f}x its bound; the per-face boxes "
        f"ask for {made} tests, {made / bound['tests']:.3f}x the needed")
    return {"kernel_ms": kernel_ms, "bound_ms": bound["ms"],
            "bound_by": bound["by"]}


def raster_bound(scene, covered):
    """The least time the card could take for one rasterizer call: each
    input read once (the 9 geometry rows the function uses and the
    attributes), each output written once, over the memory rate; and the
    pixel-face tests the function needs (each face against the pixel centres
    in its vertices' bounding box) plus the interpolation of A attributes at
    each of the `covered` pixels, over the float32 rate. The kernel's own
    scratch (the keys, the per-face boxes) is not counted, so the bound does
    not move with the design."""
    geom_t, face_attrs = scene.tables.geom_t, scene.tables.face_attrs
    H, W = scene.tables.image_hw
    B, _, Fp = geom_t.shape
    A = face_attrs.shape[-1] // 3
    bytes_moved = (4 * B * GEOM_ROWS_READ * Fp + 4 * face_attrs.numel()
                   + B * H * W * (4 * A + 4 + 1))
    tests = pixel_face_tests(scene.screen, scene.faces, (H, W))
    ops = tests * OPS_PER_TEST + covered * 5 * A
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"ms": max(bytes_ms, ops_ms), "bytes": bytes_moved, "tests": tests,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "by": "bytes" if bytes_ms >= ops_ms else "operations"}


def figure_scenes(kwargs, image_dir):
    """The tables of the two renders this slice adds, built by the path's
    own functions from one batched HRNet + core call on BATCH demo photos:
    the batched figure's (6 BATCH meshes) and the samples figure's for the
    first photo of the chunk (18 meshes)."""
    import cv2
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core, samples_views)

    device = kwargs["device"]
    by_shape = {}
    for f in sorted(os.listdir(image_dir)):
        rgb = cv2.cvtColor(cv2.imread(os.path.join(image_dir, f)),
                           cv2.COLOR_BGR2RGB)
        by_shape.setdefault(rgb.shape, []).append(rgb)
    chunk = next(g for g in by_shape.values() if len(g) >= BATCH)[:BATCH]
    stack = torch.as_tensor(np.stack(chunk), device=device)
    hr = hrnet_predict(kwargs, stack)
    renderer = figure_renderer(device, FIGURE_WH)
    core = make_predict_core(
        kwargs["pose_shape_model"], kwargs["pose_shape_cfg"],
        kwargs["smpl_model"], kwargs["edge_detect_model"], renderer,
        kwargs["hrnet_cfg"])
    with torch.inference_mode():
        out = core(hr["cropped_image"], hr["joints2D"], hr["joints2Dconfs"],
                   generator=torch.Generator(device=device).manual_seed(0))
        batched = core_render_scene(out, kwargs["smpl_model"], renderer)
        samples = render_scene(renderer, samples_views(*(out[k][0:1] for k in (
            "verts_samples", "joints_samples", "proxy", "cam", "verts_mode",
            "verts_rot90", "pred_cam_t", "pred_scale"))))
    return {"batched": batched, "samples": samples}, stack, hr


def timed_folder_runs(kwargs, **opts):
    """predict_folder_batched on the folder, one warm-up run and two timed
    ones (host clock ending in a sync), its progress lines kept out of the
    log.

    :return: median ms/image of the whole run, and the median of the
        steady-state img/s the driver prints (after its first chunk)
    """
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        predict_folder_batched)
    n = len(os.listdir(kwargs["image_dir"]))
    ms, steady = [], []
    for i in range(3):
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            predict_folder_batched(**kwargs, **opts)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3 / n)
            found = re.search(r"\(([\d.]+) img/s steady-state", printed.getvalue())
            if found:
                steady.append(float(found.group(1)))
    return (statistics.median(ms), ms,
            statistics.median(steady) if steady else None)


def detector_canvas(workdir):
    """A demo photo pasted off-centre into a CANVAS_HW grey canvas, written
    as the folder's one photo. :return: the folder, the canvas (RGB)"""
    import cv2
    photo = cv2.imread(os.path.join(DEMO, DETECTOR_PHOTO))
    canvas = np.full(CANVAS_HW + (3,), 40, np.uint8)
    top, left = 150, 380
    canvas[top:top + photo.shape[0], left:left + photo.shape[1]] = photo
    image_dir = os.path.join(workdir, "canvas")
    os.makedirs(image_dir)
    cv2.imwrite(os.path.join(image_dir, "canvas.png"), canvas)
    return image_dir, cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB)


def phase_detector(workdir):
    """Uncropped photos through both keypoint bootstrap detectors, as the
    CLI builds them: the per-image predict (figure and uncrop) on the card
    with each, and each detector's boxes on the card against the same
    detector on the CPU with the same weights (within 1 px); then the
    batched --no_vis driver with the single-person detector, its box and
    outputs against the per-image driver's on the card."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        _make_detector, build_parser, build_predictor)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        predict_folder_batched, predict_pose_mf_shape_gaussian_net)

    image_dir, canvas = detector_canvas(workdir)
    image = torch.from_numpy(canvas).permute(2, 0, 1).float() / 255.0
    worst = 0.0
    built = {}
    for kind in ("keypoint-multi", "keypoint"):
        save_dir = os.path.join(workdir, f"canvas_{kind}")
        argv = ["--image_dir", image_dir, "--save_dir", save_dir,
                "--detector", kind, "--visualise_uncropped"]
        for dev in ("cuda", "cpu"):
            args = build_parser().parse_args(argv + ["--device", dev])
            if dev not in built:
                built[dev] = build_predictor(args)
            built[dev]["object_detect_fn"] = _make_detector(
                args, built[dev]["hrnet"], built[dev]["hrnet_cfg"],
                built[dev]["device"])
        card_boxes = []

        def recorded(img, detect=built["cuda"]["object_detect_fn"]):
            found = detect(img)
            card_boxes.append(np.asarray(found["boxes"]))
            return found

        kwargs = dict(built["cuda"], object_detect_fn=recorded,
                      save_dir=save_dir)
        results, _ = run_path(
            "phase 5e", f"run_predict_torch.py --detector {kind} "
            f"--visualise_uncropped on a {CANVAS_HW[1]}x{CANVAS_HW[0]} photo",
            lambda: predict_pose_mf_shape_gaussian_net(**kwargs), expect=1)
        check_results("phase 5e", results, ["canvas.png"])
        check_image(os.path.join(save_dir, "canvas.png"), FIGURE_SHAPE)
        check_image(os.path.join(save_dir, "canvas_uncrop.png"),
                    CANVAS_HW + (3,))
        cpu_boxes = np.asarray(built["cpu"]["object_detect_fn"](image)["boxes"])
        diff = (float(np.abs(card_boxes[0] - cpu_boxes).max())
                if card_boxes[0].shape == cpu_boxes.shape and len(cpu_boxes)
                else 0.0)
        log(f"[phase 5e] {kind} detector: card boxes {card_boxes[0].tolist()}, "
            f"CPU boxes {cpu_boxes.tolist()}, max abs diff {diff:.4f} px (tol "
            f"1){'' if len(cpu_boxes) else '; no box: the whole photo is taken'}")
        if card_boxes[0].shape != cpu_boxes.shape or diff > 1.0:
            raise AssertionError(f"{kind} detector: the card's boxes differ "
                                 f"from the CPU's")
        worst = max(worst, diff)
        if kind == "keypoint":
            per_image, per_image_boxes = results, card_boxes[0]
    # The batched driver hands the detector each photo of the chunk on the
    # card; the per-image driver its one photo. `recorded` wraps the loop's
    # last detector, the single-person one.
    card_boxes = []
    batched, _ = run_path(
        "phase 5e", "run_predict_torch.py --detector keypoint --batch_size 2 "
        f"--no_vis on a {CANVAS_HW[1]}x{CANVAS_HW[0]} photo",
        lambda: predict_folder_batched(
            **dict(built["cuda"], object_detect_fn=recorded,
                   save_dir=os.path.join(workdir, "canvas_batched")),
            batch_size=2, save_vis=False), expect=0)
    check_results("phase 5e", batched, ["canvas.png"])
    diffs = {k: float(np.abs(batched["canvas.png"][k]
                             - per_image["canvas.png"][k]).max())
             for k in ("pose_mode", "shape_mean", "cam")}
    box_diff = float(np.abs(card_boxes[0] - per_image_boxes).max())
    log(f"[phase 5e] batched vs per-image driver with the keypoint detector "
        f"on the card: box max abs diff {box_diff} px, outputs max abs "
        f"{diffs} (tol 1e-4)")
    if box_diff > 1e-4 or max(diffs.values()) > 1e-4:
        raise AssertionError("[phase 5e] the batched driver's detector path "
                             "differs from the per-image driver's")
    return worst


def phase_batched(workdir):
    """This slice's paths on the card: the batched --no_vis serving path
    and the batched figures through the CLI, the per-image samples and
    uncrop figures, both kernels on the two new renders' tables, uncropped
    photos through the detectors, and the batched path's timings.

    :return: dict of the readings for the kernels line
    """
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_parser, build_predictor, main)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
        IMAGENET_MEAN, IMAGENET_STD)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core, predict_pose_mf_shape_gaussian_net)
    from hierarchicalprobabilistic3dhuman_torch.utils.precision import bf16_apply
    import cv2

    photos = sorted(f for f in os.listdir(DEMO) if f.endswith(".png"))
    image_dir = demo_folder(workdir, "demo12", photos)
    base = ["--image_dir", image_dir, "--cropped_images", "--device", "cuda"]
    shapes = {f: cv2.imread(os.path.join(DEMO, f)).shape for f in photos}
    # The batched driver's chunks: each resolution in chunks of <= BATCH.
    chunks = sum(-(-list(shapes.values()).count(s) // BATCH)
                 for s in set(shapes.values()))
    readings = {"launches": {}}
    lap_start = [time.perf_counter()]

    def lap(tag):
        now = time.perf_counter()
        log(f"[{tag}] took {now - lap_start[0]:.1f} s")
        lap_start[0] = now

    # (a) both kernels against their plain versions on the new renders'
    # tables, as the path builds them.
    kwargs = build_predictor(build_parser().parse_args(
        base + ["--save_dir", os.path.join(workdir, "per_image12")]))
    scenes, stack, hr = figure_scenes(kwargs, image_dir)
    readings["attr_err"] = readings["box_err"] = 0
    new_scenes = {}
    for name, scene in scenes.items():
        covered, attr_err, box_err, _ = hold_to_plain("phase 5a", name, scene)
        readings["attr_err"] = max(readings["attr_err"], attr_err)
        readings["box_err"] = max(readings["box_err"], box_err)
        new_scenes[name] = (scene, covered)
    lap("phase 5a")

    # (b) the serving path: no render, outputs.npz, the per-image driver's
    # outputs.
    out_b = os.path.join(workdir, "no_vis")
    results, readings["launches"]["no_vis"] = run_path(
        "phase 5b", f"run_predict_torch.py --batch_size {BATCH} --no_vis on "
        f"{len(photos)} demo photos",
        lambda: main(base + ["--save_dir", out_b, "--batch_size", str(BATCH),
                             "--no_vis"]), expect=0)
    check_results("phase 5b", results, photos)
    npz = np.load(os.path.join(out_b, "outputs.npz"))
    if (npz.files != ["fnames", "pose_mode", "shape_mean", "cam",
                      "per_vertex_uncertainty"]
            or list(npz["fnames"]) != photos
            or npz["pose_mode"].shape != (len(photos), 23, 3, 3)
            or os.listdir(out_b) != ["outputs.npz"]):
        raise AssertionError(f"outputs.npz: {npz.files}, "
                             f"{npz['pose_mode'].shape}, {os.listdir(out_b)}")
    per_image = predict_pose_mf_shape_gaussian_net(**kwargs)

    def vs_per_image(tag, batched):
        diffs = {k: max(float(np.abs(batched[f][k] - per_image[f][k]).max())
                        for f in photos)
                 for k in ("pose_mode", "shape_mean", "cam")}
        log(f"[{tag}] batched vs per-image driver on the card, max abs "
            f"{diffs} (tol 1e-4)")
        if max(diffs.values()) > 1e-4:
            raise AssertionError(f"[{tag}] batched outputs differ from the "
                                 f"per-image driver's")

    vs_per_image("phase 5b", results)
    lap("phase 5b")

    # (c) batched figures with the uncrop: one launch of each kernel a chunk.
    out_c = os.path.join(workdir, "figures_b4")
    results, readings["launches"]["figures_b4"] = run_path(
        "phase 5c", f"run_predict_torch.py --batch_size {BATCH} "
        f"--visualise_uncropped on {len(photos)} demo photos",
        lambda: main(base + ["--save_dir", out_c, "--batch_size", str(BATCH),
                             "--visualise_uncropped"]), expect=chunks)
    check_results("phase 5c", results, photos)
    vs_per_image("phase 5c", results)
    for f in photos:
        check_image(os.path.join(out_c, f), FIGURE_SHAPE)
        check_image(os.path.join(out_c, f[:-4] + "_uncrop.png"), shapes[f])
    lap("phase 5c")

    # (d) the per-image samples and uncrop figures on one photo: two
    # launches of each kernel (the 6 views, the 18 sample meshes).
    one_dir = demo_folder(workdir, "demo1", photos[:1])
    out_d = os.path.join(workdir, "samples")
    results, readings["launches"]["samples"] = run_path(
        "phase 5d", "run_predict_torch.py --visualise_samples "
        "--visualise_uncropped on one demo photo",
        lambda: main(["--image_dir", one_dir, "--save_dir", out_d,
                      "--cropped_images", "--device", "cuda",
                      "--visualise_samples", "--visualise_uncropped"]),
        expect=2)
    check_results("phase 5d", results, photos[:1])
    stem = os.path.join(out_d, photos[0][:-4])
    check_image(stem + ".png", FIGURE_SHAPE)
    check_image(stem + "_uncrop.png", shapes[photos[0]])
    check_image(stem + "_samples.png", (3 * FIGURE_WH, 6 * FIGURE_WH, 3))
    lap("phase 5d")

    # (e) uncropped photos through the detectors.
    readings["detector_box_diff"] = phase_detector(workdir)
    lap("phase 5e")

    # (f) timings: the kernels at the new shapes, the folder runs, and a
    # chunk's stages.
    readings["kernels"] = {name: time_rasterizer("phase 5f", name, scene, cov)
                           for name, (scene, cov) in new_scenes.items()}
    readings["face_boxes"] = time_face_boxes(new_scenes, tag="phase 5f")
    del new_scenes, scenes
    kwargs["save_dir"] = os.path.join(workdir, "timing")
    for b in (1, BATCH, 8):
        ms, runs, steady = timed_folder_runs(kwargs, batch_size=b,
                                             save_vis=False)
        log(f"[phase 5f] --no_vis --batch_size {b}, {len(photos)} photos: "
            f"{1e3 / ms:.2f} img/s over the whole run ({ms:.2f} ms/image, "
            f"median of {[round(t, 2) for t in runs]}); the driver's "
            f"steady state {steady} img/s")
        readings[f"no_vis_b{b}_img_s"] = 1e3 / ms
    hrnet_bf16 = bf16_apply(kwargs["hrnet"])
    ms, runs, steady = timed_folder_runs(dict(kwargs, hrnet=hrnet_bf16),
                                         batch_size=BATCH, save_vis=False)
    log(f"[phase 5f] --no_vis --batch_size {BATCH} --bf16: {1e3 / ms:.2f} "
        f"img/s over the whole run (median of {[round(t, 2) for t in runs]} "
        f"ms/image); the driver's steady state {steady} img/s")
    readings[f"no_vis_b{BATCH}_bf16_img_s"] = 1e3 / ms
    # Figures on: one chunk of BATCH photos of one size, since the figure
    # and PNG work on the host is per photo and batching does not share it.
    chunk = [f for f in photos if shapes[f] == shapes[photos[-1]]][:BATCH]
    ms, runs, _ = timed_folder_runs(
        dict(kwargs, visualise_uncropped=True,
             image_dir=demo_folder(workdir, "chunk", chunk)),
        batch_size=BATCH, save_vis=True)
    log(f"[phase 5f] figures on, --visualise_uncropped --batch_size {BATCH}, "
        f"one chunk of {len(chunk)} {shapes[chunk[0]][1]}x"
        f"{shapes[chunk[0]][0]} photos: {ms:.2f} ms/image (median of "
        f"{[round(t, 2) for t in runs]})")
    readings["figures_b4_ms_per_image"] = ms

    device = kwargs["device"]
    hrnet_batch_ms = median_ms(lambda: hrnet_predict(kwargs, stack))
    cores = {"no_vis": make_predict_core(
        kwargs["pose_shape_model"], kwargs["pose_shape_cfg"],
        kwargs["smpl_model"], kwargs["edge_detect_model"], None,
        kwargs["hrnet_cfg"], render_vis=False)}
    cores["figures"] = make_predict_core(
        kwargs["pose_shape_model"], kwargs["pose_shape_cfg"],
        kwargs["smpl_model"], kwargs["edge_detect_model"],
        figure_renderer(device, FIGURE_WH), kwargs["hrnet_cfg"])
    generator = torch.Generator(device=device).manual_seed(0)
    for name, core in cores.items():
        def call(core=core):
            return core(hr["cropped_image"], hr["joints2D"],
                        hr["joints2Dconfs"], generator=generator)
        core_ms = median_ms(call)
        p = device_profile(call)
        log(f"[phase 5f] a chunk of {BATCH}: HRNet keypoints "
            f"{hrnet_batch_ms:.2f} ms, predict core ({name}) {core_ms:.2f} ms; "
            f"profiled core call: wall {p['wall_ms']:.2f} ms, device busy "
            f"{p['device_ms']:.2f} ms, {p['launches']} kernel launches")

    # The bfloat16 HRNet on a chunk's crops: the bounds of the CPU test,
    # and its time beside float32's.
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=device)[:, None, None]
    x = (hr["cropped_image"] - mean) / std
    with torch.inference_mode():
        f32 = kwargs["hrnet"](x).flatten(2)
        b16 = hrnet_bf16(x).flatten(2)
    scale = float(f32.abs().max())
    diff = float((b16 - f32).abs().max())
    gap = float((f32.amax(-1) - f32.gather(-1, b16.argmax(-1, keepdim=True))[..., 0])
                .abs().max())
    with torch.inference_mode():
        f32_ms = median_ms(lambda: kwargs["hrnet"](x))
        bf16_ms = median_ms(lambda: hrnet_bf16(x))
    log(f"[phase 5f] bfloat16 HRNet on a chunk of {BATCH} crops: max abs diff "
        f"{diff / scale:.4f} of the float32 max (tol 0.05), float32 value at "
        f"bf16's argmax within {gap / scale:.4f} of the max (tol 0.02); "
        f"HRNet-W48 alone {f32_ms:.2f} ms float32, {bf16_ms:.2f} ms bfloat16")
    if diff > 0.05 * scale or gap > 0.02 * scale:
        raise AssertionError("bfloat16 HRNet outside its bounds")
    lap("phase 5f")
    return readings


# Phase 6: the evaluation's batch, its sample count (the CLI's default), and
# the demo photos of 512^2 that make the synthetic datasets' frames.
EVAL_BATCH = 8
EVAL_SAMPLES = 10
# The proxy and render size of the eval step's card-vs-CPU check.
CARD_VS_CPU_WH = 32
SSP3D_METRICS = ("PVE-PA", "PVE-T-SC", "silhouette-IOU", "joints2D-L2E",
                 "joints2Dsamples-L2E", "silhouettesamples-IOU")
FRAME_FILES = ("fname_per_frame", "pose_per_frame", "shape_per_frame",
               "cam_per_frame")


def eval_photos(repeat=2):
    """The 512^2 demo photos (8), `repeat` times over, as RGB arrays."""
    import cv2
    photos = []
    for f in sorted(os.listdir(DEMO)):
        rgb = cv2.cvtColor(cv2.imread(os.path.join(DEMO, f)), cv2.COLOR_BGR2RGB)
        if rgb.shape[:2] == (512, 512):
            photos.append(rgb)
    return photos * repeat


def reference_checkpoint(path, seed=0):
    """The distribution predictor at the configuration's full width, random
    weights from `seed`, saved as the reference's training saves it (numpy
    scalars beside the state dict), so --svd_impl auto takes `lapack`."""
    from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    model = init_weights(PoseMFShapeGaussianNet(), torch.Generator().manual_seed(seed))
    torch.save({"best_model_state_dict": model.state_dict(),
                "epoch": np.int64(0),
                "best_epoch_val_metrics": {"PVE-PA": np.float64(0.0)}}, path)
    return path


def eval_argv(dataset, root, weights, save, batch, device, *extra):
    return ["--dataset", dataset, "--dataset_path", root, "--pose_shape_weights",
            weights, "--save_path", save, "--batch_size", str(batch),
            "--device", device, *extra]


def check_eval_outputs(tag, metrics, names, save, n_frames):
    """Finite metrics of the dataset's set, IOUs in [0, 1], and the four
    per-frame files of n_frames frames in dataset order."""
    if sorted(metrics) != sorted(names):
        raise AssertionError(f"[{tag}] metrics {sorted(metrics)}")
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)
           or ("IOU" in k and not 0.0 <= v <= 1.0)}
    fnames = list(np.load(os.path.join(save, "fname_per_frame.npy")))
    shapes = {f: np.load(os.path.join(save, f + ".npy")).shape for f in FRAME_FILES}
    log(f"[{tag}] metrics {json.dumps({k: round(v, 6) for k, v in metrics.items()})};"
        f" per-frame files {shapes}")
    if (bad or fnames != [f"frame_{i:03d}.png" for i in range(n_frames)]
            or shapes["pose_per_frame"] != (n_frames, 24, 3, 3)):
        raise AssertionError(f"[{tag}] bad metrics {bad} or per-frame files "
                             f"{fnames[:4]}..., {shapes}")


class RecordingRenderer:
    """The silhouette renderer, recording the meshes each call hands it."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.calls = []

    def __call__(self, vertices, cam_t, orthographic_scale):
        self.calls.append((vertices, cam_t, orthographic_scale))
        return self.renderer(vertices, cam_t=cam_t,
                             orthographic_scale=orthographic_scale)


def eval_batch(kwargs):
    """The first batch of the evaluator's dataset as the driver hands it to
    the step, and the step's other arguments (draws from a CPU generator,
    seed 0, so the card and the CPU can take the same ones).

    :return: args(device) -> the step's arguments on that device"""
    from hierarchicalprobabilistic3dhuman_torch.data.loader import DataLoader
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        gender_codes, sample_draws)
    batch = next(iter(DataLoader(kwargs["eval_dataset"], batch_size=EVAL_BATCH,
                                 num_workers=0)))
    draws = sample_draws(torch.Generator().manual_seed(0), EVAL_BATCH,
                         EVAL_SAMPLES, 10, "cpu")

    def args(dev):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return ({k: v.to(dev) for k, v in draws.items()}, t(batch["image"]),
                t(batch["heatmaps"]), t(batch["pose"]), t(batch["shape"]),
                torch.as_tensor(gender_codes(batch["gender"]), device=dev),
                t(batch["keypoints"]), t(batch["silhouette"]))
    return args


def make_step(kwargs, renderer=None):
    """The evaluator's mixed-gender step (the SSP-3D batch alternates m/f)."""
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        make_eval_step)
    from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
        make_eval_frame_metrics_fn)
    cfg = kwargs["pose_shape_cfg"]
    if renderer is None:
        renderer = silhouette_renderer(kwargs["device"], cfg.DATA.PROXY_REP_SIZE)
    return make_eval_step(
        kwargs["pose_shape_model"], kwargs["smpl_neutral"], kwargs["smpl_male"],
        kwargs["smpl_female"], kwargs["edge_detect_model"], cfg, EVAL_SAMPLES,
        True, True, True, renderer,
        frame_metrics_fn=make_eval_frame_metrics_fn(list(SSP3D_METRICS)))


def timed_eval_runs(kwargs, batch_size, runs=2):
    """The driver over the folder: one warm-up and `runs` timed runs on the
    host clock, each ending in a synchronize, its printing kept out of the
    log. :return: median frames/s, the runs' frames/s"""
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        evaluate_pose_mf_shape_gaussian_net)
    n = len(kwargs["eval_dataset"]) // batch_size * batch_size
    rates = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate_pose_mf_shape_gaussian_net(**dict(kwargs, batch_size=batch_size))
        torch.cuda.synchronize()
        if i:
            rates.append(n / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def phase_eval(workdir, device):
    """The evaluation entry point on the card: (a) both kernels against
    their plain versions on one SSP-3D batch's silhouette tables; (b)
    run_evaluate_torch.py on a synthetic SSP-3D folder at batch 8 and 1,
    two launches of each kernel a batch; (c) the eval step on the card
    against the CPU; (d) 3DPW, no launch; (e) timings; (f) the LAPACK-sign
    SVD on the card against the CPU.

    :return: dict of the readings for the kernels line
    """
    from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import (
        build_evaluator, build_parser, main)
    from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import svd3x3_gesdd
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_plain, face_vertices, rasterize_packed_plain)

    readings = {"launches": {}}
    lap_start = [time.perf_counter()]

    def lap(tag):
        now = time.perf_counter()
        log(f"[{tag}] took {now - lap_start[0]:.1f} s")
        lap_start[0] = now

    photos = eval_photos()
    ssp3d = write_ssp3d_folder(os.path.join(workdir, "ssp3d"), photos)
    pw3d = write_3dpw_folder(os.path.join(workdir, "3dpw"), photos)
    weights = reference_checkpoint(os.path.join(workdir, "model.tar"))

    def evaluator(dataset, root, batch, on=device, *extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return build_evaluator(build_parser().parse_args(eval_argv(
                dataset, root, weights, os.path.join(workdir, "eval_timing"),
                batch, str(on), *extra)))

    # (a) both kernels against their plain versions on the tables of one
    # batch's two renders: B mode meshes, then B * N sample meshes.
    card = evaluator("ssp3d", ssp3d, EVAL_BATCH)
    if card["pose_shape_model"].svd_impl != "lapack":
        raise AssertionError("--svd_impl auto did not take lapack for a .tar")
    batch_args = eval_batch(card)
    wh = card["pose_shape_cfg"].DATA.PROXY_REP_SIZE
    silhouettes = silhouette_renderer(device, wh)
    recorder = RecordingRenderer(silhouettes)
    make_step(card, renderer=recorder)(*batch_args(device))
    scenes = {}
    readings["attr_err"] = readings["box_err"] = 0
    for name, (verts, cam_t, scale) in zip(("eval_mode", "eval_samples"),
                                           recorder.calls):
        screen, attrs = silhouettes.raster_inputs(verts, cam_t, scale)
        scene = make_scene(screen, silhouettes.faces, attrs, (wh, wh))
        covered, attr_err, box_err, _ = hold_to_plain("phase 6a", name, scene)
        readings["attr_err"] = max(readings["attr_err"], attr_err)
        readings["box_err"] = max(readings["box_err"], box_err)
        scenes[name] = (scene, covered)
        # The plain version, warm from the comparison: one call, as it takes
        # seconds at these shapes (it tests every pixel against every face).
        readings[f"plain_ms_{name}"] = once_ms(
            lambda: rasterize_packed_plain(scene.tables))
        log(f"[phase 6a] rasterize {name}: plain version "
            f"{readings[f'plain_ms_{name}']:.2f} ms (one call)")
    lap("phase 6a")

    # (b) the entry point: 16 frames at batch 8 (2 batches), 4 at batch 1.
    ssp3d_4 = write_ssp3d_folder(os.path.join(workdir, "ssp3d_4"), photos[:4])
    for frames, batch, root in ((len(photos), EVAL_BATCH, ssp3d), (4, 1, ssp3d_4)):
        save = os.path.join(workdir, f"eval_b{batch}")
        metrics, launches = run_path(
            "phase 6b", f"run_evaluate_torch.py --dataset ssp3d --batch_size "
            f"{batch} on {frames} frames",
            lambda: main(eval_argv("ssp3d", root, weights, save, batch,
                                   str(device))),
            expect=2 * frames // batch)
        check_eval_outputs("phase 6b", metrics, SSP3D_METRICS, save, frames)
        readings["launches"][f"eval_ssp3d_{frames}_frames_b{batch}"] = launches
    lap("phase 6b")

    # (c) the step on the card and on the CPU: same weights, batch, draws.
    # The renders at CARD_VS_CPU_WH^2: the plain rasterizer tests every
    # pixel against every face, a few seconds a mesh at 256^2 on the host.
    cfg = os.path.join(workdir, "card_vs_cpu.yaml")
    with open(cfg, "w") as f:
        f.write(f"DATA:\n  PROXY_REP_SIZE: {CARD_VS_CPU_WH}\n")
    small = {dev: evaluator("ssp3d", ssp3d, EVAL_BATCH, dev, "--pose_shape_cfg", cfg)
             for dev in (device, "cpu")}
    small_args = eval_batch(small["cpu"])
    outs = {dev: make_step(kw)(*small_args(kw["device"]))["frame_metrics"]
            for dev, kw in (("card", small[device]), ("cpu", small["cpu"]))}
    worst = {"3d": 0.0, "iou": 0.0}
    for k in outs["cpu"]:
        a = outs["card"][k].double().cpu()
        b = outs["cpu"][k].double()
        if k.startswith("num_"):
            continue
        kind = "iou" if "IOU" in k else "3d"
        err = float((a - b).abs().max() / (1.0 if kind == "iou"
                                            else b.abs().max().clamp(min=1e-12)))
        worst[kind] = max(worst[kind], err)
    counts = {dev: {k: float(v.sum()) for k, v in o.items()
                    if k.startswith("num_samples")} for dev, o in outs.items()}
    sample_iou = {dev: c["num_samples_true_positives"] / (
        c["num_samples_true_positives"] + c["num_samples_false_positives"]
        + c["num_samples_false_negatives"]) for dev, c in counts.items()}
    worst["iou"] = max(worst["iou"], abs(sample_iou["card"] - sample_iou["cpu"]))
    log(f"[phase 6c] eval step, batch of {EVAL_BATCH}, {EVAL_SAMPLES} samples, "
        f"{CARD_VS_CPU_WH}^2, card vs CPU: 3D and 2D "
        f"metrics max rel diff {worst['3d']:.3e} (tol 1e-4); IOUs max abs diff "
        f"{worst['iou']:.3e} (tol 2e-3; samples IOU card {sample_iou['card']:.6f}"
        f", CPU {sample_iou['cpu']:.6f})")
    if worst["3d"] > 1e-4 or worst["iou"] > 2e-3:
        raise AssertionError("[phase 6c] the eval step on the card disagrees "
                             "with the CPU")
    readings["card_vs_cpu"] = worst
    del small, outs
    lap("phase 6c")

    # (d) 3DPW: no silhouette metric, no rasterizer launch.
    save = os.path.join(workdir, "eval_3dpw")
    metrics, launches = run_path(
        "phase 6d", f"run_evaluate_torch.py --dataset 3dpw --batch_size "
        f"{EVAL_BATCH} on {len(photos)} frames",
        lambda: main(eval_argv("3dpw", pw3d, weights, save, EVAL_BATCH,
                               str(device))), expect=0)
    pw3d_metrics = ['PVE', 'PVE-SC', 'PVE-PA', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC',
                    'MPJPE-PA', 'joints2D-L2E']
    pw3d_metrics += [m + "_samples_min" for m in pw3d_metrics if m != "joints2D-L2E"]
    check_eval_outputs("phase 6d", metrics, pw3d_metrics, save, len(photos))
    readings["launches"][f"eval_3dpw_{len(photos)}_frames_b{EVAL_BATCH}"] = launches
    lap("phase 6d")

    # (e) timings: frames/s of the driver, one step's profile, the head with
    # each SVD, and the kernels at the two eval shapes beside their bounds.
    for batch, root in ((1, ssp3d_4), (EVAL_BATCH, ssp3d)):
        kw = dict(card, eval_dataset=type(card["eval_dataset"])(
            root, card["pose_shape_cfg"], visible_joints_threshold=0.6))
        rate, rates = timed_eval_runs(kw, batch)
        log(f"[phase 6e] evaluation, --dataset ssp3d --batch_size {batch}, "
            f"{len(kw['eval_dataset'])} frames: {rate:.2f} frames/s (median of "
            f"{[round(r, 2) for r in rates]})")
        readings[f"eval_b{batch}_frames_s"] = rate
    step = make_step(card)
    step_args = batch_args(device)
    svd3x3_gesdd.iterations = 0
    step(*step_args)
    step_iterations = svd3x3_gesdd.iterations
    step_ms = median_ms(lambda: step(*step_args), repeats=2)
    p = device_profile(lambda: step(*step_args))
    log(f"[phase 6e] one eval step, batch {EVAL_BATCH}: {step_ms:.2f} ms; "
        f"profiled: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} "
        f"ms ({p['device_ms'] / p['wall_ms']:.1%}), {p['launches']} device "
        f"launches, {step_iterations} bidiagonal QR iterations (host syncs)")
    for e in sorted(p["rows"], key=lambda e: -e.self_device_time_total)[:5]:
        log(f"[phase 6e]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    readings.update(eval_step_ms=step_ms, eval_step_launches=p["launches"],
                    eval_step_busy=p["device_ms"] / p["wall_ms"])
    model = card["pose_shape_model"]
    proxy = torch.rand((EVAL_BATCH, 18, wh, wh),
                       generator=torch.Generator().manual_seed(0)).to(device)
    readings["head_ms"] = {}
    with torch.inference_mode():
        for impl in ("jacobi", "lapack", "lapack_callback"):
            model.svd_impl = impl
            svd3x3_gesdd.iterations = 0
            model(proxy)
            iterations = svd3x3_gesdd.iterations
            ms = median_ms(lambda: model(proxy), repeats=2)
            log(f"[phase 6e] predictor, batch {EVAL_BATCH}, svd_impl {impl}: "
                f"{ms:.2f} ms a call; {iterations} bidiagonal QR iterations")
            readings["head_ms"][impl] = ms
    model.svd_impl = "lapack"
    readings["kernels"] = {name: time_rasterizer("phase 6e", name, scene, cov)
                           for name, (scene, cov) in scenes.items()}
    readings["face_boxes"] = time_face_boxes(scenes, tag="phase 6e")
    for name, (scene, _) in scenes.items():
        fv, _ = face_vertices(scene.screen, scene.faces)
        readings["face_boxes"][name]["plain_ms"] = median_ms(
            lambda: face_boxes_plain(fv, scene.tables.image_hw), inner=5)
        log(f"[phase 6e] face_boxes {name}: plain version "
            f"{readings['face_boxes'][name]['plain_ms']:.4f} ms")
    lap("phase 6e")

    # (f) the LAPACK-sign SVD on the card against the port on the CPU.
    F = torch.as_tensor(np.random.RandomState(5).randn(2000, 3, 3) * 0.5
                        + np.eye(3), dtype=torch.float32)
    card_usv = [a.cpu() for a in svd3x3_gesdd(F.to(device))]
    cpu_usv = svd3x3_gesdd(F)
    same = ((card_usv[0] - cpu_usv[0]).abs().amax((1, 2)) <= 1e-5) & (
        (card_usv[2] - cpu_usv[2]).abs().amax((1, 2)) <= 1e-5)
    s_err = float((card_usv[1] - cpu_usv[1]).abs().max())
    bitwise = all(torch.equal(a, b) for a, b in zip(card_usv, cpu_usv))
    log(f"[phase 6f] svd3x3_gesdd on 2000 F + I matrices, card vs CPU: equal "
        f"signs (U, V within 1e-5) on {float(same.float().mean()):.4f} (tol "
        f"0.99); S max abs diff {s_err:.2e}; U, S, V bit-equal {bitwise}")
    if float(same.float().mean()) < 0.99 or s_err > 1e-5:
        raise AssertionError("[phase 6f] svd3x3_gesdd on the card disagrees "
                             "with the CPU")
    # Why the module takes its square roots in float64: torch's float32
    # sqrt on the card against the CPU's, and the float64 route.
    x = torch.as_tensor(np.abs(np.random.RandomState(0).randn(1 << 20)) * 3,
                        dtype=torch.float32)
    off32 = int((torch.sqrt(x.to(device)).cpu() != torch.sqrt(x)).sum())
    off64 = int((torch.sqrt(x.to(device).double()).float().cpu()
                 != torch.sqrt(x.double()).float()).sum())
    log(f"[phase 6f] float32 sqrt of {x.numel()} values, card vs CPU: "
        f"{off32} differ; through float64: {off64} differ")
    readings["gesdd_same_share"] = float(same.float().mean())
    lap("phase 6f")
    return readings


def write_ssp3d_folder(root, images, seed=0):
    """A folder in SSP-3D's layout (data/ssp3d_eval_dataset.py): images/,
    silhouettes/ (an ellipse of 255 about each image's centre) and
    labels.npz with fnames, shapes, poses, joints2D (17 x 3 with
    confidences), bbox_centres (row, col), bbox_whs and genders
    alternating m/f, from the seed.

    :param images: list of uint8 (H, W, 3) RGB images, one frame each
    :return: root
    """
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "silhouettes"))
    n = len(images)
    fnames = [f"frame_{i:03d}.png" for i in range(n)]
    centres, whs, joints = [], [], []
    for fname, rgb in zip(fnames, images):
        H, W = rgb.shape[:2]
        cv2.imwrite(os.path.join(root, "images", fname),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        sil = np.zeros((H, W), np.uint8)
        cv2.ellipse(sil, (W // 2, H // 2), (W // 6, H // 3), 0, 0, 360, 255, -1)
        cv2.imwrite(os.path.join(root, "silhouettes", fname), sil)
        centres.append([H / 2.0 + rng.uniform(-0.05, 0.05) * H,
                        W / 2.0 + rng.uniform(-0.05, 0.05) * W])
        whs.append(0.8 * min(H, W))
        joints.append(np.concatenate(
            [rng.uniform(0.3, 0.7, (17, 2)) * [W, H], rng.rand(17, 1)], axis=1))
    np.savez(os.path.join(root, "labels.npz"),
             fnames=np.array(fnames),
             shapes=rng.randn(n, 10).astype(np.float32),
             poses=(rng.randn(n, 72) * 0.2).astype(np.float32),
             joints2D=np.asarray(joints, np.float32),
             bbox_centres=np.asarray(centres, np.float32),
             bbox_whs=np.asarray(whs, np.float32),
             genders=np.array(["m", "f"] * (n // 2) + ["m"] * (n % 2)))
    return root


def write_3dpw_folder(root, images, seed=0):
    """A folder in 3DPW's layout (data/pw3d_eval_dataset.py):
    cropped_frames/, 3dpw_test.npz with imgname, pose, shape and gender
    (n, m, f in turn) and hrnet_results_centred.npy (17 x 3 keypoints with
    confidences in the frame's pixels), from the seed.

    :param images: list of square uint8 (S, S, 3) RGB images
    :return: root
    """
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "cropped_frames"))
    n = len(images)
    fnames = [f"frame_{i:03d}.png" for i in range(n)]
    keypoints = []
    for fname, rgb in zip(fnames, images):
        cv2.imwrite(os.path.join(root, "cropped_frames", fname),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        keypoints.append(np.concatenate(
            [rng.uniform(0.2, 0.8, (17, 2)) * rgb.shape[0], rng.rand(17, 1)],
            axis=1))
    np.savez(os.path.join(root, "3dpw_test.npz"),
             imgname=np.array(fnames),
             pose=(rng.randn(n, 72) * 0.2).astype(np.float32),
             shape=rng.randn(n, 10).astype(np.float32),
             gender=np.array(["n", "m", "f"] * (n // 3 + 1))[:n])
    np.save(os.path.join(root, "hrnet_results_centred.npy"),
            np.asarray(keypoints, np.float32))
    return root


def hrnet_predict(kwargs, stack):
    """One batched HRNet keypoint call on a uint8 NHWC stack on the card."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
        make_hrnet_batch_predictor)
    return make_hrnet_batch_predictor(
        kwargs["hrnet"], kwargs["hrnet_cfg"], kwargs["device"],
        bbox_scale_factor=kwargs["pose_shape_cfg"].DATA.BBOX_SCALE_FACTOR)(stack)


# Phase 7: training. The card-vs-CPU step's shape (the plain rasterizer
# renders the CPU's batch), and the least share of the synthetic proxy's
# values that must agree within 1e-4 between the card and the CPU: the IUV
# is rounded to whole labels, so a vertex that moves by the last bits of its
# SMPL sums can flip a label and with it an edge or a heatmap pixel.
TRAIN_CHECK = {"batch": 4, "img_wh": 64, "num_samples": 2}
TRAIN_PROXY_SHARE = 0.99
TRAIN_STEPS_A_EPOCH = 6          # 288 / 72 train + 144 / 72 val poses
TRAIN_METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
                 'joints2D-L2E']
CKPT_KEYS = {"epoch", "best_epoch", "best_epoch_val_metrics", "model_state_dict",
             "best_model_state_dict", "optimiser_state_dict"}


class OutputCapture(torch.nn.Module):
    """A predictor that keeps its last input and outputs, their gradients
    retained (for the float64 noise floor of its gradients)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        self.x = x
        self.out = self.model(x)
        for v in self.out.values():
            if v.requires_grad:
                v.retain_grad()
        return self.out


def float64_gradients(model64, capture):
    """The predictor's parameter gradients in float64 (model64: a float64
    copy of the weights `capture` ran with, in train mode) from capture's
    input and upstream gradients: where a float32 gradient differs from
    these, rounding alone moved it."""
    out64 = model64.train()(capture.x.double())
    keys = [k for k, v in capture.out.items() if v.grad is not None]
    torch.autograd.backward([out64[k] for k in keys],
                            [capture.out[k].grad.double() for k in keys])
    return {n: p.grad for n, p in model64.named_parameters()}


def gradient_diffs(model, ref_grads, floor_grads):
    """Per parameter tensor: |grad - ref| and |grad - float64| over the
    largest |ref| and |float64| entries."""
    diffs, floors = {}, {}
    for name, p in model.named_parameters():
        g = p.grad.detach().cpu().double()
        ref = ref_grads[name].detach().cpu().double()
        diffs[name] = float((g - ref).abs().max() / ref.abs().max())
        f = floor_grads[name].detach().cpu()
        floors[name] = float((g - f).abs().max() / f.abs().max())
    return diffs, floors


def train_card_vs_cpu(device, batch=4, img_wh=64, num_samples=2, seed=5):
    """A stage-2 step on the card against the CPU: the same weights, the
    same draws (a CPU generator's, delivered to each device), and the CPU's
    synthetic proxy and targets moved to the card. Also the card's own
    synthetic batch against the CPU's.

    :return: dict of the differences: loss and term relative differences,
        per-tensor gradient differences and their float32 noise floors
        (see float64_gradients), BatchNorm buffers (of each tensor's
        largest), the proxy's equal share and the targets' max differences
    """
    import copy
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device, make_synth_data_fn)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    cfg = train_cfg(img_wh, num_samples)
    cpu = torch.device("cpu")
    host_batch = train_batch(batch, img_wh, seed)
    out = {}
    synthetic = {}
    for dev in (cpu, device):
        model, smpl, renderer, edge = train_parts(dev, cfg, seed)
        with torch.no_grad():
            synthetic[dev.type] = make_synth_data_fn(cfg, smpl, renderer, edge)(
                Draws(torch.Generator().manual_seed(seed), dev),
                *batch_to_device(host_batch, dev))
        if dev == cpu:
            model64 = copy.deepcopy(model).double()
            proxy, targets = synthetic["cpu"]
        capture = OutputCapture(model.train())
        step = TrainStep(capture, cfg, smpl, renderer, edge, cfg.LOSS.STAGE2,
                         None, train=True)
        loss, _, terms = step.forward_loss(
            Draws(torch.Generator().manual_seed(seed + 1), dev), proxy.to(dev),
            {k: v.to(dev) for k, v in targets.items()})
        loss.backward()
        out[dev.type] = (model, capture, loss, terms)

    cpu_model, cpu_capture, cpu_loss, cpu_terms = out["cpu"]
    card_model, _, card_loss, card_terms = out[device.type]
    rel = {"loss": abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())}
    for k in cpu_terms:
        rel[k] = (abs(card_terms[k].item() - cpu_terms[k].item())
                  / max(abs(cpu_terms[k].item()), 1e-6))
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    floor_grads = float64_gradients(model64, cpu_capture)
    diffs, _ = gradient_diffs(card_model, cpu_grads, floor_grads)
    _, cpu_floors = gradient_diffs(cpu_model, cpu_grads, floor_grads)
    buffers = max(float((b.cpu() - dict(cpu_model.named_buffers())[n]).abs().max()
                        / dict(cpu_model.named_buffers())[n].abs().max())
                  for n, b in card_model.named_buffers()
                  if n.endswith(("running_mean", "running_var")))
    finite = all(torch.isfinite(p.grad).all() for p in card_model.parameters())

    (cp, ct), (kp, kt) = synthetic["cpu"], synthetic[device.type]
    share = float(torch.isclose(kp.cpu(), cp, rtol=0, atol=1e-4).float().mean())
    target_diffs = {k: float((kt[k].cpu().double() - ct[k].double()).abs().max())
                    for k in ct}
    return {"rel": rel, "grad_diffs": diffs, "grad_floors": cpu_floors,
            "buffers": buffers, "finite": finite, "proxy_share": share,
            "target_diffs": target_diffs}


def check_card_vs_cpu_step(tag, r):
    """Log and hold phase 7c's readings: loss and terms within 1e-4
    relative, BatchNorm buffers within 1e-5 of each tensor's largest, every
    gradient finite and within max(1e-3, 10 x its float32 noise floor) of
    that tensor's largest, and the synthetic proxy's equal share."""
    diffs, floors = r["grad_diffs"], r["grad_floors"]
    q = np.quantile(list(diffs.values()), [0.5, 0.9, 1.0])
    worst = max(diffs, key=diffs.get)
    over = {n: (round(diffs[n], 6), round(floors[n], 6)) for n in diffs
            if diffs[n] > max(1e-3, 10 * floors[n])}
    log(f"[{tag}] stage-2 step card vs CPU: loss and terms "
        f"{ {k: f'{v:.1e}' for k, v in r['rel'].items()} } relative (tol 1e-4); "
        f"BatchNorm buffers {r['buffers']:.1e} of the largest (tol 1e-5); "
        f"gradients, of each tensor's largest: median {q[0]:.1e}, 90% "
        f"{q[1]:.1e}, max {q[2]:.1e} ({worst}, its float32 noise floor "
        f"{floors[worst]:.1e}); beyond max(1e-3, 10 x floor): {over}; all "
        f"finite {r['finite']}")
    log(f"[{tag}] synthetic batch card vs CPU: {r['proxy_share']:.6f} of the "
        f"proxy's values equal within 1e-4 (floor {TRAIN_PROXY_SHARE}); "
        f"targets' max abs diffs "
        f"{ {k: f'{v:.1e}' for k, v in r['target_diffs'].items()} }")
    if (max(r["rel"].values()) > 1e-4 or r["buffers"] > 1e-5 or over
            or not r["finite"] or r["proxy_share"] < TRAIN_PROXY_SHARE):
        raise AssertionError(f"[{tag}] the train step on the card disagrees "
                             f"with the CPU")


def check_experiment(tag, exp, epochs):
    """log.pkl holds `epochs` epochs of finite losses and metrics, and
    epoch_000.tar is the reference's dict, which the predict/eval loader
    loads strict=True into a fresh predictor of the experiment's config."""
    import pickle
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        load_predictor_state_dict)
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        load_checkpoint)
    with open(os.path.join(exp, "log.pkl"), "rb") as f:
        history = pickle.load(f)
    path = os.path.join(exp, "saved_models", "epoch_000.tar")
    keys = set(load_checkpoint(path))
    model = build_pose_shape_model(experiment_cfg(exp), "jacobi")
    model.load_state_dict(load_predictor_state_dict(path, model), strict=True)
    lengths = {len(v) for v in history.values()}
    finite = all(np.isfinite(v).all() for v in history.values())
    log(f"[{tag}] log.pkl: {lengths} epochs, all finite {finite}; train "
        f"losses {history['train_losses']}, val losses "
        f"{history['val_losses']}; epoch_000.tar keys {sorted(keys)}, loaded "
        f"strict=True")
    if lengths != {epochs} or not finite or keys != CKPT_KEYS:
        raise AssertionError(f"[{tag}] bad training outputs in {exp}")


def time_train_steps(device, cfg=None, tag="phase 7d"):
    """Full-width steps (by default B = 72, 256^2, ResNet-18, EMBED_DIM 256,
    8 samples: `cfg` may give another depth) on one uploaded batch: per
    stage, img/s from the host clock ending in a
    synchronize (median of 5 steps after one warm-up, each step's loss read
    as the loop reads it), the step split into synth / forward / backward /
    Adam with CUDA events (medians of 5), and a profile of one step; then
    the upload of a loader batch (pinned, host clock ending in a sync)."""
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    cfg = cfg or train_cfg()
    B = cfg.TRAIN.BATCH_SIZE
    model, smpl, renderer, edge = train_parts(device, cfg)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    host_batch = train_batch(B, cfg.DATA.PROXY_REP_SIZE, seed=3)
    arrays = batch_to_device(host_batch, device)
    draws = Draws(torch.Generator(device=device).manual_seed(0))
    out = {}
    for stage in (1, 2):
        metrics = TRAIN_METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
        step = TrainStep(model, cfg, smpl, renderer, edge,
                               getattr(cfg.LOSS, f"STAGE{stage}"), optimizer,
                               train=True, metrics_to_track=metrics)
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, _ = step(draws, *arrays)
            float(loss)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        finite = all(torch.isfinite(p.grad).all() for p in model.parameters())
        step_ms = statistics.median(walls[1:])

        parts = []
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            with torch.no_grad():
                proxy, targets = step.synth(draws, *arrays)
            ev[1].record()
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss, _, _ = step.forward_loss(draws, proxy, targets)
            ev[2].record()
            loss.backward()
            ev[3].record()
            optimizer.step()
            ev[4].record()
            torch.cuda.synchronize()
            parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
        split = dict(zip(("synth", "forward", "backward", "adam"),
                         np.median(np.asarray(parts[1:]), axis=0).tolist()))
        prof = device_profile(lambda: step(draws, *arrays))
        out[f"stage{stage}"] = {"step_ms": step_ms, "img_s": B / step_ms * 1e3,
                                "split_ms": split, "launches": prof["launches"],
                                "busy": prof["device_ms"] / prof["wall_ms"]}
        log(f"[{tag}] stage {stage} train step, ResNet-"
            f"{cfg.MODEL.NUM_RESNET_LAYERS}, B={B} 256^2: median "
            f"{step_ms:.2f} ms ({B / step_ms * 1e3:.2f} img/s; steps "
            f"{[round(t, 2) for t in walls]}); split (CUDA events) "
            f"{ {k: round(v, 3) for k, v in split.items()} } ms; profile: "
            f"{prof['launches']} device launches, device busy "
            f"{prof['device_ms']:.2f} of {prof['wall_ms']:.2f} ms "
            f"({prof['device_ms'] / prof['wall_ms']:.1%}); gradients finite "
            f"{finite}")
        for e in sorted(prof["rows"], key=lambda e: -e.self_device_time_total)[:5]:
            log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<5d} {e.key[:90]}")
        if not finite:
            raise AssertionError(f"stage {stage}: non-finite gradients at "
                                 f"full width")

    nbytes = sum(host_batch[k].nbytes for k in ("pose", "background", "texture"))
    uploads = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_to_device(host_batch, device)
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t0) * 1e3)
    upload_ms = statistics.median(uploads[1:])
    out["upload_ms"], out["upload_bytes"] = upload_ms, nbytes
    log(f"[{tag}] upload of a loader batch ({nbytes} bytes, pinned then "
        f"copied): median {upload_ms:.2f} ms ({nbytes / upload_ms / 1e6:.2f} "
        f"GB/s), {upload_ms / out['stage1']['step_ms']:.1%} of a stage-1 step")
    return out


def phase_train(workdir, device):
    """Phase 7: training at full width (see the module docstring)."""
    from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_plain)
    t0 = time.perf_counter()

    def lap(tag):
        nonlocal t0
        log(f"[{tag}] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    readings = {}
    scene = train_scene(device)
    covered, attr_err, box_err, _ = hold_to_plain("phase 7a", "train", scene)
    readings.update(attr_err=attr_err, box_err=box_err)
    lap("phase 7a")

    exp = os.path.join(workdir, "train_experiment")
    steps = 2 * TRAIN_STEPS_A_EPOCH
    _, readings["launches"] = run_path(
        "phase 7b", "run_train_torch.py -O LOSS.STAGE_CHANGE_EPOCH 1 "
        "--num_epochs 2 (B=72, 256^2, stage 1 then 2)",
        lambda: train_main(["-E", exp, "-O", "LOSS.STAGE_CHANGE_EPOCH", "1",
                            "--num_epochs", "2"]), expect=steps)
    check_experiment("phase 7b", exp, epochs=2)
    _, readings["resume_launches"] = run_path(
        "phase 7b", "run_train_torch.py -R 0 --num_epochs 2 (epoch 1 again)",
        lambda: train_main(["-E", exp, "-R", "0", "--num_epochs", "2"]),
        expect=TRAIN_STEPS_A_EPOCH)
    check_experiment("phase 7b", exp, epochs=2)
    lap("phase 7b")

    check_card_vs_cpu_step("phase 7c", train_card_vs_cpu(device, **TRAIN_CHECK))
    lap("phase 7c")

    readings["steps"] = time_train_steps(device)
    readings["kernel"] = time_rasterizer("phase 7d", "train", scene, covered)
    readings["face_boxes"] = time_face_boxes({"train": (scene, covered)},
                                             tag="phase 7d")["train"]
    readings["plain_ms"] = once_ms(lambda: rasterize_packed_plain(scene.tables))
    readings["face_boxes_plain_ms"] = time_face_boxes_plain(scene)
    log(f"[phase 7d] rasterize train: plain version {readings['plain_ms']:.2f} "
        f"ms (one call), face_boxes plain {readings['face_boxes_plain_ms']:.4f} ms")
    time_raster_step("train", scene, tag="phase 7d")
    lap("phase 7d")
    return readings


RESNET50_OPTS = ["MODEL.NUM_RESNET_LAYERS", "50", "LOSS.STAGE_CHANGE_EPOCH", "1",
                 "TRAIN.EPOCHS_PER_SAVE", "1"]
RESUME_RTOL = 1e-6


@contextlib.contextmanager
def recording_renderers():
    """The training CLI's renderers wrapped in CallRecorders, made ones
    listed."""
    from hierarchicalprobabilistic3dhuman_torch.renderers import textured_iuv_renderer
    made, cls = [], textured_iuv_renderer.TexturedIUVRenderer

    def make(*args, **kwargs):
        made.append(CallRecorder(cls(*args, **kwargs)))
        return made[-1]

    textured_iuv_renderer.TexturedIUVRenderer = make
    try:
        yield made
    finally:
        textured_iuv_renderer.TexturedIUVRenderer = cls


def experiment_cfg(exp):
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose_shape_cfg_defaults)
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_file(os.path.join(exp, "pose_shape_cfg.yaml"))
    return cfg


def write_jax_layout_experiment(exp, jax_exp, epoch):
    """A copy of experiment `exp` with its epoch `epoch` in the JAX
    package's layout, written by the port's writer (config, precision and
    log copied as they are)."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.models.weights import to_jax_layout
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        checkpoint_path, load_training_checkpoint, save_jax_training_checkpoint)
    os.makedirs(os.path.join(jax_exp, "saved_models"))
    for name in ("pose_shape_cfg.yaml", "encoder_precision.txt", "log.pkl"):
        shutil.copy(os.path.join(exp, name), jax_exp)
    model = build_pose_shape_model(experiment_cfg(exp), "jacobi")
    path = checkpoint_path(os.path.join(jax_exp, "saved_models"), epoch)
    save_jax_training_checkpoint(path, **to_jax_layout(load_training_checkpoint(
        checkpoint_path(os.path.join(exp, "saved_models"), epoch)), model))
    return path


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms (and cuDNN's) while the block runs;
    an operation that has none warns, and the warnings are logged. cuBLAS's
    workspace is left as it is (CUBLAS_WORKSPACE_CONFIG is read once, at the
    first cuBLAS call of the process)."""
    import warnings
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        for w in {str(w.message).splitlines()[0] for w in caught}:
            log(f"[deterministic] {w}")
    finally:
        torch.use_deterministic_algorithms(False)
        cudnn.deterministic, cudnn.benchmark = flags


def resumed(cfg, path, device):
    """A model and Adam resumed from a training checkpoint as
    run_train_torch.py -R resumes them, and their state: every tensor of
    the model (BatchNorm's batch counter aside: flax keeps none) and of
    Adam, by name."""
    from hierarchicalprobabilistic3dhuman_torch.cli.train import (
        build_model_and_optimizer)
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        load_training_checkpoint)
    model, optimizer, _ = build_model_and_optimizer(
        cfg, device, checkpoint=load_training_checkpoint(path))
    state = {k: v.clone() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    for i, p in enumerate(model.parameters()):
        state.update({f"adam.{i}.{k}": v.clone()
                      for k, v in optimizer.state[p].items()})
    return model, optimizer, state


def resumed_step(cfg, model, optimizer, device, host_batch):
    """One stage-2 train step on `host_batch` with draws from seed 0.

    :return: the step's loss, the parameters after it (on the CPU)
    """
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    _, smpl, renderer, edge = train_parts(device, cfg)
    step = TrainStep(model, cfg, smpl, renderer, edge, cfg.LOSS.STAGE2, optimizer,
                     train=True, metrics_to_track=TRAIN_METRICS + ["joints2Dsamples-L2E"])
    with deterministic_algorithms():
        loss, _, _ = step(Draws(torch.Generator(device=device).manual_seed(0)),
                          *batch_to_device(host_batch, device))
        loss = float(loss)
    return loss, {n: p.detach().cpu() for n, p in model.named_parameters()}


def compare_resumes(tag, cfg, jax_ckpt, ref_ckpt, device, host_batch):
    """The states resumed from the JAX-layout and the reference-layout
    files of one epoch (equal, tensor for tensor), and one step from each:
    the loss relative to the loss and the parameters relative to each
    tensor's largest entry, within RESUME_RTOL."""
    runs = []
    for path in (jax_ckpt, ref_ckpt):
        model, optimizer, state = resumed(cfg, path, device)
        runs.append((state, resumed_step(cfg, model, optimizer, device, host_batch)))
        del model, optimizer
    (state_a, (loss_a, params_a)), (state_b, (loss_b, params_b)) = runs
    same = sorted(state_a) == sorted(state_b) and all(
        torch.equal(state_a[k], state_b[k]) for k in state_b)
    loss_err = abs(loss_a - loss_b) / abs(loss_b)
    worst = max(float((params_a[n] - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for n, w in params_b.items())
    log(f"[{tag}] resumed from the JAX layout vs the reference layout: "
        f"{len(state_b)} tensors of the model and Adam equal {same}; one "
        f"step (deterministic algorithms): loss {loss_a:.7g} vs {loss_b:.7g} "
        f"({loss_err:.2e} rel), weights after it max diff {worst:.2e} of each "
        f"tensor's largest (tol {RESUME_RTOL:g})")
    if not (same and loss_err <= RESUME_RTOL and worst <= RESUME_RTOL):
        raise AssertionError(f"[{tag}] the JAX-layout resume differs")
    return max(loss_err, worst)


def resnet50_weights(workdir, seed=0):
    """The ResNet-50 predictor at full width (random weights from `seed`)
    saved twice: as a reference checkpoint and as flax variables by the
    port's save_variables; and its --pose_shape_cfg.

    :return: cfg path, {"tar": path, "msgpack": path}
    """
    from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        init_weights, torch_to_flax_predictor)
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        save_variables)
    sd = init_weights(PoseMFShapeGaussianNet(num_resnet_layers=50),
                      torch.Generator().manual_seed(seed)).state_dict()
    paths = {"tar": os.path.join(workdir, "resnet50.tar"),
             "msgpack": os.path.join(workdir, "resnet50.msgpack")}
    torch.save({"best_model_state_dict": sd, "epoch": np.int64(0)}, paths["tar"])
    save_variables(paths["msgpack"], torch_to_flax_predictor(sd))
    cfg = os.path.join(workdir, "resnet50.yaml")
    with open(cfg, "w") as f:
        f.write("MODEL:\n  NUM_RESNET_LAYERS: 50\n")
    return cfg, paths


def host_ms(fn, repeats=3):
    """Median host-clock ms of fn() over `repeats` calls."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_resnet50(workdir, device):
    """Phase 8: the ResNet-50 predictor through the three entry points, and
    the JAX package's checkpoint layouts (see the module docstring).

    :return: dict of the readings for the kernels line
    """
    from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import (
        build_evaluator, build_parser as eval_parser, main as eval_main)
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model, main as predict_main)
    from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        load_predictor_state_dict, to_reference_layout)
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        checkpoint_path, load_training_checkpoint)
    t0 = time.perf_counter()
    readings = {"launches": {}}

    def lap(tag):
        nonlocal t0
        log(f"[{tag}] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    # (a) two epochs at B = 72, then K1 held to its plain version on the
    # tables of the run's last render.
    exp = os.path.join(workdir, "train_resnet50")
    steps = 2 * TRAIN_STEPS_A_EPOCH
    with recording_renderers() as made:
        _, readings["launches"]["train_resnet50_2_epochs"] = run_path(
            "phase 8a", "run_train_torch.py -O MODEL.NUM_RESNET_LAYERS 50 "
            "LOSS.STAGE_CHANGE_EPOCH 1 --num_epochs 2 (B=72, 256^2)",
            lambda: train_main(["-E", exp, "-O", *RESNET50_OPTS,
                                "--num_epochs", "2"]), expect=steps)
    check_experiment("phase 8a", exp, epochs=2)
    (recorder,) = made
    scene = recorder.scene()
    covered, readings["attr_err"], readings["box_err"], _ = hold_to_plain(
        "phase 8a", "train_resnet50", scene)
    lap("phase 8a")

    # (b) epoch 1 in the JAX package's layout, resumed by the CLI, and its
    # first step against the reference-layout resume.
    jax_exp = os.path.join(workdir, "train_resnet50_jax_layout")
    jax_ckpt = write_jax_layout_experiment(exp, jax_exp, 1)
    _, readings["launches"]["train_resnet50_resume_jax_layout"] = run_path(
        "phase 8b", "run_train_torch.py -R 1 --num_epochs 3 from the JAX layout",
        lambda: train_main(["-E", jax_exp, "-R", "1", "--num_epochs", "3"]),
        expect=TRAIN_STEPS_A_EPOCH)
    cfg = experiment_cfg(exp)
    host_batch = train_batch(cfg.TRAIN.BATCH_SIZE, cfg.DATA.PROXY_REP_SIZE, seed=4)
    ref_ckpt = checkpoint_path(os.path.join(exp, "saved_models"), 1)
    readings["resume_err"] = compare_resumes("phase 8b", cfg, jax_ckpt, ref_ckpt,
                                             device, host_batch)
    lap("phase 8b")

    # (c) predict and evaluate with the same weights in both formats.
    cfg_path, weights = resnet50_weights(workdir)
    image_dir = os.path.join(workdir, "demo3")
    ssp3d = os.path.join(workdir, "ssp3d")
    outputs = {}
    for fmt, path in weights.items():
        save = os.path.join(workdir, f"predict_resnet50_{fmt}")
        results, readings["launches"][f"predict_resnet50_{fmt}"] = run_path(
            "phase 8c", f"run_predict_torch.py, ResNet-50 weights as {fmt}, on "
            f"{len(DEMO_PHOTOS)} demo photos",
            lambda: predict_main(["--image_dir", image_dir, "--save_dir", save,
                                  "--cropped_images", "--pose_shape_cfg", cfg_path,
                                  "--pose_shape_weights", path, "--svd_impl",
                                  "jacobi", "--device", "cuda"]),
            expect=len(DEMO_PHOTOS))
        check_results("phase 8c", results, DEMO_PHOTOS)
        eval_save = os.path.join(workdir, f"eval_resnet50_{fmt}")
        metrics, readings["launches"][f"eval_resnet50_{fmt}"] = run_path(
            "phase 8c", f"run_evaluate_torch.py --dataset ssp3d --batch_size 8, "
            f"ResNet-50 weights as {fmt}",
            lambda: eval_main(eval_argv("ssp3d", ssp3d, path, eval_save, EVAL_BATCH,
                                        "cuda", "--pose_shape_cfg", cfg_path,
                                        "--svd_impl", "jacobi")),
            expect=2 * len(eval_photos()) // EVAL_BATCH)
        check_eval_outputs("phase 8c", metrics, SSP3D_METRICS, eval_save,
                           len(eval_photos()))
        outputs[fmt] = (results, metrics, {f: np.load(os.path.join(
            eval_save, f + ".npy")) for f in FRAME_FILES[1:]})
    diffs = [float(np.abs(outputs["msgpack"][0][f][k] - outputs["tar"][0][f][k]).max())
             for f in DEMO_PHOTOS for k in outputs["tar"][0][f]]
    diffs += [abs(outputs["msgpack"][1][k] - outputs["tar"][1][k])
              for k in outputs["tar"][1]]
    diffs += [float(np.abs(outputs["msgpack"][2][k] - outputs["tar"][2][k]).max())
              for k in outputs["tar"][2]]
    readings["format_diff"] = max(diffs)
    log(f"[phase 8c] flax msgpack vs reference .tar: predict outputs, eval "
        f"metrics and per-frame files max diff {max(diffs):.3e} (tol 1e-6)")
    if not max(diffs) <= 1e-6:
        raise AssertionError("[phase 8c] the two weight formats disagree")
    lap("phase 8c")

    # (d) timings.
    log(f"[phase 8d] on {card_line()}")
    readings["steps"] = time_train_steps(device, experiment_cfg(exp), "phase 8d")
    with contextlib.redirect_stdout(io.StringIO()):
        kwargs = build_evaluator(eval_parser().parse_args(eval_argv(
            "ssp3d", ssp3d, weights["msgpack"], os.path.join(workdir, "eval_t50"),
            EVAL_BATCH, "cuda", "--pose_shape_cfg", cfg_path)))
    readings["eval_fps"], rates = timed_eval_runs(kwargs, EVAL_BATCH)
    log(f"[phase 8d] SSP-3D eval at batch {EVAL_BATCH}, ResNet-50 from flax "
        f"variables (--svd_impl auto: {kwargs['pose_shape_model'].svd_impl}): "
        f"median {readings['eval_fps']:.2f} frames/s (runs "
        f"{[round(r, 2) for r in rates]})")
    predictor = build_pose_shape_model(kwargs["pose_shape_cfg"], "jacobi")
    model = build_pose_shape_model(cfg, "jacobi")
    optimizer = torch.optim.Adam(model.parameters())
    loads = {
        "predictor_tar": lambda: load_predictor_state_dict(weights["tar"], predictor),
        "predictor_msgpack": lambda: load_predictor_state_dict(weights["msgpack"],
                                                               predictor),
        "training_reference_layout": lambda: load_training_checkpoint(ref_ckpt),
        "training_jax_layout": lambda: to_reference_layout(
            load_training_checkpoint(jax_ckpt), model, optimizer),
    }
    readings["load_ms"] = {name: host_ms(fn) for name, fn in loads.items()}
    sizes = {name: os.path.getsize(path) for name, path in (
        ("predictor_tar", weights["tar"]), ("predictor_msgpack", weights["msgpack"]),
        ("training_reference_layout", ref_ckpt), ("training_jax_layout", jax_ckpt))}
    for name, ms in readings["load_ms"].items():
        log(f"[phase 8d] load {name} ({sizes[name]} bytes): median {ms:.1f} ms "
            f"of 3 (host clock, to state dicts on the CPU)")
    readings["kernel"] = time_rasterizer("phase 8d", "train_resnet50", scene, covered)
    del kwargs
    lap("phase 8d")
    return readings


# Phase 9: the training data path. Synthetic source files in the shapes of
# the real ones (poses of 72 float32, 1200 x 800 uint8 atlases, 640 x 480
# jpgs), packed per split; the three stores' record counts differ on
# purpose (288 / 48 / 160 train, 144 / 48 / 40 val).
NATIVE_POSES = {"train": 288, "val": 144}
NATIVE_BACKGROUNDS = {"train": 160, "val": 40}
NATIVE_TEXTURES = (8, 40)                # grey, non-grey atlases
TEXTURE_HW = (1200, 800)
BACKGROUND_HW = (480, 640)
# Phase 9d's stores: 72 poses a split, one step each.
PROFILE_POSES = 72
# Phase 9e: the card against the CPU on pw3d_eval_extract's outputs.
PW3D_PX_TOL = 1e-3
PW3D_POSE_TOL = 1e-5


def log_map_tolerance(rotvecs):
    """How far two float32 evaluations of the SO(3) log map (so3_log) may
    differ, per rotation vector: 1e-5 rad plus four float32 ulps of its
    cosine carried through the generic branch w theta / (2 sin theta), an
    error of ~ulp theta / sin^2 theta where sin theta is small near pi (s =
    sin theta above pi / 2, else 1). The near-pi branch (theta > pi - 1e-3)
    is not covered.

    :param rotvecs: (N, 3) float64 rotation vectors
    :return: (N,) tolerances in rad
    """
    theta = np.linalg.norm(rotvecs, axis=-1)
    s = np.where(theta > np.pi / 2, np.sin(theta), 1.0)
    return 1e-5 + 4 * np.finfo(np.float32).eps * theta / s ** 2


def write_train_sources(root, n_poses, n_grey, n_nongrey, n_backgrounds,
                        texture_hw=TEXTURE_HW, background_hw=BACKGROUND_HW, seed=0):
    """Training source files in the real ones' layouts, from a seed: an npz
    of poses (fnames, poses (n, 72) float32), an npz of grey and non-grey
    uint8 (n, H, W, 3) atlases, and a folder of jpgs (smooth random images,
    upsampled noise, so that jpg neither bloats nor blurs them away).

    :return: {"poses": path, "textures": path, "backgrounds": directory}
    """
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "backgrounds"))
    out = {"poses": os.path.join(root, "poses.npz"),
           "textures": os.path.join(root, "textures.npz"),
           "backgrounds": os.path.join(root, "backgrounds")}
    poses = (rng.randn(n_poses, 72) * 0.3).astype(np.float32)
    np.savez(out["poses"], fnames=np.array([f"h36m_{i:06d}" for i in range(n_poses)]),
             poses=poses)

    def smooth(n, hw):
        small = (rng.rand(n, max(hw[0] // 40, 2), max(hw[1] // 40, 2), 3) * 255
                 ).astype(np.uint8)
        return np.stack([cv2.resize(a, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
                         for a in small]) if n else np.zeros((0, *hw, 3), np.uint8)

    grey = np.repeat(smooth(n_grey, texture_hw)[..., :1], 3, axis=-1)
    np.savez(out["textures"], grey=grey, nongrey=smooth(n_nongrey, texture_hw))
    for i, img in enumerate(smooth(n_backgrounds, background_hw)):
        cv2.imwrite(os.path.join(out["backgrounds"], f"bg_{i:05d}.jpg"), img)
    return out


def pack_split(out_dir, sources, img_wh):
    """The port's pack functions over one split's sources into out_dir
    (per-vertex texels).

    :return: {store file: bytes}
    """
    from hierarchicalprobabilistic3dhuman_torch.data.pack_training_stores import (
        pack_backgrounds, pack_poses, pack_textures)
    os.makedirs(out_dir)
    pack_poses(sources["poses"], os.path.join(out_dir, "poses.bin"))
    pack_textures(sources["textures"], os.path.join(out_dir, "textures.bin"))
    pack_backgrounds(sources["backgrounds"], os.path.join(out_dir, "backgrounds.bin"),
                     img_wh=img_wh)
    return {f: os.path.getsize(os.path.join(out_dir, f))
            for f in ("poses.bin", "textures.bin", "backgrounds.bin")}


def read_stores(store_dir):
    """The three stores of a split as numpy arrays."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        read_store_meta)
    out = {}
    for name in ("poses", "textures", "backgrounds"):
        path = os.path.join(store_dir, f"{name}.bin")
        shape, dtype = read_store_meta(path)
        out[name] = np.fromfile(path, dtype=dtype).reshape(shape)
    return out


def store_paths(store_dir):
    return [os.path.join(store_dir, f"{name}.bin")
            for name in ("poses", "textures", "backgrounds")]


def check_sampler(tag, store_dir, batch=72):
    """The sampler as built on this machine: every record of 20 shuffled
    batches (2 threads) is a record of its own store; two samplers with one
    thread and one seed give equal bytes; in sequential mode with 2 threads
    no window comes twice."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeBatchSampler)
    stores = read_stores(store_dir)
    index = {name: {r.tobytes(): i for i, r in enumerate(a)}
             for name, a in stores.items()}
    sampler = NativeBatchSampler(store_paths(store_dir), batch, n_threads=2, seed=3)
    try:
        drawn = {name: set() for name in stores}
        for _ in range(20):
            for name, field in zip(stores, sampler.next()):
                for row in field:
                    i = index[name].get(row.tobytes())
                    if i is None:
                        raise AssertionError(f"[{tag}] a {name} row that is no "
                                             f"record of its store")
                    drawn[name].add(i)
    finally:
        sampler.close()
    pair = [NativeBatchSampler(store_paths(store_dir), batch, n_threads=1, seed=11)
            for _ in range(2)]
    try:
        equal = all(a.tobytes() == b.tobytes() for _ in range(5)
                    for a, b in zip(pair[0].next(), pair[1].next()))
    finally:
        for s in pair:
            s.close()
    # Windows repeat after n / 4 batches, and two threads may hand theirs
    # over out of order: read half as many.
    n = len(stores["poses"]) // 8
    sequential = NativeBatchSampler(store_paths(store_dir)[:1], 4, n_threads=2,
                                    shuffle=False)
    try:
        windows = [[index["poses"][row.tobytes()] for row in sequential.next()[0]]
                   for _ in range(n)]
    finally:
        sequential.close()
    windows_ok = (len({w[0] for w in windows}) == n
                  and all(w == list(range(w[0], w[0] + 4)) and w[0] % 4 == 0
                          for w in windows))
    log(f"[{tag}] sampler: 20 batches of {batch}, every record its own "
        f"store's ({ {k: f'{len(v)} of {len(stores[k])}' for k, v in drawn.items()} }"
        f" distinct records drawn); one thread, one seed, twice: equal bytes "
        f"{equal}; sequential, 2 threads, {n} windows of 4: each once "
        f"{windows_ok}")
    if not equal or not windows_ok:
        raise AssertionError(f"[{tag}] the sampler is not deterministic or "
                             f"repeats a window")


def check_trace(path):
    """A Chrome trace that parses and holds the card's kernel events, K1's
    raster_faces and resolve among them.

    :return: the file's bytes, the seconds to parse it, its kernel events
    """
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    parse_s = time.perf_counter() - t0
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = {part: sum(part in e.get("name", "") for e in kernels)
          for part in ("raster_faces", "resolve")}
    return os.path.getsize(path), parse_s, len(events), len(kernels), k1


def profiled_runs(tag, what, main, argv, profile_dir, attempts=2):
    """`main(argv)` once without and once with --profile_dir, each ending
    in a synchronize; the trace checked (check_trace). The profiler can lose
    device events, so a trace without K1's is taken again, up to
    `attempts` times, before the phase fails."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv(0))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for attempt in range(1, attempts + 1):
        out_dir = f"{profile_dir}_{attempt}"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv(attempt) + ["--profile_dir", out_dir])
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
        size, parse_s, n_events, n_kernels, k1 = check_trace(
            os.path.join(out_dir, "trace.json"))
        log(f"[{tag}] {what}: {plain_s:.2f} s without the profiler, "
            f"{profiled_s:.2f} s with it (the trace's export included); "
            f"trace.json {size} bytes, {n_events} events, {n_kernels} kernel "
            f"events, K1 {k1}; parsed in {parse_s:.2f} s (attempt {attempt})")
        if n_kernels and all(k1.values()):
            return {"plain_s": plain_s, "profiled_s": profiled_s, "bytes": size,
                    "kernel_events": n_kernels}
    raise AssertionError(f"[{tag}] {what}: no trace with K1's kernel events")


def write_pw3d_sequence(root, height=240, width=320, seed=8):
    """A 3DPW sequence in the official layout (sequenceFiles/test/*.pkl,
    imageFiles/<sequence>/image_NNNNN.jpg): 2 people, male and female, over
    3 frames, the second person's frame 1 without a valid camera pose;
    small random poses about an upright body, a moving camera 6 m away
    (500 px focal length) and smooth synthetic jpgs.

    :return: the sequence's name
    """
    import pickle
    import cv2
    seq = "downtown_synthetic_00"
    rng = np.random.RandomState(seed)
    frames = 3
    poses = [rng.randn(frames, 72) * 0.2 for _ in range(2)]
    for p in poses:
        p[:, :3] = [np.pi, 0.0, 0.0] + 0.1 * rng.randn(frames, 3)
    cam_poses = np.tile(np.eye(4), (frames, 1, 1))
    for f in range(frames):
        cam_poses[f, :3, :3] = cv2.Rodrigues(np.array([0.02, 0.05 * f, 0.01]))[0]
        cam_poses[f, :3, 3] = [0.05 * f, 0.1, 6.0]
    data = {
        "sequence": seq,
        "poses": poses,
        "betas": [rng.randn(16) * 0.5 for _ in range(2)],
        "trans": [np.c_[[-0.6, 0.6][i] + 0.02 * np.arange(frames),
                        np.zeros(frames), np.zeros(frames)] for i in range(2)],
        "cam_poses": cam_poses,
        "cam_intrinsics": np.array([[500.0, 0.0, width / 2],
                                    [0.0, 500.0, height / 2], [0.0, 0.0, 1.0]]),
        "genders": ["m", "f"],
        "campose_valid": [np.ones(frames), np.array([1.0, 0.0, 1.0])],
    }
    os.makedirs(os.path.join(root, "sequenceFiles", "test"))
    with open(os.path.join(root, "sequenceFiles", "test", f"{seq}.pkl"), "wb") as f:
        pickle.dump(data, f, protocol=2)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    os.makedirs(os.path.join(root, "imageFiles", seq))
    for f in range(frames):
        img = np.stack([xx * 0.6 + 20 * f, yy * 0.8,
                        100 + 60 * np.sin(xx / 40.0 + yy / 50.0 + f)], axis=-1)
        cv2.imwrite(os.path.join(root, "imageFiles", seq, f"image_{f:05d}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return seq


def pw3d_card_vs_cpu(tag, workdir, device):
    """pw3d_eval_extract on a synthetic sequence (write_pw3d_sequence) on
    the card and on the CPU, each with synthetic SMPL of seeds 0 (male) and
    1 (female): names and genders equal, centres and sizes within
    PW3D_PX_TOL px, body poses and shapes within PW3D_POSE_TOL, and the
    global orientations (so3_log of the camera-composed rotation, near pi
    for an upright person) within log_map_tolerance."""
    from hierarchicalprobabilistic3dhuman_torch.data.pw3d_preprocess import (
        pw3d_eval_extract)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    root = os.path.join(workdir, "3dpw_raw")
    write_pw3d_sequence(root)
    out = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        path = os.path.join(root, f"test_{name}")
        os.makedirs(os.path.join(path, "cropped_frames"))
        models = {"m": SMPL.synthetic(dev, seed=0), "f": SMPL.synthetic(dev, seed=1)}
        with contextlib.redirect_stdout(io.StringIO()):
            pw3d_eval_extract(root, path, smpl_models=models, device=dev)
        out[name] = np.load(os.path.join(path, "3dpw_test.npz"))
    card, cpu = out["card"], out["cpu"]
    same = (list(card["imgname"]) == list(cpu["imgname"])
            and list(card["gender"]) == list(cpu["gender"]))
    errs = {k: float(np.abs(card[k] - cpu[k]).max())
            for k in ("center", "wh", "shape")}
    errs["body_pose"] = float(np.abs(card["pose"][:, 3:] - cpu["pose"][:, 3:]).max())
    glob = np.abs(card["pose"][:, :3] - cpu["pose"][:, :3]).max(axis=1)
    glob_tol = log_map_tolerance(cpu["pose"][:, :3].astype(np.float64))
    log(f"[{tag}] pw3d_eval_extract card vs CPU on {len(cpu['imgname'])} "
        f"frames of 2 people: names and genders equal {same}; max abs diffs "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {PW3D_PX_TOL} px, "
        f"{PW3D_POSE_TOL}); global orientations {[f'{g:.2e}' for g in glob]} "
        f"rad at angles {[f'{t:.4f}' for t in np.linalg.norm(cpu['pose'][:, :3], axis=1)]} "
        f"(tol {[f'{t:.2e}' for t in glob_tol]})")
    if (not same or len(cpu["imgname"]) != 5
            or max(errs["center"], errs["wh"]) > PW3D_PX_TOL
            or max(errs["body_pose"], errs["shape"]) > PW3D_POSE_TOL
            or (glob > glob_tol).any()):
        raise AssertionError(f"[{tag}] pw3d_eval_extract on the card disagrees "
                             f"with the CPU")


def native_timings(tag, device, store_dir, readings):
    """The input pipeline at B = 72 from the stores beside the fallback
    dataset: the sampler's batch ms (2 threads, median of 20 after the
    queue's first 4), the upload of a packed and of a fallback batch (in
    turns, median of 5 each), and per stage the train step fed from each
    (upload, step and loss read, host clock ending in a sync; in turns,
    median of 5 each after a warm-up)."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeBatchSampler)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    cfg = train_cfg()
    B = cfg.TRAIN.BATCH_SIZE
    sampler = NativeBatchSampler(store_paths(store_dir), B, n_threads=2, seed=0)
    try:
        waits = []
        for _ in range(24):
            t0 = time.perf_counter()
            fields = sampler.next()
            waits.append((time.perf_counter() - t0) * 1e3)
    finally:
        sampler.close()
    packed = dict(zip(("pose", "texture", "background"), fields))
    fallback = train_batch(B, cfg.DATA.PROXY_REP_SIZE, seed=3)
    hosts = {"fallback": fallback, "packed": packed}
    nbytes = {k: sum(v[f].nbytes for f in ("pose", "texture", "background"))
              for k, v in hosts.items()}
    readings["batch_ms"] = statistics.median(waits[4:])
    log(f"[{tag}] NativeBatchSampler, B={B}, 2 threads: a batch "
        f"({nbytes['packed']} bytes) in median {readings['batch_ms']:.3f} ms "
        f"of 20 (the queue's first 4: {[round(t, 3) for t in waits[:4]]} ms)")

    uploads = {k: [] for k in hosts}
    for i in range(6):
        for k in (("fallback", "packed") if i % 2 else ("packed", "fallback")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_to_device(hosts[k], device)
            torch.cuda.synchronize()
            uploads[k].append((time.perf_counter() - t0) * 1e3)
    readings["upload_ms"] = {k: statistics.median(v[1:]) for k, v in uploads.items()}
    log(f"[{tag}] upload of a loader batch (pinned, then copied), median of "
        f"5: packed {readings['upload_ms']['packed']:.3f} ms "
        f"({nbytes['packed']} bytes), fallback "
        f"{readings['upload_ms']['fallback']:.3f} ms ({nbytes['fallback']} bytes)")

    model, smpl, renderer, edge = train_parts(device, cfg)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    draws = Draws(torch.Generator(device=device).manual_seed(0))
    readings["img_s"] = {}
    for stage in (1, 2):
        metrics = TRAIN_METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
        step = TrainStep(model, cfg, smpl, renderer, edge,
                         getattr(cfg.LOSS, f"STAGE{stage}"), optimizer,
                         train=True, metrics_to_track=metrics)
        walls = {k: [] for k in hosts}
        for i in range(6):
            for k in (("fallback", "packed") if i % 2 else ("packed", "fallback")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _, _ = step(draws, *batch_to_device(hosts[k], device))
                float(loss)
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) * 1e3)
        rates = {k: B / statistics.median(v[1:]) * 1e3 for k, v in walls.items()}
        readings["img_s"][f"stage{stage}"] = rates
        log(f"[{tag}] stage {stage} train step at B={B}, upload included: "
            f"packed {rates['packed']:.2f} img/s (steps "
            f"{[round(t, 2) for t in walls['packed']]} ms), fallback "
            f"{rates['fallback']:.2f} img/s (steps "
            f"{[round(t, 2) for t in walls['fallback']]} ms)")


def phase_native(workdir, device):
    """Phase 9: the training data path (see the module docstring).

    :return: dict of the readings for the kernels line
    """
    from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import main as eval_main
    from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        build_sampler)
    t0 = time.perf_counter()
    readings = {"launches": {}}

    def lap(tag):
        nonlocal t0
        log(f"[{tag}] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    # (a) sources in the real files' shapes, packed per split.
    t_build = time.perf_counter()
    lib = build_sampler()
    log(f"[phase 9a] sampler built with g++ in "
        f"{time.perf_counter() - t_build:.1f} s: {os.path.relpath(lib, REPO)}")
    stores = os.path.join(workdir, "native")
    wh = train_cfg().DATA.PROXY_REP_SIZE
    sources = {}
    for i, split in enumerate(("train", "val")):
        t_src = time.perf_counter()
        sources[split] = write_train_sources(
            os.path.join(workdir, f"train_files_{split}"), NATIVE_POSES[split],
            *NATIVE_TEXTURES, NATIVE_BACKGROUNDS[split], seed=i)
        t_pack = time.perf_counter()
        sizes = pack_split(os.path.join(stores, split), sources[split], wh)
        log(f"[phase 9a] {split}: {NATIVE_POSES[split]} poses, "
            f"{sum(NATIVE_TEXTURES)} atlases, {NATIVE_BACKGROUNDS[split]} "
            f"backgrounds written in {t_pack - t_src:.1f} s, packed in "
            f"{time.perf_counter() - t_pack:.1f} s: {sizes} bytes")
    lap("phase 9a")

    # (b) two epochs from the stores, then both kernels held to their plain
    # versions on the tables of the run's last render.
    exp = os.path.join(workdir, "train_native")
    with recording_renderers() as made:
        _, readings["launches"]["train_native_2_epochs"] = run_path(
            "phase 9b", "run_train_torch.py -O LOSS.STAGE_CHANGE_EPOCH 1 "
            "--num_epochs 2 --native_data_dir (B=72, 256^2)",
            lambda: train_main(["-E", exp, "-O", "LOSS.STAGE_CHANGE_EPOCH", "1",
                                "--num_epochs", "2", "--native_data_dir", stores]),
            expect=2 * TRAIN_STEPS_A_EPOCH)
    check_experiment("phase 9b", exp, epochs=2)
    (recorder,) = made
    texels = tuple(recorder.last[2].shape)
    log(f"[phase 9b] the last render's textures: {texels} (per-vertex texels "
        f"from the store)")
    if texels != (experiment_cfg(exp).TRAIN.BATCH_SIZE, 7829, 3):
        raise AssertionError("[phase 9b] the render did not take the store's texels")
    scene = recorder.scene()
    covered, readings["attr_err"], readings["box_err"], _ = hold_to_plain(
        "phase 9b", "train_native", scene)
    lap("phase 9b")

    # (c) the sampler built on this machine.
    check_sampler("phase 9c", os.path.join(stores, "train"))
    lap("phase 9c")

    # (d) --profile_dir on training (stores of 72 records a split) and on
    # the SSP-3D evaluation of phase 6's folder.
    small = os.path.join(workdir, "native_small")
    for split in ("train", "val"):
        poses = os.path.join(workdir, f"poses_{split}_{PROFILE_POSES}.npz")
        with np.load(sources[split]["poses"]) as data:
            np.savez(poses, fnames=data["fnames"][:PROFILE_POSES],
                     poses=data["poses"][:PROFILE_POSES])
        pack_split(os.path.join(small, split), dict(sources[split], poses=poses), wh)
    readings["profile"] = {
        "train": profiled_runs(
            "phase 9d", f"run_train_torch.py --native_data_dir, 1 epoch of "
            f"{PROFILE_POSES} train + {PROFILE_POSES} val poses", train_main,
            lambda i: ["-E", os.path.join(workdir, f"train_profiled_{i}"),
                       "--num_epochs", "1", "--native_data_dir", small],
            os.path.join(workdir, "profile_train")),
        "eval": profiled_runs(
            "phase 9d", f"run_evaluate_torch.py --dataset ssp3d --batch_size "
            f"{EVAL_BATCH} on phase 6's folder", eval_main,
            lambda i: eval_argv("ssp3d", os.path.join(workdir, "ssp3d"),
                                os.path.join(workdir, "model.tar"),
                                os.path.join(workdir, f"eval_profiled_{i}"),
                                EVAL_BATCH, "cuda"),
            os.path.join(workdir, "profile_eval"))}
    lap("phase 9d")

    # (e) the offline 3DPW preprocessing, card against CPU.
    pw3d_card_vs_cpu("phase 9e", workdir, device)
    lap("phase 9e")

    # (f) timings.
    log(f"[phase 9f] on {card_line()}")
    native_timings("phase 9f", device, os.path.join(stores, "train"), readings)
    readings["kernel"] = time_rasterizer("phase 9f", "train_native", scene, covered)
    lap("phase 9f")
    return readings


# ---- phase 10: the multi-device paths (parallel/) ----
#
# The ranks of 10b are processes of this script (`chip_smoke.py --rank
# SPEC RANK`), which the CPU tests start too (tests/test_torch_sharded_*.py):
# each joins a gloo or NCCL group, builds a mesh, runs one scenario and
# saves what the comparison reads.

PAR_FLOOR = 1e-5            # the rule: max(PAR_FLOOR, 10 x float32 floor)
PAR_EVAL_METRICS = ["PVE", "PVE-PA", "PVE-T-SC", "MPJPE-SC", "joints2D-L2E",
                    "silhouette-IOU", "PVE_samples_min", "MPJPE-PA_samples_min",
                    "joints2Dsamples-L2E", "silhouettesamples-IOU"]


def to_cpu(tree):
    """Tensors (in nested dicts and lists) detached onto the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


class RecordingAdam(torch.optim.Adam):
    """Adam that keeps the gradients it was handed (after DDP's
    all-reduce), in parameter order."""

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone()
                      for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def rel_diff(a, b):
    """max |a - b| over max |b| (1 where b is all zero and a is not)."""
    a, b = a.double(), b.double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    d = float((a - b).abs().max()) if b.numel() else 0.0
    return d / scale if scale > 0 else (0.0 if d == 0 else 1.0)


def check_rank_kernels(name, scene):
    """On rank 0 of a 10b group: both kernels against their plain versions
    on a path's tables, and K1's time there beside its bound.

    :return: dict attr_err, box_err, meshes, hw, kernel_ms, bound_ms,
        bound_by
    """
    covered, attr_err, box_err, _ = hold_to_plain("phase 10b", name, scene)
    return {"attr_err": attr_err, "box_err": box_err,
            "meshes": int(scene.screen.shape[0]),
            "hw": list(scene.tables.image_hw),
            **time_rasterizer("phase 10b", name, scene, covered)}


def counted(fn):
    """fn() with both kernels' launch counts set to 0 just before it and
    read just after (None off the card).

    :return: fn's result, the counts
    """
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_cuda, rasterize_packed_cuda)
    rasterize_packed_cuda.launches = face_boxes_cuda.launches = 0
    result = fn()
    if not torch.cuda.is_available():
        return result, None
    torch.cuda.synchronize()
    return result, {"rasterize": rasterize_packed_cuda.launches,
                    "face_boxes": face_boxes_cuda.launches}


class Float64Predictor(torch.nn.Module):
    """The predictor computed in float64 inside a float32 step: float32
    input in, outputs rounded to float32 out."""

    def __init__(self, model64):
        super().__init__()
        self.model = model64

    def forward(self, x):
        return {k: v.float() for k, v in self.model(x.double()).items()}


def _train_step_run(device, cfg, stage, host_batch, model, mesh, seed,
                    recorder=None):
    """The train step of par_train_step on `model` (the predictor, or its
    Float64Predictor), its render through `recorder` (a CallRecorder of a
    training renderer) when one is given; returns its loss, terms, sums and
    Adam's gradients."""
    from hierarchicalprobabilistic3dhuman_torch.parallel import (
        make_sharded_train_step)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    _, smpl, renderer, edge = train_parts(device, cfg)
    if recorder is not None:
        recorder.renderer, recorder.faces = renderer, renderer.faces
        renderer = recorder
    optimizer = RecordingAdam(model.parameters(), lr=cfg.TRAIN.LR)
    metrics = TRAIN_METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
    step = TrainStep(model, cfg, smpl, renderer, edge,
                     cfg.LOSS.STAGE1 if stage == 1 else cfg.LOSS.STAGE2,
                     optimizer, train=True, metrics_to_track=metrics)
    if mesh is not None:
        step = make_sharded_train_step(step, mesh)
    loss, sums, terms = step(Draws(torch.Generator(device=device).manual_seed(seed)),
                             *batch_to_device(host_batch, device))
    return loss, terms, sums, optimizer.grads


def _train_state(model, names, grads):
    return {"grads": dict(zip(names, grads)),
            "buffers": {n: b for n, b in model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))},
            "params": dict(model.named_parameters())}


def par_train_step(device, cfg, stage, host_batch, mesh=None, seed=0,
                   floors=False, check_kernels=False):
    """One train step of the loss stage `stage` on the global `host_batch`:
    weights from seed 0, a fresh Adam, draws from `seed`; sharded over
    `mesh` when one is given.

    :param floors: also return the float32 floors (1 rank): per tensor, the
        step's gradients, BatchNorm statistics and weights after Adam
        against those of the same step with the predictor computed in
        float64 (Float64Predictor), relative to the tensor's largest entry
    :param check_kernels: hold both kernels to their plain versions on the
        tables of the step's render (on the card)
    :return: dict of loss, terms, sums, grads, buffers (BatchNorm running
        statistics) and params (after Adam), on the CPU; on the card the
        kernels' launches in the step and, checked, their differences
    """
    import copy
    model = train_parts(device, cfg)[0]
    names = [n for n, _ in model.named_parameters()]
    model64 = copy.deepcopy(model).double() if floors else None
    recorder = CallRecorder(None) if check_kernels else None
    (loss, terms, sums, grads), launches = counted(lambda: _train_step_run(
        device, cfg, stage, host_batch, model, mesh, seed, recorder))
    out = to_cpu({"loss": loss, "terms": terms, "sums": sums, "lr": cfg.TRAIN.LR,
                  **_train_state(model, names, grads), "launches": launches})
    if check_kernels:
        out["kernels"] = {"train_rank": check_rank_kernels("train rank",
                                                           recorder.scene())}
    if floors:
        grads64 = _train_step_run(device, cfg, stage, host_batch,
                                  Float64Predictor(model64), None, seed)[3]
        ref = to_cpu(_train_state(model64, names, grads64))
        out["floors"] = {kind: {n: rel_diff(out[kind][n], r)
                                for n, r in ref[kind].items()}
                         for kind in ref}
    return out


def adam_ratio(got, ref, grad, grad_tol, tol, lr):
    """The largest difference of a weight tensor after Adam's first step
    over its allowance. The step moves each weight by lr times the sign of
    its gradient (m / sqrt(v) = g / |g|), so where a gradient lies within
    the gradients' tolerance of zero its sign is rounding and the weight
    may move by up to 2 lr more; elsewhere the weight is held to `tol` of
    the tensor's largest entry, as the other tensors are."""
    band = grad.abs() <= grad_tol * grad.abs().max()
    allowed = tol * ref.abs().max() + torch.where(band, 2.0 * lr, 0.0)
    return float(((got - ref).abs() / allowed).max())


def compare_train(tag, ref, got):
    """A sharded step against the 1-rank one: the loss, its terms and the
    metric sums within PAR_FLOOR relative; every gradient and BatchNorm
    statistic per tensor within max(PAR_FLOOR, 10 x its float32 floor) of
    its largest entry, and every weight after Adam too, but where its
    gradient is within the gradients' tolerance of zero (adam_ratio).

    :return: the largest difference over its tolerance (<= 1 holds)
    """
    ratios = {}
    for kind in ("terms", "sums"):
        for k, r in ref[kind].items():
            ratios[f"{kind}.{k}"] = rel_diff(got[kind][k], r) / PAR_FLOOR
    ratios["loss"] = rel_diff(got["loss"], ref["loss"]) / PAR_FLOOR
    worst = {}
    floors = ref["floors"]
    for kind in ("grads", "buffers", "params"):
        for n, r in ref[kind].items():
            tol = max(PAR_FLOOR, 10 * floors[kind][n])
            if kind == "params":
                ratios[f"{kind}.{n}"] = adam_ratio(
                    got[kind][n].double(), r.double(), ref["grads"][n].double(),
                    max(PAR_FLOOR, 10 * floors["grads"][n]), tol, ref["lr"])
            else:
                ratios[f"{kind}.{n}"] = rel_diff(got[kind][n], r) / tol
        k = max((key for key in ratios if key.startswith(kind + ".")),
                key=ratios.get)
        worst[kind] = f"{k[len(kind) + 1:]} {ratios[k]:.2f}"
    top = max(ratios, key=ratios.get)
    log(f"[{tag}] vs 1 rank: loss {float(got['loss']):.7g} vs "
        f"{float(ref['loss']):.7g}; worst of tolerance: {worst}; overall "
        f"{top} {ratios[top]:.2f}")
    return ratios[top]


def par_eval_parts(device, cfg, weights=None):
    """The eval step's models at `cfg`: the predictor (in eval mode, from
    `weights` or seed 0), synthetic SMPL of the three genders (seeds 0, 1,
    2), Canny with threshold 0 and the silhouette renderer."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    model = build_pose_shape_model(cfg, "jacobi")
    if weights is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(weights)
    smpls = [SMPL.synthetic(device, seed=s) for s in range(3)]
    return (model.to(device).eval(), smpls, CannyEdgeDetector(device, threshold=0.0),
            silhouette_renderer(device, cfg.DATA.PROXY_REP_SIZE))


def par_eval_step(device, inputs, mesh=None, check_kernels=False):
    """One eval step on the global batch of `inputs` ({"cfg": overrides,
    "batch": the step's tensors, "draws": sample_draws' dict, "metrics",
    "num_samples", "silhouettes", "weights"}), sharded over `mesh` when one
    is given; the frame metrics on the device.

    :param check_kernels: hold both kernels to their plain versions on the
        tables of the step's two renders (on the card)
    :return: the step's outputs on the CPU; on the card with the kernels'
        launches in the step and, checked, their differences
    """
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        make_eval_step)
    from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
        make_eval_frame_metrics_fn)
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_list(inputs["cfg"])
    model, smpls, edge, renderer = par_eval_parts(device, cfg, inputs.get("weights"))
    silhouettes = renderer
    if check_kernels:
        renderer = RecordingRenderer(silhouettes)
    n = inputs["num_samples"]
    step = make_eval_step(
        model, *smpls, edge, cfg, n, True, inputs["silhouettes"], True, renderer,
        frame_metrics_fn=make_eval_frame_metrics_fn(inputs["metrics"], mesh, n),
        mesh=mesh)
    b = inputs["batch"]
    out, launches = counted(lambda: step(
        {k: v.to(device) for k, v in inputs["draws"].items()},
        *(b[k].to(device) for k in ("image", "heatmaps", "pose", "shape",
                                    "gender", "joints2d", "silhouette"))))
    out = to_cpu(out)
    if launches is not None:
        out["launches"] = launches
    if check_kernels:
        wh = cfg.DATA.PROXY_REP_SIZE
        out["kernels"] = {}
        for name, (verts, cam_t, scale) in zip(("mode", "samples"), renderer.calls):
            screen, attrs = silhouettes.raster_inputs(verts, cam_t, scale)
            out["kernels"][f"eval_rank_{name}"] = check_rank_kernels(
                f"eval rank {name}", make_scene(screen, silhouettes.faces,
                                                attrs, (wh, wh)))
    return out


def compare_frames(tag, ref, got, tol=PAR_FLOOR, iou_tol=2e-3):
    """Frame metrics and per-frame outputs of a sharded eval step against
    the 1-rank step's, in frame order: relative to each value's largest
    within `tol`; the IOUs and their counts within `iou_tol` (an edge
    pixel can move with the last bits of a vertex).

    :return: the largest difference over its tolerance
    """
    ratios = {}
    for k, r in ref["frame_metrics"].items():
        t = iou_tol if ("IOU" in k or k.startswith("num_")) else tol
        ratios[k] = rel_diff(got["frame_metrics"][k], r) / t
    for k, r in ref.items():
        if k not in ("frame_metrics", "launches", "kernels"):
            ratios[k] = rel_diff(got[k], r) / tol
    top = max(ratios, key=ratios.get)
    log(f"[{tag}] vs 1 rank: {len(ratios)} outputs, worst {top} at "
        f"{ratios[top]:.2f} of its tolerance")
    return ratios[top]


def par_predict_core(device, inputs, mesh=None, render=False,
                     check_kernels=False):
    """The predict core on `inputs` ({"cfg": overrides, "num_samples",
    "hr", "joints2D", "confs", "seed"}), weights from seed 0, the sampler's
    draws from a generator of `seed`; its samples split over `mesh`.

    :param check_kernels: hold both kernels to their plain versions on the
        tables of the 6-view render (on the card, rendering)
    :return: the uncertainty, the mode and sample meshes (and, rendering,
        the views) on the CPU; on the card the kernels' launches and,
        checked, their differences
    """
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core)
    cfg = get_pose_shape_cfg_defaults()
    cfg.merge_from_list(inputs["cfg"])
    model, smpls, _, _ = par_eval_parts(device, cfg)
    renderer = figure_renderer(device, FIGURE_WH) if render else None
    core = make_predict_core(
        model, cfg, smpls[0], CannyEdgeDetector(device), renderer,
        get_pose2d_hrnet_cfg_defaults(),
        num_uncertainty_samples=inputs["num_samples"], render_vis=render,
        mesh=mesh)
    out, launches = counted(lambda: core(
        inputs["hr"].to(device), inputs["joints2D"].to(device),
        inputs["confs"].to(device),
        generator=torch.Generator(device=device).manual_seed(inputs["seed"])))
    keys = ["per_vertex_3Dvar", "verts_mode", "verts_samples", "joints_samples"]
    result = to_cpu({k: out[k] for k in keys + (["rgb_views"] if render else [])})
    if launches is not None:
        result["launches"] = launches
    if check_kernels:
        with torch.inference_mode():
            scene = core_render_scene(out, smpls[0], renderer)
        result["kernels"] = {"predict_rank": check_rank_kernels("predict rank",
                                                                scene)}
    return result


def compare_predict(tag, ref, got, tol=PAR_FLOOR):
    """The sample-parallel core against the 1-rank core: every output
    relative to its largest within `tol`."""
    ratios = {k: rel_diff(got[k], r) / tol for k, r in ref.items()
              if k not in ("launches", "kernels")}
    top = max(ratios, key=ratios.get)
    log(f"[{tag}] vs 1 rank: " + ", ".join(f"{k} {v * tol:.1e}"
                                           for k, v in ratios.items()))
    return ratios[top]


def rank_train(device, inputs):
    """Rank scenario: the train steps of inputs["runs"], each (stage,
    sample_parallel), on one global batch."""
    from hierarchicalprobabilistic3dhuman_torch.parallel import make_mesh
    import torch.distributed as dist
    cfg = train_cfg(inputs["img_wh"], inputs["num_samples"])
    cfg.merge_from_list(inputs["cfg"])
    check = inputs.get("check_kernels", False) and dist.get_rank() == 0
    outs = [par_train_step(device, cfg, stage, inputs["batch"],
                           make_mesh(sample_parallel=s, device=device),
                           inputs["seed"], check_kernels=check and i == 0)
            for i, (stage, s) in enumerate(inputs["runs"])]
    if inputs.get("timing"):
        outs[0]["timing"] = gloo_timing(device, cfg, inputs["batch"])
    return outs


def rank_eval(device, inputs):
    """Rank scenario: the eval step at each sample_parallel of
    inputs["sample_parallel"]."""
    import torch.distributed as dist
    from hierarchicalprobabilistic3dhuman_torch.parallel import make_mesh
    check = inputs.get("check_kernels", False) and dist.get_rank() == 0
    return [par_eval_step(device, inputs, make_mesh(sample_parallel=s, device=device),
                          check_kernels=check and i == 0)
            for i, s in enumerate(inputs["sample_parallel"])]


def rank_predict(device, inputs):
    """Rank scenario: the predict core with every rank on "sample"."""
    import torch.distributed as dist
    from hierarchicalprobabilistic3dhuman_torch.parallel import make_mesh
    mesh = make_mesh(sample_parallel=dist.get_world_size(), device=device)
    render = inputs.get("render", False)
    return [par_predict_core(device, inputs, mesh, render=render,
                             check_kernels=render and dist.get_rank() == 0)]


RANK_SCENARIOS = {"train": rank_train, "eval": rank_eval, "predict": rank_predict}


def rank_main(spec_path, rank):
    """One rank of run_ranks: join the group, run the scenario, save what
    it returns beside the spec."""
    import torch.distributed as dist
    from hierarchicalprobabilistic3dhuman_torch.parallel import distributed_init
    from hierarchicalprobabilistic3dhuman_torch.utils.device import set_full_f32
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    device = torch.device(spec["device"])
    set_full_f32(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    distributed_init(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                     backend=spec["backend"])
    inputs = torch.load(spec["inputs"], weights_only=False)
    scenarios = RANK_SCENARIOS
    if spec.get("module"):
        import importlib.util
        mod_spec = importlib.util.spec_from_file_location("rank_scenarios",
                                                          spec["module"])
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        scenarios = module.RANK_SCENARIOS
    context = (deterministic_algorithms() if spec["deterministic"]
               else contextlib.nullcontext())
    with context:
        out = scenarios[spec["scenario"]](device, inputs)
    torch.save(out, f"{spec['out']}.{rank}.pt")
    dist.destroy_process_group()
    return 0


def run_ranks(scenario, world, inputs, workdir, device="cpu", backend="gloo",
              threads=1, deterministic=False, timeout=900, module=None):
    """`world` ranks of this script on `scenario` (RANK_SCENARIOS, or those
    of the file `module`) with `inputs`, joined through `backend` on
    `device` (every rank on the same device); waits for all of them.

    :return: what each rank's scenario returned, in rank order
    """
    from hierarchicalprobabilistic3dhuman_torch.parallel import free_port
    os.makedirs(workdir, exist_ok=True)
    spec = {"scenario": scenario, "world": world, "port": free_port(),
            "device": str(device), "backend": backend, "threads": threads,
            "deterministic": deterministic, "module": module,
            "inputs": os.path.join(workdir, f"{scenario}_inputs.pt"),
            "out": os.path.join(workdir, f"{scenario}_out")}
    torch.save(inputs, spec["inputs"])
    spec_path = os.path.join(workdir, f"{scenario}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    logs = [os.path.join(workdir, f"{scenario}_rank{r}.log") for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", spec_path,
                 str(r)], stdout=f, stderr=subprocess.STDOUT, env=env))
    t0 = time.monotonic()
    try:
        # A rank that fails leaves the others waiting in a collective: stop
        # them all then.
        while any(p.poll() is None for p in procs):
            if (any(p.poll() for p in procs)
                    or time.monotonic() - t0 > timeout):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        tails = []
        for r, (p, path) in enumerate(zip(procs, logs)):
            with open(path) as f:
                tails.append(f"--- rank {r} (rc {p.returncode}):\n{f.read()[-3000:]}")
        raise RuntimeError(f"{scenario} ranks failed:\n" + "\n".join(tails))
    return [torch.load(f"{spec['out']}.{r}.pt", weights_only=False)
            for r in range(world)]


def allreduce_ms(numel, device, repeats=5):
    """Median host-clock ms of an all-reduce (sum over the world) of
    `numel` float32 values on `device`, each ending in a synchronize, after
    one warm-up."""
    import torch.distributed as dist
    x = torch.ones(numel, device=device)
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def step_ms(step, draws, arrays, repeats=5):
    """Median host-clock ms of a train step, its loss read as the loop
    reads it, after one warm-up."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(draws, *arrays)[0]
        float(loss)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def timed_steps(device, cfg, host_batch, mesh=None):
    """Train img/s per stage at cfg's batch: a plain step, or one sharded
    over `mesh` (its predictor in DDP); median of 5 steps."""
    from hierarchicalprobabilistic3dhuman_torch.parallel import (
        data_parallel, make_sharded_train_step)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep, batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.random_draws import Draws
    model, smpl, renderer, edge = train_parts(device, cfg)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR)
    ddp = None if mesh is None else data_parallel(model, mesh)
    arrays = batch_to_device(host_batch, device)
    draws = Draws(torch.Generator(device=device).manual_seed(0))
    out = {}
    for stage in (1, 2):
        metrics = TRAIN_METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
        step = TrainStep(model, cfg, smpl, renderer, edge,
                         getattr(cfg.LOSS, f"STAGE{stage}"), optimizer,
                         train=True, metrics_to_track=metrics)
        if mesh is not None:
            step = make_sharded_train_step(step, mesh, ddp)
        ms = step_ms(step, draws, arrays)
        out[f"stage{stage}_ms"] = ms
        out[f"stage{stage}_img_s"] = host_batch["pose"].shape[0] / ms * 1e3
    return out


def gloo_timing(device, cfg, host_batch):
    """In a rank of 10b: the sharded step's time per stage (data over the
    world) and the all-reduce of the predictor's gradients, over gloo."""
    from hierarchicalprobabilistic3dhuman_torch.parallel import make_mesh
    out = timed_steps(device, cfg, host_batch, make_mesh(device=device))
    n = sum(p.numel() for p in train_parts(device, cfg)[0].parameters())
    out.update(params=n, allreduce_ms=allreduce_ms(n, device))
    return out


PAR_TRAIN_RUNS = [(1, 1), (2, 1), (2, 2)]       # (stage, sample axis) at 2 ranks
PAR_EVAL = {"batch": 8, "samples": 10}
PAR_PREDICT = {"batch": 1, "samples": 50}
RESNET50_PARAMS = 27_200_000                     # float32 values, ~109 MB


def par_eval_inputs(seed=0, wh=256):
    """An SSP-3D batch at full width for the eval step: B = 8 random images,
    heatmaps, targets and silhouettes, mixed genders, and its draws."""
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        sample_draws)
    B, N = PAR_EVAL["batch"], PAR_EVAL["samples"]
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    yy, xx = np.mgrid[:wh, :wh]
    body = ((yy - wh / 2) / (wh / 3)) ** 2 + ((xx - wh / 2) / (wh / 6)) ** 2 < 1
    batch = {"image": t(rng.rand(B, 3, wh, wh)),
             "heatmaps": t(rng.rand(B, 17, wh, wh) ** 16),
             "pose": t(rng.randn(B, 72) * 0.2), "shape": t(rng.randn(B, 10)),
             "gender": torch.tensor([1, 2] * (B // 2), dtype=torch.int32),
             "joints2d": t(rng.rand(B, 17, 2) * wh),
             "silhouette": t(np.broadcast_to(body, (B, wh, wh)))}
    return {"cfg": [], "batch": batch, "metrics": list(SSP3D_METRICS),
            "num_samples": N, "silhouettes": True,
            "draws": sample_draws(torch.Generator().manual_seed(seed), B, N, 10, "cpu")}


def par_predict_inputs(seed=0):
    """One 288 x 384 crop with its joints for the predict core, 50
    samples, the 6 views rendered."""
    rng = np.random.RandomState(seed)
    B = PAR_PREDICT["batch"]
    joints = np.stack([rng.rand(B, 17) * 200 + 44, rng.rand(B, 17) * 300 + 42], -1)
    return {"cfg": [], "num_samples": PAR_PREDICT["samples"], "seed": 4,
            "render": True,
            "hr": torch.from_numpy(rng.rand(B, 3, 384, 288).astype(np.float32)),
            "joints2D": torch.from_numpy(joints.astype(np.float32)),
            "confs": torch.from_numpy(rng.rand(B, 17).astype(np.float32))}


def same_experiment(tag, exp_a, exp_b, epochs):
    """Two experiment directories hold the same log.pkl and the same
    checkpoints, tensor for tensor (bit-equal)."""
    import pickle
    with open(os.path.join(exp_a, "log.pkl"), "rb") as f:
        log_a = pickle.load(f)
    with open(os.path.join(exp_b, "log.pkl"), "rb") as f:
        log_b = pickle.load(f)
    differ = [k for k in log_a if log_a[k] != log_b.get(k)]
    names = sorted(os.listdir(os.path.join(exp_a, "saved_models")))
    if names != sorted(os.listdir(os.path.join(exp_b, "saved_models"))):
        differ.append("saved_models")
    for name in names:
        a = torch.load(os.path.join(exp_a, "saved_models", name), weights_only=False)
        b = torch.load(os.path.join(exp_b, "saved_models", name), weights_only=False)
        for key in ("model_state_dict", "best_model_state_dict"):
            differ += [f"{name}:{key}.{k}" for k, v in a[key].items()
                       if not torch.equal(v, b[key][k])]
        sa, sb = a["optimiser_state_dict"]["state"], b["optimiser_state_dict"]["state"]
        differ += [f"{name}:adam.{i}.{k}" for i in sa for k, v in sa[i].items()
                   if not torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k]))]
    log(f"[{tag}] {len(log_a['train_losses'])} epochs of log.pkl and {names}: "
        f"{'equal, bit for bit' if not differ else 'differ at ' + str(differ[:5])}")
    if differ or len(log_a["train_losses"]) != epochs:
        raise AssertionError(f"[{tag}] the world-1 run differs from the plain run")


def phase_parallel(workdir, device):
    """Phase 10: the multi-device paths (see the module docstring).

    :return: dict of the readings for the kernels line
    """
    import types
    import torch.distributed as dist
    from hierarchicalprobabilistic3dhuman_torch.cli import evaluate as eval_cli
    from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
    from hierarchicalprobabilistic3dhuman_torch.parallel import (
        distributed_init, free_port, make_mesh)

    readings = {"launches": {}}
    t0 = [time.perf_counter()]

    def lap(tag):
        log(f"[{tag}] took {time.perf_counter() - t0[0]:.1f} s")
        t0[0] = time.perf_counter()

    # (a) the CLI's multi-process path (NCCL, world 1) against the plain one
    def flags(name):
        if name == "plain":
            return ["--num_devices", "1"]
        return ["--coordinator_address", f"127.0.0.1:{free_port()}",
                "--num_processes", "1", "--process_id", "0"]

    exps = {}
    for name in ("plain", "world1"):
        exp = exps[name] = os.path.join(workdir, f"par_train_{name}")
        for what, argv, expect in (
                ("2 epochs", ["-O", "LOSS.STAGE_CHANGE_EPOCH", "1",
                              "TRAIN.EPOCHS_PER_SAVE", "1"],
                 2 * TRAIN_STEPS_A_EPOCH),
                ("resume", ["-R", "0"], TRAIN_STEPS_A_EPOCH)):
            run_flags = flags(name)
            with deterministic_algorithms():
                _, launches = run_path(
                    "phase 10a", f"run_train_torch.py {' '.join(argv + run_flags)} "
                    f"--num_epochs 2 ({what})",
                    lambda: train_main(["-E", exp, *argv, "--num_epochs", "2",
                                        *run_flags]), expect=expect)
            readings["launches"][f"train_{name}_{what.replace(' ', '_')}"] = launches
    same_experiment("phase 10a", exps["plain"], exps["world1"], epochs=2)

    # Phase 6's folder and weights (written here when phase 10 runs alone).
    ssp3d = os.path.join(workdir, "ssp3d")
    weights = os.path.join(workdir, "model.tar")
    if not os.path.isdir(ssp3d):
        write_ssp3d_folder(ssp3d, eval_photos())
    if not os.path.exists(weights):
        reference_checkpoint(weights)
    metrics = {}
    for name in ("plain", "world1"):
        save = os.path.join(workdir, f"par_eval_{name}")
        args = eval_cli.build_parser().parse_args(eval_argv(
            "ssp3d", ssp3d, weights, save, EVAL_BATCH, str(device)))
        if name == "world1":
            args.coordinator_address = f"127.0.0.1:{free_port()}"
            args.num_processes, args.process_id = 1, 0
        with deterministic_algorithms(), contextlib.redirect_stdout(io.StringIO()):
            metrics[name], launches = run_path(
                "phase 10a", f"run_evaluate_torch.py --dataset ssp3d --batch_size "
                f"{EVAL_BATCH} ({name})", lambda: eval_cli.run_evaluate(args),
                expect=4)
        readings["launches"][f"eval_{name}_16_frames"] = launches
    files = sorted(os.listdir(os.path.join(workdir, "par_eval_plain")))
    differ = [k for k in metrics["plain"] if metrics["plain"][k] != metrics["world1"][k]]
    differ += [f for f in files if not np.array_equal(
        np.load(os.path.join(workdir, "par_eval_plain", f)),
        np.load(os.path.join(workdir, "par_eval_world1", f)))]
    log(f"[phase 10a] evaluation at world 1 vs plain: {len(metrics['plain'])} "
        f"metrics and {len(files)} per-frame files, differing: {differ}")
    if differ:
        raise AssertionError("[phase 10a] the world-1 evaluation differs")
    lap("phase 10a")

    # (b) two ranks on this card through gloo against one rank
    cfg = train_cfg()
    host_batch = train_batch(cfg.TRAIN.BATCH_SIZE, cfg.DATA.PROXY_REP_SIZE, seed=3)
    worst = {}
    with deterministic_algorithms():
        refs = {stage: par_train_step(device, cfg, stage, host_batch, None, 5,
                                      floors=True) for stage in (1, 2)}
    outs = run_ranks("train", 2, {
        "img_wh": cfg.DATA.PROXY_REP_SIZE, "num_samples": cfg.LOSS.NUM_SAMPLES,
        "cfg": ["MODEL.EMBED_DIM", cfg.MODEL.EMBED_DIM], "seed": 5,
        "batch": host_batch, "runs": PAR_TRAIN_RUNS,
        "check_kernels": True, "timing": True},
        os.path.join(workdir, "ranks_train"), device=str(device), backend="gloo",
        threads=4, deterministic=True)
    for rank, per_run in enumerate(outs):
        for (stage, s), got in zip(PAR_TRAIN_RUNS, per_run):
            key = f"train_stage{stage}_data{2 // s}_sample{s}"
            worst[key] = max(worst.get(key, 0), compare_train(
                f"phase 10b {key} rank {rank}", refs[stage], got))
            readings["launches"][f"{key}_rank{rank}"] = got["launches"]
    readings["kernels"] = dict(outs[0][0]["kernels"])
    readings["gloo"] = outs[0][0]["timing"]
    lap("phase 10b train")

    eval_inputs = par_eval_inputs()
    with deterministic_algorithms():
        ref = par_eval_step(device, eval_inputs)
    eval_inputs.update(sample_parallel=[1, 2], check_kernels=True)
    outs = run_ranks("eval", 2, eval_inputs, os.path.join(workdir, "ranks_eval"),
                     device=str(device), backend="gloo", threads=4,
                     deterministic=True)
    for rank, per_mesh in enumerate(outs):
        for s, got in zip(eval_inputs["sample_parallel"], per_mesh):
            key = f"eval_data{2 // s}_sample{s}"
            worst[key] = max(worst.get(key, 0), compare_frames(
                f"phase 10b {key} rank {rank}", ref, got))
            readings["launches"][f"{key}_rank{rank}"] = got["launches"]
    readings["kernels"].update(outs[0][0]["kernels"])
    lap("phase 10b eval")

    predict_inputs = par_predict_inputs()
    with deterministic_algorithms():
        ref = par_predict_core(device, predict_inputs,
                               render=predict_inputs["render"])
    outs = run_ranks("predict", 2, predict_inputs,
                     os.path.join(workdir, "ranks_predict"), device=str(device),
                     backend="gloo", threads=4, deterministic=True)
    for rank, (got,) in enumerate(outs):
        worst[f"predict_sample2_rank{rank}"] = compare_predict(
            f"phase 10b predict core, sample 2 (25 / 25), rank {rank}", ref, got)
        readings["launches"][f"predict_sample2_rank{rank}"] = got["launches"]
    readings["kernels"].update(outs[0][0]["kernels"])
    for name, k in readings["kernels"].items():
        log(f"[phase 10b] rank 0's {name} tables ({k['meshes']} x {k['hw']}): "
            f"K1 attrs {k['attr_err']:.1e} from its plain version, boxes "
            f"{k['box_err']}; K1 {k['kernel_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']})")
    readings["attr_err"] = max((k["attr_err"] for k in readings["kernels"].values()),
                               default=0.0)
    readings["box_err"] = max((k["box_err"] for k in readings["kernels"].values()),
                              default=0)
    readings["worst_of_tolerance"] = worst
    log(f"[phase 10b] each path's largest difference over its tolerance: {worst}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"[phase 10b] the sharded paths disagree: {bad}")
    lap("phase 10b predict")

    # (c) times: DDP at world 1 (NCCL) against the plain step, the gradient
    # all-reduce at world 1, and the gloo ranks' (a correctness run).
    distributed_init(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        n18 = sum(p.numel() for p in train_parts(device, cfg)[0].parameters())
        readings["nccl_world1"] = {
            "plain": timed_steps(device, cfg, host_batch),
            "ddp": timed_steps(device, cfg, host_batch, make_mesh(device=device)),
            "allreduce_ms_resnet18": allreduce_ms(n18, device),
            "allreduce_ms_resnet50": allreduce_ms(RESNET50_PARAMS, device),
            "params_resnet18": n18}
    finally:
        dist.destroy_process_group()
    card = card_line()
    log(f"[phase 10c] {card}: train at B = {cfg.TRAIN.BATCH_SIZE}, NCCL world 1: "
        f"{json.dumps(readings['nccl_world1'])}")
    log(f"[phase 10c] {card}: two ranks on this card through gloo (a "
        f"correctness run, not a scaling number): {json.dumps(readings['gloo'])}")
    lap("phase 10c")
    return readings


def time_face_boxes_plain(scene):
    """face_boxes' plain version on a scene's faces, median of 5 x 20."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        face_boxes_plain, face_vertices)
    fv, _ = face_vertices(scene.screen, scene.faces)
    return median_ms(lambda: face_boxes_plain(fv, scene.tables.image_hw), inner=20)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        LOG_PATH, build_rasterizer)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import set_full_f32

    device = torch.device("cuda")
    set_full_f32(device)
    t0 = time.perf_counter()
    build_rasterizer()
    log(f"[phase 1] rasterizer built in {time.perf_counter() - t0:.1f} s")
    with open(LOG_PATH) as f:
        for line in f:
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[phase 1] rasterize: {line.strip()}")
    card = card_line()
    log(card)

    scenes, attr_err, box_err = timed_phase("phase 2", phase_kernel_vs_plain,
                                            device)
    with tempfile.TemporaryDirectory() as workdir:
        argv, launches = timed_phase("phase 3", phase_main_path, workdir)
        timed_phase("phase 3", phase_core_cuda_vs_cpu)
        timing = timed_phase("phase 4", phase_timing, argv, scenes)
        del scenes
        batched = phase_batched(workdir)
        evaluation = timed_phase("phase 6", phase_eval, workdir, device)
        training = timed_phase("phase 7", phase_train, workdir, device)
        resnet50 = timed_phase("phase 8", phase_resnet50, workdir, device)
        native = timed_phase("phase 9", phase_native, workdir, device)
        parallel = timed_phase("phase 10", phase_parallel, workdir, device)

    boxes = timing["face_boxes"]
    path_launches = {"per_image_3_photos": launches,
                     **{f"{path}_{'1_photo' if path == 'samples' else '12_photos'}":
                        counts for path, counts in batched["launches"].items()},
                     **evaluation["launches"],
                     "train_2_epochs": training["launches"],
                     "train_resume_1_epoch": training["resume_launches"],
                     **resnet50["launches"],
                     **native["launches"],
                     **parallel["launches"]}
    kernels = [{
        "name": "rasterize",
        "route": "cuda",
        "source": "hierarchicalprobabilistic3dhuman_torch/csrc/rasterize.cu",
        "replaces": "hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:240",
        "launches": launches["rasterize"],
        "max_abs_err": max(attr_err, batched["attr_err"], evaluation["attr_err"],
                           training["attr_err"], resnet50["attr_err"],
                           native["attr_err"], parallel["attr_err"]),
        "ms": timing["predict"]["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["predict"]["bound_ms"],
        "bound_by": timing["predict"]["bound_by"],
        "library_ms": None,
        "ms_eval": timing["eval"]["kernel_ms"],
        "bound_ms_eval": timing["eval"]["bound_ms"],
        "ms_train": training["kernel"]["kernel_ms"],
        "bound_ms_train": training["kernel"]["bound_ms"],
        "bound_by_train": training["kernel"]["bound_by"],
        "plain_ms_train": training["plain_ms"],
        "ms_train_resnet50": resnet50["kernel"]["kernel_ms"],
        "bound_ms_train_resnet50": resnet50["kernel"]["bound_ms"],
        "bound_by_train_resnet50": resnet50["kernel"]["bound_by"],
        "ms_train_native": native["kernel"]["kernel_ms"],
        "bound_ms_train_native": native["kernel"]["bound_ms"],
        "bound_by_train_native": native["kernel"]["bound_by"],
        "ms_batched": batched["kernels"]["batched"]["kernel_ms"],
        "bound_ms_batched": batched["kernels"]["batched"]["bound_ms"],
        "bound_by_batched": batched["kernels"]["batched"]["bound_by"],
        "ms_samples": batched["kernels"]["samples"]["kernel_ms"],
        "bound_ms_samples": batched["kernels"]["samples"]["bound_ms"],
        "bound_by_samples": batched["kernels"]["samples"]["bound_by"],
        **{f"{key}_{name}": evaluation["kernels"][name][field]
           for name in ("eval_mode", "eval_samples")
           for key, field in (("ms", "kernel_ms"), ("bound_ms", "bound_ms"),
                              ("bound_by", "bound_by"))},
        **{f"plain_ms_{name}": evaluation[f"plain_ms_{name}"]
           for name in ("eval_mode", "eval_samples")},
        "sharded_paths": {name: {k: v[k] for k in ("meshes", "hw", "kernel_ms",
                                                   "bound_ms", "bound_by")}
                          for name, v in parallel["kernels"].items()},
        "device_launches_per_call": timing["device_launches_per_call"],
        "launches_by_path": {k: v["rasterize"] for k, v in path_launches.items()},
    }, {
        "name": "face_boxes",
        "route": "cuda",
        "source": "hierarchicalprobabilistic3dhuman_torch/csrc/rasterize.cu",
        "replaces": "hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:97",
        "launches": launches["face_boxes"],
        "max_abs_err": max(box_err, batched["box_err"], evaluation["box_err"],
                           training["box_err"], resnet50["box_err"],
                           native["box_err"], parallel["box_err"]),
        "ms": boxes["predict"]["kernel_ms"],
        "plain_ms": boxes["plain_ms"],
        "bound_ms": boxes["predict"]["bound_ms"],
        "bound_by": boxes["predict"]["bound_by"],
        "library_ms": None,
        "ms_eval": boxes["eval"]["kernel_ms"],
        "bound_ms_eval": boxes["eval"]["bound_ms"],
        "ms_train": training["face_boxes"]["kernel_ms"],
        "bound_ms_train": training["face_boxes"]["bound_ms"],
        "plain_ms_train": training["face_boxes_plain_ms"],
        "ms_batched": batched["face_boxes"]["batched"]["kernel_ms"],
        "bound_ms_batched": batched["face_boxes"]["batched"]["bound_ms"],
        "ms_samples": batched["face_boxes"]["samples"]["kernel_ms"],
        "bound_ms_samples": batched["face_boxes"]["samples"]["bound_ms"],
        **{f"{key}_{name}": evaluation["face_boxes"][name][field]
           for name in ("eval_mode", "eval_samples")
           for key, field in (("ms", "kernel_ms"), ("bound_ms", "bound_ms"),
                              ("plain_ms", "plain_ms"))},
        "launches_by_path": {k: v["face_boxes"] for k, v in path_launches.items()},
    }]
    log(f"[phase 4] predict_ms_per_image {timing['predict_ms']}")
    for tag, readings in (("phase 5", batched), ("phase 6", evaluation),
                          ("phase 7", training), ("phase 8", resnet50),
                          ("phase 9", native), ("phase 10", parallel)):
        log(f"[{tag}] readings " + json.dumps(
            {k: v for k, v in readings.items()
             if k not in ("kernels", "face_boxes", "launches", "kernel")}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
