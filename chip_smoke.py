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
     larger than the image; the evaluation shape, 1 mesh at 256^2, A=3; and
     the training shape, 72 meshes at 256^2, A=12, perspective;
  3. drive the main path through the user's entry point,
     `run_predict_torch.py --cropped_images` on 3 demo photos at full width
     (HRNet-W48, ResNet-18, 50 samples, 512^2 renders, random weights), with
     the kernels' launch counters read around it (one launch of each per
     image), and
     check its figures and outputs; then check the predict core on the card
     against the same core on the CPU (plain rasterizer) on small inputs from
     3 seeds, with the kernel given the CPU's own tables, and report why
     colours differ where they do;
  4. time the per-image predict and its stages; the kernel at the predict,
     evaluation and training shapes beside its bound at each (the bytes it
     must move and the pixel-face tests the function needs); the device
     launches of one kernel call, counted from a profile; the rasterize step
     (tables + kernel) and its parts on the host's clock and the card's, at
     the predict and training shapes; and the kernel's plain version at the
     predict shape;
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
     the bfloat16 HRNet against float32. Each phase logs its wall time.

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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
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
    return render_scene(TexturedIUVRenderer(device, img_wh=img_wh), views)


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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
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
    return render_scene(TexturedIUVRenderer(device, img_wh=img_wh), samples_views(
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


def train_scene(device, batch=72, img_wh=256, focal_length=300.0, seed=2):
    """The training shape: `batch` synthetic-SMPL meshes with seeded poses,
    shapes and camera translations at 256^2, A = 12, projected as the JAX
    renderer's `_to_screen` does for projection_type="perspective":
    x = f X / Z + wh / 2, z = Z.

    :return: Scene with screen (batch, 7829, 3)
    """
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        X_AXIS, ZERO_T)
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
        aa_rotate_translate_points)

    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    smpl = SMPL.synthetic(device)
    verts = smpl(betas=tensor(rng.randn(batch, 10)),
                 body_pose=tensor(rng.randn(batch, 69) * 0.3),
                 global_orient=tensor(rng.randn(batch, 3) * 0.3))["vertices"]
    verts = aa_rotate_translate_points(verts, X_AXIS, np.pi, ZERO_T)
    cam_t = tensor([0.0, -0.2, 2.5] + rng.randn(batch, 3) * [0.05, 0.05, 0.25])
    renderer = TexturedIUVRenderer(device, img_wh=img_wh)
    _, vert_attrs = renderer.raster_inputs(
        verts, cam_t, tensor(np.ones((batch, 2))), tensor(rng.rand(batch, 6890, 3)))
    p = verts[:, renderer.verts_map, :] + cam_t[:, None, :]
    z = p[..., 2:3]
    screen = torch.cat([focal_length * p[..., :2] / z + img_wh / 2.0, z], dim=-1)
    return make_scene(screen, renderer.faces, vert_attrs, (img_wh, img_wh))


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
                        ("eval", eval_scene), ("train", train_scene)):
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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)

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
            renderer = TexturedIUVRenderer(dev, img_wh=hw[0])
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


def time_raster_step(name, scene):
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
        log(f"[phase 4] rasterize step {name}, {part}: host enqueues it in "
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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
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
        TexturedIUVRenderer(device, img_wh=512), kwargs["hrnet_cfg"])
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
    for name in ("predict", "train"):
        time_raster_step(name, scenes[name][0])
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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)

    device = kwargs["device"]
    by_shape = {}
    for f in sorted(os.listdir(image_dir)):
        rgb = cv2.cvtColor(cv2.imread(os.path.join(image_dir, f)),
                           cv2.COLOR_BGR2RGB)
        by_shape.setdefault(rgb.shape, []).append(rgb)
    chunk = next(g for g in by_shape.values() if len(g) >= BATCH)[:BATCH]
    stack = torch.as_tensor(np.stack(chunk), device=device)
    hr = hrnet_predict(kwargs, stack)
    renderer = TexturedIUVRenderer(device, img_wh=FIGURE_WH)
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
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
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
        TexturedIUVRenderer(device, img_wh=FIGURE_WH), kwargs["hrnet_cfg"])
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


def hrnet_predict(kwargs, stack):
    """One batched HRNet keypoint call on a uint8 NHWC stack on the card."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
        make_hrnet_batch_predictor)
    return make_hrnet_batch_predictor(
        kwargs["hrnet"], kwargs["hrnet_cfg"], kwargs["device"],
        bbox_scale_factor=kwargs["pose_shape_cfg"].DATA.BBOX_SCALE_FACTOR)(stack)


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

    boxes = timing["face_boxes"]
    path_launches = {"per_image_3_photos": launches,
                     **{f"{path}_{'1_photo' if path == 'samples' else '12_photos'}":
                        counts for path, counts in batched["launches"].items()}}
    kernels = [{
        "name": "rasterize",
        "route": "cuda",
        "source": "hierarchicalprobabilistic3dhuman_torch/csrc/rasterize.cu",
        "replaces": "hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:240",
        "launches": launches["rasterize"],
        "max_abs_err": max(attr_err, batched["attr_err"]),
        "ms": timing["predict"]["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["predict"]["bound_ms"],
        "bound_by": timing["predict"]["bound_by"],
        "library_ms": None,
        "ms_eval": timing["eval"]["kernel_ms"],
        "bound_ms_eval": timing["eval"]["bound_ms"],
        "ms_train": timing["train"]["kernel_ms"],
        "bound_ms_train": timing["train"]["bound_ms"],
        "ms_batched": batched["kernels"]["batched"]["kernel_ms"],
        "bound_ms_batched": batched["kernels"]["batched"]["bound_ms"],
        "bound_by_batched": batched["kernels"]["batched"]["bound_by"],
        "ms_samples": batched["kernels"]["samples"]["kernel_ms"],
        "bound_ms_samples": batched["kernels"]["samples"]["bound_ms"],
        "bound_by_samples": batched["kernels"]["samples"]["bound_by"],
        "device_launches_per_call": timing["device_launches_per_call"],
        "launches_by_path": {k: v["rasterize"] for k, v in path_launches.items()},
    }, {
        "name": "face_boxes",
        "route": "cuda",
        "source": "hierarchicalprobabilistic3dhuman_torch/csrc/rasterize.cu",
        "replaces": "hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:97",
        "launches": launches["face_boxes"],
        "max_abs_err": max(box_err, batched["box_err"]),
        "ms": boxes["predict"]["kernel_ms"],
        "plain_ms": boxes["plain_ms"],
        "bound_ms": boxes["predict"]["bound_ms"],
        "bound_by": boxes["predict"]["bound_by"],
        "library_ms": None,
        "ms_eval": boxes["eval"]["kernel_ms"],
        "bound_ms_eval": boxes["eval"]["bound_ms"],
        "ms_train": boxes["train"]["kernel_ms"],
        "bound_ms_train": boxes["train"]["bound_ms"],
        "ms_batched": batched["face_boxes"]["batched"]["kernel_ms"],
        "bound_ms_batched": batched["face_boxes"]["batched"]["bound_ms"],
        "ms_samples": batched["face_boxes"]["samples"]["kernel_ms"],
        "bound_ms_samples": batched["face_boxes"]["samples"]["bound_ms"],
        "launches_by_path": {k: v["face_boxes"] for k, v in path_launches.items()},
    }]
    log(f"[phase 4] predict_ms_per_image {timing['predict_ms']}")
    log(f"[phase 5] readings " + json.dumps(
        {k: v for k, v in batched.items()
         if k not in ("kernels", "face_boxes", "launches")}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
