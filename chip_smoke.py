#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build the CUDA rasterizer from csrc/ and print the card's name and
     power limit;
  2. hold the rasterizer kernel against its plain torch version on the card:
     6 synthetic-SMPL meshes at 512^2, A=12, as the renderer packs them
     (mask and depth bit-equal, attrs within 1e-5), and a hand-made scene of
     shared edges and equal-depth ties (all outputs equal);
  3. drive the main path through the user's entry point,
     `run_predict_torch.py --cropped_images` on 3 demo photos at full width
     (HRNet-W48, ResNet-18, 50 samples, 512^2 renders, random weights), with
     the kernel's launch counter read around it (one launch per image), and
     check its figures and outputs; then check the predict core on the card
     against the same core on the CPU (plain rasterizer) on small inputs from
     3 seeds, with the kernel given the CPU's own tables, and report why
     colours differ where they do;
  4. time the per-image predict, its stages, the kernel, its plain version
     and the kernel's bound (the bytes it must move and the pixel-face tests
     the function needs).

The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(REPO, "demo")
DEMO_PHOTOS = ("00000.png", "00003.png", "00007.png")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per (pixel, face) test: w0, w1, z (2 mul + 2 add each),
# w2 (2 sub), 4 coverage compares, z < best.
OPS_PER_TEST = 19
# Geometry rows of the packed tables that the rasterizer reads (of 16).
GEOM_ROWS_READ = 9
# Seeds of the predict core's card-vs-CPU check, and the least share of the
# pixels covered on both devices whose colours agree to 1e-3. Over seeds
# 0-11 on an H100 80GB HBM3 (700 W) the share was 0.999032-0.999861, 1 to 7
# pixels of about 7,200; 0.998 allows twice the worst of those.
CORE_SEEDS = (3, 4, 5)
CORE_RGB_SHARE = 0.998


def log(msg):
    print(msg, flush=True)


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


def predict_scene(device, img_wh=512, seed=0):
    """The 6 views the predict path renders for one image (posed x4
    rotations + T-pose x2), on synthetic SMPL with a seeded random pose,
    packed by the renderer: A = 12 attributes.

    :return: screen (6, 7829, 3), faces (13774, 3), packed tables
    """
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        pack_face_tables)
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

    betas = tensor(rng.randn(1, 10))
    posed = smpl(betas=betas, body_pose=tensor(rng.randn(1, 69) * 0.2))
    views = six_views(
        aa_rotate_translate_points(posed["vertices"], X_AXIS, np.pi, ZERO_T),
        aa_rotate_translate_points(smpl(betas=betas)["vertices"], X_AXIS,
                                   np.pi, ZERO_T),
        jet_colormap(tensor(rng.rand(1, 6890) * 0.2)),
        tensor([[0.0, -0.1, 2.5]]), tensor([[0.9, 0.9]]))
    renderer = TexturedIUVRenderer(device, img_wh=img_wh)
    screen, vert_attrs = renderer.raster_inputs(
        views["vertices"], views["cam_t"], views["orthographic_scale"],
        views["verts_features"])
    return (screen, renderer.faces,
            pack_face_tables(screen, renderer.faces, vert_attrs))


def triangle_scene(device):
    """Shared edges through pixel centres and exact depth ties: a square split
    on its diagonal into two faces at one depth, the same square again at the
    same depth with other attributes (ties -> lower index), a nearer face over
    part of it, and a face behind znear."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        pack_face_tables)
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
    return pack_face_tables(verts, faces, attrs)


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


def tile_chunk_pairs(chunk_ranges, hw, tile=16):
    """(16x16 tile, 128-face chunk) pairs whose boxes overlap: the pairs the
    kernel's coarse culling leaves it to test (a diagnostic of the design,
    not part of the bound)."""
    H, W = hw
    rows = torch.arange(0, H, tile, device=chunk_ranges.device)
    cols = torch.arange(0, W, tile, device=chunk_ranges.device)
    r = chunk_ranges[:, None, None, :, :].to(torch.int64)
    overlap = ((r[..., 0] < rows[None, :, None, None] + tile)
               & (r[..., 1] >= rows[None, :, None, None])
               & (r[..., 2] < cols[None, None, :, None] + tile)
               & (r[..., 3] >= cols[None, None, :, None]))
    return int(overlap.sum())


def phase_kernel_vs_plain(device):
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda, rasterize_packed_plain)
    hw = (512, 512)
    screen, faces, tables = predict_scene(device)
    ka, kd, km = rasterize_packed_cuda(*tables, hw)
    pa, pd, pm = rasterize_packed_plain(*tables, hw)
    torch.cuda.synchronize()
    mask_diff = int((km != pm).sum())
    depth_equal = bool(torch.equal(kd, pd))
    attr_err = float((ka - pa).abs().max())
    log(f"[phase 2] predict scene {tuple(ka.shape)}: covered pixels "
        f"{int(km.sum())}, mask differs at {mask_diff}, depth bit-equal "
        f"{depth_equal}, attrs max abs diff {attr_err:.3e} (tol 1e-5)")
    if mask_diff or not depth_equal or not attr_err <= 1e-5:
        raise AssertionError("kernel disagrees with its plain version at the "
                             "predict shape")

    tri = triangle_scene(device)
    ta, td, tm = rasterize_packed_cuda(*tri, (64, 64))
    qa, qd, qm = rasterize_packed_plain(*tri, (64, 64))
    torch.cuda.synchronize()
    ok = torch.equal(tm, qm) and torch.equal(td, qd) and torch.equal(ta, qa)
    log(f"[phase 2] triangle scene: covered {int(tm.sum())} px, outputs equal "
        f"{ok}; tie winner attrs at (35, 10) {ta[0, 35, 10].tolist()}")
    if not ok or ta[0, 35, 10].tolist() != [1.0, 0.0, 0.0]:
        raise AssertionError("kernel disagrees on shared edges / depth ties")
    scene = {"screen": screen, "faces": faces, "tables": tables,
             "covered": int(km.sum())}
    return scene, attr_err


def phase_main_path(workdir):
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import main
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda)
    import cv2

    image_dir = os.path.join(workdir, "demo3")
    save_dir = os.path.join(workdir, "out")
    os.makedirs(image_dir)
    for f in DEMO_PHOTOS:
        shutil.copy(os.path.join(DEMO, f), image_dir)
    argv = ["--image_dir", image_dir, "--save_dir", save_dir,
            "--cropped_images", "--device", "cuda"]
    rasterize_packed_cuda.launches = 0
    t0 = time.perf_counter()
    results = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rasterize_packed_cuda.launches
    log(f"[phase 3] run_predict_torch.py on {len(DEMO_PHOTOS)} demo photos: "
        f"{wall:.2f} s cold (model init included); rasterize "
        f"launches {launches}")
    if launches != len(DEMO_PHOTOS):
        raise AssertionError(f"expected one kernel launch per image, got "
                             f"{launches}")
    if sorted(results) != sorted(DEMO_PHOTOS):
        raise AssertionError(f"results for {sorted(results)}")
    for fname, res in results.items():
        for k, shape in (("pose_mode", (23, 3, 3)), ("shape_mean", (10,)),
                         ("cam", (3,)), ("per_vertex_uncertainty", (6890,))):
            if res[k].shape != shape or not np.isfinite(res[k]).all():
                raise AssertionError(f"{fname}/{k}: shape {res[k].shape}, "
                                     f"finite {np.isfinite(res[k]).all()}")
        fig = cv2.imread(os.path.join(save_dir, fname))
        if fig is None or fig.shape != (1024, 2048, 3) or fig.std() < 1.0:
            raise AssertionError(f"{fname}: figure missing or blank")
        rot = np.einsum("jab,jcb->jac", res["pose_mode"], res["pose_mode"])
        log(f"[phase 3] {fname}: figure {fig.shape}, |R R^T - I| "
            f"{np.abs(rot - np.eye(3)).max():.2e}, uncertainty mean "
            f"{res['per_vertex_uncertainty'].mean():.4f}")
    return argv, launches


def core_render_tables(out, smpl, renderer):
    """Screen vertices and packed face tables of the core's 6-view render,
    rebuilt from its outputs as make_predict_core builds them."""
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        pack_face_tables)
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
    screen, vert_attrs = renderer.raster_inputs(
        views["vertices"], views["cam_t"], views["orthographic_scale"],
        views["verts_features"])
    return screen, pack_face_tables(screen, renderer.faces, vert_attrs)


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
                screen, tables[dev] = core_render_tables(out, smpl, renderer)
            out["screen"] = screen
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
        pa, pd, pm = rasterize_packed_plain(*tables["cpu"], hw)
        ka, kd, km = rasterize_packed_cuda(
            *[x.to("cuda") for x in tables["cpu"]], hw)
        same_tables_ok = (torch.equal(km.cpu(), pm) and torch.equal(kd.cpu(), pd)
                          and float((ka.cpu() - pa).abs().max()) <= 1e-5)
        rebuilt_ok = torch.equal(pm, mask_b)
        why = explain_rgb_differences(
            both & (rgb_err > 1e-3),
            {"tables": tables["cuda"],
             "attrs": rasterize_packed_cuda(*tables["cuda"], hw)[0].cpu()},
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


def profile_core(fn):
    """One predict-core call under torch.profiler: device time, busy share
    of the host-clock wall time, kernel launches, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[phase 4] profile of one predict core (profiler on): wall "
        f"{wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({device_ms / wall_ms:.1%}), {launches} kernel launches")
    for e in top:
        log(f"[phase 4]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "launches": launches}


def phase_timing(argv, scene):
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_parser, build_predictor)
    from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import (
        rasterize_packed_cuda, rasterize_packed_plain)
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

    hw = (512, 512)
    tables = scene["tables"]
    geom_t, face_attrs, chunk_ranges = tables
    kernel_ms = median_ms(lambda: rasterize_packed_cuda(*tables, hw), inner=20)
    plain_ms = median_ms(lambda: rasterize_packed_plain(*tables, hw))
    # The bound: each input read once (the 9 geometry rows the function
    # uses), each output written once; and the pixel-face tests the function
    # needs (each face against the pixel centres in its bounding box) plus
    # the interpolation of A attributes at each covered pixel.
    B, _, Fp = geom_t.shape
    A = face_attrs.shape[-1] // 3
    bytes_moved = (4 * B * GEOM_ROWS_READ * Fp + 4 * face_attrs.numel()
                   + 4 * chunk_ranges.numel() + B * hw[0] * hw[1] * (4 * A + 4 + 1))
    tests = pixel_face_tests(scene["screen"], scene["faces"], hw)
    ops = tests * OPS_PER_TEST + scene["covered"] * 5 * A
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    pairs = tile_chunk_pairs(chunk_ranges, hw)
    log(f"[phase 4] per-image predict: median {predict_ms:.2f} ms/image "
        f"(runs {[round(t, 2) for t in per_image]}); stages of one image: "
        f"HRNet keypoints {hrnet_ms:.2f} ms, predict core {core_ms:.2f} ms, "
        f"the rest (decode, figure, PNG write) ~"
        f"{predict_ms - hrnet_ms - core_ms:.2f} ms")
    log(f"[phase 4] rasterize 6x512^2 A=12: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms (bytes {bytes_moved} -> "
        f"{bytes_ms:.4f} ms; {tests} pixel-face tests x {OPS_PER_TEST} ops + "
        f"{scene['covered']} covered px x {5 * A} ops -> {ops_ms:.4f} ms); "
        f"kernel at {kernel_ms / bound_ms:.1f}x its bound")
    log(f"[phase 4] rasterize design: {pairs} overlapping (16x16 tile, "
        f"128-face chunk) pairs, i.e. {pairs * 256 * 128} pixel-face tests "
        f"made, {pairs * 256 * 128 / tests:.1f}x the {tests} needed")
    return {"predict_ms": predict_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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

    scene, attr_err = phase_kernel_vs_plain(device)
    with tempfile.TemporaryDirectory() as workdir:
        argv, launches = phase_main_path(workdir)
        phase_core_cuda_vs_cpu()
        timing = phase_timing(argv, scene)

    kernels = [{
        "name": "rasterize",
        "route": "cuda",
        "source": "hierarchicalprobabilistic3dhuman_torch/csrc/rasterize.cu",
        "replaces": "hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:240",
        "launches": launches,
        "max_abs_err": attr_err,
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    log(f"[phase 4] predict_ms_per_image {timing['predict_ms']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
