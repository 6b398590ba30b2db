"""Evaluation traffic (`run_evaluate_torch.py --dataset ssp3d`): one
researcher's pass over SSP-3D, frames cycled.

Set-up writes, from the seed and under TMPDIR, a folder in SSP-3D's layout
(`frames` frames of `frame_wh`^2: images, silhouettes, labels.npz with
shapes, poses, 2D joints, boxes and genders alternating m/f) and a
checkpoint of the predictor's weights in the reference's torch format, so
that `resolve_svd_impl("auto", path)` gives `lapack`, as it does for users
of the published weights. The port's `SSP3DEvalDataset` reads the folder
through its threaded `DataLoader`, gender-sorted, `batch` frames a batch;
the window drives `make_eval_step`'s step a batch (`num_samples` samples,
per-frame metrics on the device) and the tracker's update, as
`evaluate_pose_mf_shape_gaussian_net` does a batch.

Once the window has closed, a sample of its batches drawn from the seed is
run again by the reference (its own copy of the dataset code reading the
same files, the same weights, and the same draws, which the benchmark makes
with the reference's `sample_draws`), and the per-frame metrics and the
predictions compared.
"""

import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hp3d_bench import compare, counts, inputs
from hp3d_bench.paths.train import free_cuda, reference_model
from hp3d_bench.tracing import profile_calls
from hp3d_bench.window import thirds

SSP3D_METRICS = ['PVE-PA', 'PVE-T-SC', 'silhouette-IOU', 'joints2D-L2E',
                 'joints2Dsamples-L2E', 'silhouettesamples-IOU']
VISIBLE_JOINTS_THRESHOLD = 0.6
# Threads that write the SSP-3D folder's PNGs in set-up.
WRITERS = 4
PRED_KEYS = ("pred_glob_rotmats", "pred_pose_rotmats_mode", "pred_shape_mean",
             "pred_cam")


def write_ssp3d_folder(root, seed, n, wh):
    """A folder in SSP-3D's layout: images/ (smooth random photos),
    silhouettes/ (an ellipse about each image's centre), labels.npz (fnames,
    shapes, poses, joints2D with confidences, bbox_centres, bbox_whs,
    genders alternating m/f), all from the seed."""
    import cv2
    rng = np.random.default_rng(inputs.substream(seed, inputs.STREAM_DATA))
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "silhouettes"))
    small = torch.from_numpy(rng.random((n, 3, 16, 16), np.float32))
    big = torch.nn.functional.interpolate(small, size=(wh, wh), mode="bilinear",
                                          align_corners=False)
    images = (big * 255).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()
    sil = np.zeros((wh, wh), np.uint8)
    cv2.ellipse(sil, (wh // 2, wh // 2), (wh // 6, wh // 3), 0, 0, 360, 255, -1)
    fnames = [f"frame_{i:03d}.png" for i in range(n)]
    png = [cv2.IMWRITE_PNG_COMPRESSION, 1]
    sil_path = os.path.join(root, "silhouette.png")
    cv2.imwrite(sil_path, sil, png)

    def write(i):
        cv2.imwrite(os.path.join(root, "images", fnames[i]),
                    np.ascontiguousarray(images[i][..., ::-1]), png)
        os.link(sil_path, os.path.join(root, "silhouettes", fnames[i]))

    # cv2 encodes without the interpreter lock: a few threads write at once.
    with ThreadPoolExecutor(WRITERS) as pool:
        list(pool.map(write, range(n)))
    centres = wh / 2.0 + rng.uniform(-0.05, 0.05, (n, 2)) * wh
    joints = np.concatenate([rng.uniform(0.3, 0.7, (n, 17, 2)) * wh,
                             rng.random((n, 17, 1))], axis=2)
    np.savez(os.path.join(root, "labels.npz"),
             fnames=np.array(fnames),
             shapes=rng.standard_normal((n, 10)).astype(np.float32),
             poses=(rng.standard_normal((n, 72)) * 0.2).astype(np.float32),
             joints2D=joints.astype(np.float32),
             bbox_centres=centres.astype(np.float32),
             bbox_whs=np.full(n, 0.8 * wh, np.float32),
             genders=np.array(["m", "f"] * (n // 2) + ["m"] * (n % 2)))
    return root


def write_checkpoint(path, cfg, weights):
    """The predictor's weights as the reference's training saves them (its
    full state dict beside numpy scalars): a torch-format checkpoint."""
    model = inputs.load_weights(reference_model(cfg), weights)
    torch.save({"best_model_state_dict": {k: v.cpu() for k, v in
                                          model.state_dict().items()},
                "epoch": np.int64(0),
                "best_epoch_val_metrics": {"PVE-PA": np.float64(0.0)}}, path)
    return path


def sorted_order(genders, batch):
    """The evaluation loop's gender-sorted pass: the dataset truncated to a batch
    multiple in dataset order, then sorted stably by gender code."""
    codes = np.array([{"m": 1, "f": 2}.get(str(g), 0) for g in genders], np.int32)
    n_keep = len(codes) // batch * batch
    return np.argsort(codes[:n_keep], kind="stable")


class SilhouetteRecorder:
    """The silhouette renderer, keeping each call's inputs and silhouettes
    (for K1's bound at the step's own tables)."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.faces = renderer.faces
        self.img_wh = renderer.img_wh
        self.calls = []

    def __call__(self, vertices, cam_t=None, orthographic_scale=None, **kwargs):
        out = self.renderer(vertices, cam_t=cam_t,
                            orthographic_scale=orthographic_scale, **kwargs)
        self.calls = (self.calls + [(vertices, cam_t, orthographic_scale,
                                     out["silhouettes"])])[-2:]
        return out


def build_port(ctx, root, ckpt, smpl_arrays, recorder_box):
    """The port's dataset, loader pieces, steps and tracker, as the eval CLI
    builds them for SSP-3D."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model, load_or_init, resolve_svd_impl)
    from hierarchicalprobabilistic3dhuman_torch.configs import CfgNode
    from hierarchicalprobabilistic3dhuman_torch.data.ssp3d_eval_dataset import (
        SSP3DEvalDataset)
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        make_eval_step)
    from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
        make_eval_frame_metrics_fn)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL, SMPLParams
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        load_predictor_state_dict)
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    svd_impl = resolve_svd_impl("auto", ckpt)
    if svd_impl != ctx.traffic["svd_impl"]:
        raise RuntimeError(f"--svd_impl auto gave {svd_impl} for the checkpoint")
    model = load_or_init(build_pose_shape_model(cfg, svd_impl), ckpt,
                         load_predictor_state_dict,
                         torch.Generator().manual_seed(0),
                         "pose_shape_weights").to(device).eval()
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpls = [SMPL(SMPLParams.from_numpy(smpl_arrays, device)) for _ in range(3)]
    renderer = SilhouetteRecorder(TexturedIUVRenderer(
        device, img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="orthographic",
        render_rgb=False))
    recorder_box.append(renderer)
    frame_metrics_fn = make_eval_frame_metrics_fn(
        SSP3D_METRICS, num_samples=ctx.traffic["num_samples"])
    steps = {g: ctx.wrap("eval_step", make_eval_step(
        model, *smpls, edge, cfg, ctx.traffic["num_samples"], True, True, True,
        renderer, static_gender=g, frame_metrics_fn=frame_metrics_fn))
        for g in (1, 2)}
    dataset = SSP3DEvalDataset(root, cfg,
                               visible_joints_threshold=VISIBLE_JOINTS_THRESHOLD)
    return model, steps, dataset, cfg


def build_reference(ctx, root, weights, smpl_arrays):
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.data.ssp3d_eval_dataset import SSP3DEvalDataset
    from hp3d_bench.reference.evaluate_step import make_eval_step
    from hp3d_bench.reference.metrics.metric_sums import make_eval_frame_metrics_fn
    from hp3d_bench.reference.models.canny_edge_detector import CannyEdgeDetector
    from hp3d_bench.reference.models.smpl import SMPL, SMPLParams
    from hp3d_bench.reference.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    model = inputs.load_weights(reference_model(cfg, svd_impl=ctx.traffic["svd_impl"]),
                                weights).to(device).eval()
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpls = [SMPL(SMPLParams.from_numpy(smpl_arrays, device)) for _ in range(3)]
    renderer = TexturedIUVRenderer(device, img_wh=cfg.DATA.PROXY_REP_SIZE,
                                   projection_type="orthographic", render_rgb=False)
    frame_metrics_fn = make_eval_frame_metrics_fn(
        SSP3D_METRICS, num_samples=ctx.traffic["num_samples"])
    steps = {g: make_eval_step(model, *smpls, edge, cfg, ctx.traffic["num_samples"],
                               True, True, True, renderer, static_gender=g,
                               frame_metrics_fn=frame_metrics_fn)
             for g in (1, 2)}
    dataset = SSP3DEvalDataset(root, cfg,
                               visible_joints_threshold=VISIBLE_JOINTS_THRESHOLD)
    return steps, dataset


def host(tree):
    """Tensors (in nested dicts) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def flatten(out):
    """{name: array} of a step's host outputs: each per-frame metric and
    the predictions."""
    flat = {f"frame_metrics.{k}": np.asarray(v, np.float64)
            for k, v in out["frame_metrics"].items()}
    flat.update({k: np.asarray(out[k], np.float64) for k in PRED_KEYS})
    return flat


def run(ctx):
    """One run of an evaluation cell; see the module docstring."""
    from hierarchicalprobabilistic3dhuman_torch.data.loader import DataLoader
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        _ReorderedDataset, _to_host, gender_codes)
    from hierarchicalprobabilistic3dhuman_torch.metrics import EvalMetricsTracker
    from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import svd3x3_gesdd
    from hp3d_bench.reference.evaluate_step import sample_draws

    traffic, device, spans = ctx.traffic, ctx.device, ctx.spans
    B, N = traffic["batch"], traffic["num_samples"]
    from hp3d_bench.reference.configs import CfgNode as RefCfg
    ref_cfg = RefCfg(ctx.config["pose_shape_cfg"])
    D = ref_cfg.DATA.PROXY_REP_SIZE
    weights = inputs.seeded_weights(
        reference_model(ref_cfg, "meta"),
        inputs.substream(ctx.seed, inputs.STREAM_WEIGHTS), device)
    smpl_arrays = inputs.smpl_arrays(ref_cfg.MODEL.NUM_SMPL_BETAS)
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_eval_")
    try:
        root = write_ssp3d_folder(os.path.join(workdir, "ssp3d"), ctx.seed,
                                  traffic["frames"], traffic["frame_wh"])
        ckpt = write_checkpoint(os.path.join(workdir, "model.tar"), ref_cfg, weights)
        ctx.mark("SSP-3D folder and checkpoint written")
        recorders = []
        model, steps, dataset, cfg = build_port(ctx, root, ckpt, smpl_arrays,
                                                recorders)
        ctx.mark("port's eval steps built")
        order = sorted_order(dataset.genders, B)
        tracker = EvalMetricsTracker(SSP3D_METRICS, img_wh=D, save_path=None,
                                     save_per_frame_metrics=False)
        tracker.initialise_metric_sums()
        tracker.initialise_per_frame_metric_lists()
        generator = torch.Generator(device=device).manual_seed(
            inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def loader(positions):
            return DataLoader(_ReorderedDataset(dataset, positions), batch_size=B,
                              shuffle=False, drop_last=True,
                              num_workers=traffic["loader_workers"])

        def eval_batch(batch):
            """One batch as the evaluation loop runs it; returns (gender, draws,
            host outputs)."""
            code = gender_codes(batch["gender"])
            uniq = np.unique(code)
            if len(uniq) != 1:
                raise RuntimeError("a mixed-gender batch in the sorted pass")
            draws = sample_draws(generator, B, N, cfg.MODEL.NUM_SMPL_BETAS, device)
            before = svd3x3_gesdd.iterations
            with spans.span("eval.step"):
                out = steps[int(uniq[0])](
                    draws, tensor(batch["image"]), tensor(batch["heatmaps"]),
                    tensor(batch["pose"]), tensor(batch["shape"]),
                    torch.as_tensor(code, device=device),
                    tensor(batch["keypoints"]), tensor(batch["silhouette"]))
                out = _to_host(out)
            spans.count("eval.qr_iterations", svd3x3_gesdd.iterations - before)
            tracker.update_per_batch_device(out["frame_metrics"], B)
            return int(uniq[0]), draws, out

        # Set-up: one batch of each gender through the window's own calls.
        per_gender = len(order) // 2
        for batch in loader(np.concatenate([order[:B],
                                            order[per_gender:per_gender + B]])):
            eval_batch(batch)

        def cycle():
            while True:
                yield from loader(order)

        batches = cycle()
        done, done_at = [], []
        ctx.window_start()
        t0 = time.perf_counter()
        while True:
            done.append(eval_batch(next(batches)))
            done_at.append(time.perf_counter() - t0)
            if done_at[-1] >= ctx.seconds:
                break
        window_s = done_at[-1]
        ctx.result.e2e["eval_frames_per_s"] = len(done) * B / window_s
        ctx.result.attempted = len(done) * B
        ctx.log(f"window: {len(done)} batches of {B} in {window_s:.3f} s; "
                f"batches completed in each third: {thirds(done_at, window_s)}")

        if spans.enabled:
            layer = ctx.result.layer
            layer["spans_ms"] = spans.device_ms()
            layer["counters"] = dict(spans.counters)
            if device.type == "cuda":
                calls = traffic["profile_batches"]
                marks = []

                def profiled():
                    t = time.time_ns()
                    batch = next(batches)
                    t1 = time.time_ns()
                    eval_batch(batch)
                    marks.extend([("loader next batch", t, t1),
                                  ("eval step: enqueue, LAPACK-sign head's syncs, "
                                   "fetch", t1, time.time_ns())])

                layer["profile"] = profile_calls(profiled, calls, marks)
                layer["profile_calls"] = calls
            layer["k1"] = k1_bound(recorders[0], D)
            layer["k1_calls_per_step"] = 1
            pred = counts.predictor_flops(reference_model(ref_cfg, "meta"),
                                          ref_cfg.MODEL.NUM_IN_CHANNELS, D)
            layer["flops_per_call"] = counts.eval_batch_flops(pred, B, N)
        ctx.read_memory_peak()
        del model, steps, recorders
        free_cuda()

        # The reference, on a sample of the window's batches.
        r_steps, r_dataset = build_reference(ctx, root, weights, smpl_arrays)
        rng = np.random.default_rng(inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))
        n_check = min(traffic["check_batches"], len(done))
        sample = sorted(rng.choice(len(done), n_check, replace=False).tolist())
        batches_per_pass = len(order) // B
        frame_gap = pred_gap = 0.0
        for i in sample:
            gender, draws, out = done[i]
            pos = i % batches_per_pass
            items = [r_dataset[int(j)] for j in order[pos * B:(pos + 1) * B]]
            batch = {k: np.stack([it[k] for it in items]) for k in
                     ("image", "heatmaps", "pose", "shape", "keypoints", "silhouette")}
            ref = r_steps[gender](
                draws, tensor(batch["image"]), tensor(batch["heatmaps"]),
                tensor(batch["pose"]), tensor(batch["shape"]),
                torch.full((B,), gender, dtype=torch.int32, device=device),
                tensor(batch["keypoints"]), tensor(batch["silhouette"]))
            got_f = flatten(out)
            ref_f = flatten(host(ref))
            frames = [k for k in ref_f if k.startswith("frame")]
            g, where = compare.output_gap({k: torch.from_numpy(got_f[k]) for k in frames},
                                          {k: torch.from_numpy(ref_f[k]) for k in frames})
            if g >= frame_gap:
                frame_gap, ctx.result.info["frame_gap at"] = g, f"batch {i} {where}"
            g, where = compare.output_gap(
                {k: torch.from_numpy(got_f[k]) for k in PRED_KEYS},
                {k: torch.from_numpy(ref_f[k]) for k in PRED_KEYS})
            if g >= pred_gap:
                pred_gap, ctx.result.info["pred_gap at"] = g, f"batch {i} {where}"
        ctx.result.numbers = {"frame_gap": frame_gap, "pred_gap": pred_gap}
        ctx.log(f"checked batches {sample} of {len(done)}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


@torch.no_grad()
def k1_bound(recorder, img_wh):
    """K1's bound for a step's two silhouette renders (the mode meshes, then
    the samples'), summed: screen vertices from the reference renderer's
    `raster_inputs` on the recorded inputs, covered pixels from the
    silhouettes."""
    if len(recorder.calls) < 2:
        return None
    from hp3d_bench.reference.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    total = {"s": 0.0, "bytes": 0, "ops": 0}
    for vertices, cam_t, scale, silhouettes in recorder.calls:
        ref = TexturedIUVRenderer(vertices.device, img_wh=img_wh,
                                  projection_type="orthographic", render_rgb=False)
        screen, attrs = ref.raster_inputs(vertices, cam_t, scale)
        tests = counts.pixel_face_tests(screen, ref.faces, (img_wh, img_wh))
        b = counts.raster_bound_s(vertices.shape[0], ref.faces.shape[0],
                                  attrs.shape[-1], (img_wh, img_wh), tests,
                                  int(silhouettes.sum()))
        for k in total:
            total[k] += b[k]
    return total
