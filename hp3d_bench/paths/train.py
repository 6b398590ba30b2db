"""Training traffic: closed loop, one trainer.

The window drives the port's `TrainStep.__call__` (train split, the cell's
loss stage) as `train_pose_mf_shape_gaussian_net` does a step: the next
batch from the port's `NativeTrainLoader` over packed stores (written by
the benchmark from the seed under TMPDIR), uploaded by `batch_to_device`,
the step enqueued, then the previous step's loss and metric sums read into
the port's tracker (lag one). No validation and no checkpoint in the window.

Set-up builds the step once, with its model and Adam, and drives it
through its first `check_steps` steps with the window's own call and feed;
those steps are the warm-up, and what they produce (each step's loss, the
first gradient as Adam holds it, the parameters' change) is what the
reference is held to once the window has closed. The reference trains on
the benchmark's own draw of those batches (`stores.StoreDraws`), and each
batch the loader handed the port is held against it (`loader_gap`).
"""

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from hp3d_bench import compare, counts, inputs, stores
from hp3d_bench.tracing import profile_calls
from hp3d_bench.window import lag_one

METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
           'joints2D-L2E']
NUM_TEXELS = 7829          # DensePose vertices: a per-vertex texel record
TEXEL_SMOOTH = 8           # background noise upsampled from 8 x 8
# The stores NativeTrainLoader reads, in its order, and its batches' keys.
STORE_FILES = ("poses.bin", "textures.bin", "backgrounds.bin")
LOADER_KEYS = ("pose", "texture", "background")


def write_stores(root, seed, traffic, img_wh):
    """Poses, per-vertex texels and backgrounds as the loader's stores,
    drawn from the seed; returns the arrays in the loader's store order."""
    rng = np.random.default_rng(inputs.substream(seed, inputs.STREAM_DATA))
    os.makedirs(root)
    poses = (rng.standard_normal((traffic["poses"], 72), np.float32)
             * traffic["pose_std"])
    texels = rng.integers(0, 256, (traffic["textures"], NUM_TEXELS, 3), np.uint8)
    small = torch.from_numpy(rng.random(
        (traffic["backgrounds"], 3, TEXEL_SMOOTH, TEXEL_SMOOTH), np.float32))
    big = torch.nn.functional.interpolate(small, size=(img_wh, img_wh),
                                          mode="bilinear", align_corners=False)
    backgrounds = (big * 255).round().to(torch.uint8).numpy()
    arrays = (poses, texels, backgrounds)
    for name, a in zip(STORE_FILES, arrays):
        stores.write_store(os.path.join(root, name), a)
    return arrays


def store_draws(ctx, arrays):
    """The benchmark's own draw of the loader's batches (stores.StoreDraws)."""
    return stores.StoreDraws(arrays, LOADER_KEYS, ctx.traffic["batch"],
                             inputs.substream(ctx.seed, inputs.STREAM_DATA),
                             ctx.traffic["loader_threads"])


class RenderRecorder:
    """The training renderer, keeping its last call's inputs and silhouettes
    (for K1's bound at the step's own tables)."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.faces = renderer.faces
        self.last = None

    def __call__(self, vertices, cam_t=None, textures=None, **kwargs):
        out = self.renderer(vertices, cam_t=cam_t, textures=textures, **kwargs)
        self.last = (vertices, cam_t, textures, out["silhouettes"])
        return out


def stage_cfg(cfg, stage):
    return cfg.LOSS.STAGE1 if stage == 1 else cfg.LOSS.STAGE2


def build_port(ctx, weights, smpl_arrays):
    """The port's train step, model and Adam as the train CLI builds them."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.configs import CfgNode
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL, SMPLParams
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        TrainStep)

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    model = build_pose_shape_model(cfg, "jacobi")
    inputs.load_weights(model, weights)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    renderer = RenderRecorder(TexturedIUVRenderer(
        device, img_wh=cfg.DATA.PROXY_REP_SIZE, render_rgb=True,
        projection_type="perspective",
        perspective_focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH))
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpl = SMPL(SMPLParams.from_numpy(smpl_arrays, device))
    stage = ctx.traffic["stage"]
    metrics = METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])
    step = TrainStep(model, cfg, smpl, renderer, edge, stage_cfg(cfg, stage),
                     optimizer, train=True, metrics_to_track=metrics)
    return step, model, optimizer, renderer, metrics


def build_reference(ctx, weights, smpl_arrays):
    """The reference's train step, model and Adam, built alike."""
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.models.canny_edge_detector import CannyEdgeDetector
    from hp3d_bench.reference.models.smpl import SMPL, SMPLParams
    from hp3d_bench.reference.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    from hp3d_bench.reference.train_step import TrainStep

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    model = inputs.load_weights(reference_model(cfg), weights).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    renderer = TexturedIUVRenderer(
        device, img_wh=cfg.DATA.PROXY_REP_SIZE, render_rgb=True,
        projection_type="perspective",
        perspective_focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH)
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpl = SMPL(SMPLParams.from_numpy(smpl_arrays, device))
    step = TrainStep(model, cfg, smpl, renderer, edge,
                     stage_cfg(cfg, ctx.traffic["stage"]), optimizer)
    return step, model, optimizer, renderer


def reference_model(cfg, device=None, svd_impl="jacobi"):
    """The reference's predictor of the config, built on `device`."""
    from hp3d_bench.reference.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    m = cfg.MODEL
    with torch.device(device or "cpu"):
        return PoseMFShapeGaussianNet(
            num_in_channels=m.NUM_IN_CHANNELS, num_resnet_layers=m.NUM_RESNET_LAYERS,
            embed_dim=m.EMBED_DIM, delta_i=m.DELTA_I,
            delta_i_weight=m.DELTA_I_WEIGHT, num_smpl_betas=m.NUM_SMPL_BETAS,
            svd_impl=svd_impl)


def seeded_inputs(ctx):
    """The weights and SMPL arrays a run hands to both sides."""
    from hp3d_bench.reference.configs import CfgNode
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    meta = reference_model(cfg, "meta")
    weights = inputs.seeded_weights(
        meta, inputs.substream(ctx.seed, inputs.STREAM_WEIGHTS), ctx.device)
    return weights, inputs.smpl_arrays(cfg.MODEL.NUM_SMPL_BETAS), meta


def upload(batch, device):
    """A loader batch on the device, as the port's batch_to_device sends it."""
    out = []
    for key in ("pose", "background", "texture"):
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        out.append(t.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" else t.to(device))
    return out


def first_steps(call, model, optimizer, n):
    """Drive `call` (one step, returning the loss) n times; what the
    comparison reads: each step's loss, the first gradient per leaf as Adam
    holds it after step 1 (exp_avg / (1 - beta1)), and each leaf's change
    after the n steps."""
    names = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in names.items()}
    losses, grad_norms = [], None
    for i in range(n):
        losses.append(float(call()))
        if i == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            # A leaf the optimizer holds no state for got no gradient.
            grad_norms = compare.param_norms(
                {k: optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                 for k, p in names.items()})
    change = compare.param_norms({k: p.detach() for k, p in names.items()}, before)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def endless(loader):
    while True:
        yield from loader


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(ctx):
    """One run of a training cell; see the module docstring."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeTrainLoader)
    from hierarchicalprobabilistic3dhuman_torch.metrics import (
        TrainingLossesAndMetricsTracker)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        batch_to_device)

    traffic, device, spans = ctx.traffic, ctx.device, ctx.spans
    B = traffic["batch"]
    ctx.mark("imports done")
    weights, smpl_arrays, meta_model = seeded_inputs(ctx)
    ctx.mark("weights and SMPL arrays made")
    step, model, optimizer, renderer, metrics = build_port(ctx, weights, smpl_arrays)
    ctx.mark("port's train step built")
    D = ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"]
    if B != ctx.config["pose_shape_cfg"]["TRAIN"]["BATCH_SIZE"]:
        raise ValueError("the cell's batch must be the config's TRAIN.BATCH_SIZE")
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_train_")
    loader = None
    try:
        own = store_draws(ctx, write_stores(os.path.join(workdir, "stores"),
                                            ctx.seed, traffic, D))
        loader = NativeTrainLoader(
            os.path.join(workdir, "stores"), B, n_threads=traffic["loader_threads"],
            seed=inputs.substream(ctx.seed, inputs.STREAM_DATA))
        batches = ctx.wrap("train_batches", endless(loader))
        ctx.mark("stores written, loader started")
        draws = inputs.Draws(inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device)
        tracker = TrainingLossesAndMetricsTracker(
            metrics_to_track=list(metrics), img_wh=D, log_save_path=os.devnull,
            load_logs=False, current_epoch=0, save_logs=False)
        tracker.initialise_loss_metric_sums()

        call = ctx.wrap("train_step", step)

        def resolve(handle):
            loss, sums = handle
            tracker.update_per_batch_sums(
                split="train", loss=float(loss), batch_size=B,
                metric_sums={k: float(v) for k, v in sums.items()})
            return loss

        # Set-up: the first steps, through the window's own call and feed.
        # The reference gets the benchmark's own draw of each batch; a batch
        # the loader handed out that differs from it is a miss.
        fed, misses = [], [0]
        draws.recording = True

        def setup_step():
            batch = next(batches)
            mine, same = own.match(batch)
            fed.append(mine)
            misses[0] += not same
            loss, sums, _ = call(draws, *batch_to_device(batch, device))
            return resolve((loss, sums))

        got = first_steps(setup_step, model, optimizer, traffic["check_steps"])
        draws.recording = False
        record = draws.record
        draws.record = []
        if spans.enabled:
            step.synth = span_wrapped(spans, "train.synth", step.synth)

        def dispatch(_k=None):
            t = time.time_ns()
            batch = next(batches)
            inputs_dev = batch_to_device(batch, device)
            t1 = time.time_ns()
            spans.host("data.wait", (t1 - t) / 1e9)
            with spans.span("train.step"):
                loss, sums, _ = call(draws, *inputs_dev)
            return loss, sums, (t, t1, time.time_ns())

        ctx.window_start()
        win = lag_one(dispatch, lambda h: resolve(h[:2]), ctx.seconds)
        if device.type == "cuda":
            torch.cuda.synchronize()
        steps, window_s = win["calls"], win["window_s"]
        ctx.result.e2e["train_img_per_s"] = steps * B / window_s
        ctx.result.attempted = steps
        ctx.log(f"window: {steps} steps of {B} in {window_s:.3f} s; "
                f"steps completed in each third: {win['thirds']}; ms between "
                f"completions {win['intervals_ms']}")

        if spans.enabled:
            layer = ctx.result.layer
            layer["spans_ms"] = spans.device_ms()
            layer["host_s"] = dict(spans.host_s)
            if device.type == "cuda":
                marks, pending = [], [None]

                def profiled_step():
                    handle = dispatch()
                    t2 = time.time_ns()
                    if pending[0] is not None:
                        resolve(pending[0][:2])
                    pending[0] = handle
                    t, t1, t_enq = handle[2]
                    marks.extend([("loader next batch and upload", t, t1),
                                  ("train step enqueue", t1, t_enq),
                                  ("read the previous step's loss and sums", t2,
                                   time.time_ns())])

                prof = profile_calls(profiled_step, traffic["profile_steps"], marks)
                resolve(pending[0][:2])
                layer["profile"] = prof
                layer["profile_calls"] = traffic["profile_steps"]
            layer["flops_per_call"] = counts.train_step_flops(
                counts.predictor_flops(meta_model,
                                       ctx.config["pose_shape_cfg"]["MODEL"]["NUM_IN_CHANNELS"],
                                       D),
                B, ctx.config["pose_shape_cfg"]["LOSS"]["NUM_SAMPLES"])
            layer["k1"] = k1_bound(
                renderer, D,
                ctx.config["pose_shape_cfg"]["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"])
            layer["k1_calls_per_step"] = 1
        ctx.read_memory_peak()
    finally:
        if loader is not None:
            loader.close()
        shutil.rmtree(workdir, ignore_errors=True)

    del step, model, optimizer, renderer, tracker, call
    free_cuda()

    # The reference, on the same weights, batches and draws.
    r_step, r_model, r_optimizer, _ = build_reference(ctx, weights, smpl_arrays)
    replay = inputs.Replay(record, inputs.Draws(
        inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device))
    fed_iter = iter(fed)
    ref = first_steps(lambda: r_step(replay, *upload(next(fed_iter), device)),
                      r_model, r_optimizer, traffic["check_steps"])
    numbers = compare.train_numbers(got, ref)
    numbers["loader_gap"] = misses[0] / len(fed)
    ctx.result.info = numbers.pop("_info")
    ctx.result.numbers = numbers
    ctx.log(f"losses: port {got['losses']} reference {ref['losses']}; "
            f"{replay.mismatches} draws the port made otherwise")


def span_wrapped(spans, name, fn):
    def wrapped(*args, **kwargs):
        with spans.span(name):
            return fn(*args, **kwargs)
    return wrapped


@torch.no_grad()
def k1_bound(recorder, img_wh, focal_length):
    """K1's bound at the last step's own tables: the meshes' screen
    vertices and attributes from the reference renderer's `raster_inputs`
    on the recorded inputs, the tests from counts.pixel_face_tests, the
    covered pixels from the step's silhouettes."""
    if recorder.last is None:
        return None
    from hp3d_bench.reference.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    vertices, cam_t, textures, silhouettes = recorder.last
    ref = TexturedIUVRenderer(vertices.device, img_wh=img_wh, render_rgb=True,
                              projection_type="perspective",
                              perspective_focal_length=focal_length)
    screen, attrs = ref.raster_inputs(vertices, cam_t, textures=textures)
    tests = counts.pixel_face_tests(screen, ref.faces, (img_wh, img_wh))
    bound = counts.raster_bound_s(vertices.shape[0], ref.faces.shape[0],
                                  attrs.shape[-1], (img_wh, img_wh), tests,
                                  int(silhouettes.sum()))
    return bound
