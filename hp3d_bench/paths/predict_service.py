"""Predict-service traffic (`run_predict_torch.py --no_vis`): closed loop,
one client.

Stacks of `batch` photos (`photo_wh`^2 RGB, drawn from the seed, held as
uint8 in pinned memory as `predict_folder_batched`'s decode thread leaves them)
go to the card on the `--cropped_images` path: no detector, the whole photo
is the box. The window drives the port's `make_hrnet_batch_predictor` and
`make_predict_core(render_vis=False)` as `predict_folder_batched`
dispatches a chunk: lag one, batch N+1 enqueued before batch N's outputs
(pose, shape, camera, per-vertex uncertainty) are fetched behind an event;
its decode and `outputs.npz` write are left out. The sampler draws from one
device generator, as `predict_folder_batched`'s does.

An image's latency runs from its batch's submission (the upload's enqueue)
until its outputs are on the host. Once the window has closed, a sample of
the batches drawn from the seed is run again by the reference from the same
photos and generator states, and every output compared.
"""

import time

import numpy as np
import torch

from hp3d_bench import compare, counts, inputs
from hp3d_bench.paths.train import free_cuda
from hp3d_bench.tracing import profile_calls
from hp3d_bench.window import lag_one, percentile

OUTPUTS_MODE = ("pose_rotmats_mode", "shape_mean", "cam")
OUTPUTS_VAR = ("per_vertex_3Dvar",)


def photos(seed, traffic):
    """`stacks` stacks of `batch` smooth random photos, uint8 (B, H, W, 3),
    pinned where a card is present."""
    n, B, wh = traffic["stacks"], traffic["batch"], traffic["photo_wh"]
    gen = torch.Generator().manual_seed(inputs.substream(seed, inputs.STREAM_DATA))
    small = torch.rand((n * B, 3, 16, 16), generator=gen)
    big = torch.nn.functional.interpolate(small, size=(wh, wh), mode="bilinear",
                                          align_corners=False)
    big = big + 0.1 * torch.rand(big.shape, generator=gen)
    out = (big.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    stacks = [out[i * B:(i + 1) * B].contiguous() for i in range(n)]
    if torch.cuda.is_available():
        stacks = [s.pin_memory() for s in stacks]
    return stacks


def hrnet_model(module_cls, hrnet_cfg):
    return module_cls(num_joints=hrnet_cfg["MODEL"]["NUM_JOINTS"])


def build_port(ctx, weights, hrnet_weights, smpl_arrays):
    """The port's HRNet batch predictor and predict core, as the batched
    predict loop builds them."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.configs import CfgNode
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
        PoseHighResolutionNet)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL, SMPLParams
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
        make_hrnet_batch_predictor)
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        make_predict_core)

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    hrnet_cfg = CfgNode(ctx.config["hrnet_cfg"])
    hrnet = inputs.load_weights(hrnet_model(PoseHighResolutionNet, hrnet_cfg),
                                hrnet_weights).to(device).eval()
    model = inputs.load_weights(build_pose_shape_model(cfg, "jacobi"),
                                weights).to(device).eval()
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpl = SMPL(SMPLParams.from_numpy(smpl_arrays, device))
    core = make_predict_core(
        model, cfg, smpl, edge, None, hrnet_cfg,
        joints2Dvisib_threshold=ctx.traffic["joints2Dvisib_threshold"],
        num_uncertainty_samples=ctx.config["num_uncertainty_samples"],
        render_vis=False)
    hrnet_batch = make_hrnet_batch_predictor(
        hrnet, hrnet_cfg, device, bbox_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR)
    return hrnet_batch, core, cfg


def build_reference(ctx, weights, hrnet_weights, smpl_arrays):
    """The reference's HRNet batch predictor and predict core."""
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.models.canny_edge_detector import CannyEdgeDetector
    from hp3d_bench.reference.models.hrnet import PoseHighResolutionNet
    from hp3d_bench.reference.models.smpl import SMPL, SMPLParams
    from hp3d_bench.reference.predict.predict_hrnet import make_hrnet_batch_predictor
    from hp3d_bench.reference.predict_service import make_predict_core
    from hp3d_bench.paths.train import reference_model

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    hrnet_cfg = CfgNode(ctx.config["hrnet_cfg"])
    hrnet = inputs.load_weights(hrnet_model(PoseHighResolutionNet, hrnet_cfg),
                                hrnet_weights).to(device).eval()
    model = inputs.load_weights(reference_model(cfg), weights).to(device).eval()
    edge = CannyEdgeDetector(
        device, non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD)
    smpl = SMPL(SMPLParams.from_numpy(smpl_arrays, device))
    core = make_predict_core(
        model, cfg, smpl, edge, hrnet_cfg,
        joints2Dvisib_threshold=ctx.traffic["joints2Dvisib_threshold"],
        num_uncertainty_samples=ctx.config["num_uncertainty_samples"])
    hrnet_batch = make_hrnet_batch_predictor(
        hrnet, hrnet_cfg, device, bbox_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR)
    return hrnet_batch, core


def seeded_inputs(ctx):
    """Weights of both models, the SMPL arrays and the predictor's model on
    the meta device (for counting), handed to both sides."""
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.models.hrnet import PoseHighResolutionNet
    from hp3d_bench.paths.train import reference_model
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    meta = reference_model(cfg, "meta")
    with torch.device("meta"):
        meta_hrnet = hrnet_model(PoseHighResolutionNet, ctx.config["hrnet_cfg"])
    weights = inputs.seeded_weights(
        meta, inputs.substream(ctx.seed, inputs.STREAM_WEIGHTS), ctx.device)
    hrnet_weights = inputs.seeded_weights(
        meta_hrnet, inputs.substream(ctx.seed, inputs.STREAM_HRNET), ctx.device)
    return (weights, hrnet_weights, inputs.smpl_arrays(cfg.MODEL.NUM_SMPL_BETAS),
            meta, meta_hrnet)


def run(ctx):
    """One run of a predict-service cell; see the module docstring."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        _Fetch)

    traffic, device, spans = ctx.traffic, ctx.device, ctx.spans
    B = traffic["batch"]
    ctx.mark("imports done")
    weights, hrnet_weights, smpl_arrays, meta, meta_hrnet = seeded_inputs(ctx)
    ctx.mark("weights and SMPL arrays made")
    hrnet_batch, core, cfg = build_port(ctx, weights, hrnet_weights, smpl_arrays)
    ctx.mark("port's HRNet predictor and core built")
    core = ctx.wrap("predict_core", core)
    stacks = photos(ctx.seed, traffic)
    generator = torch.Generator(device=device).manual_seed(
        inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))
    threshold = cfg.DATA.BBOX_THRESHOLD

    def dispatch(k):
        """Enqueue batch k's work; start its outputs home. Returns the
        pending record: (k, generator state, fetch)."""
        state = generator.get_state()
        with spans.span("predict.batch"):
            images = stacks[k % len(stacks)].to(device, non_blocking=True)
            with spans.span("predict.hrnet"):
                hr = hrnet_batch(images, object_detect_fn=None,
                                 object_detect_threshold=threshold)
            with spans.span("predict.core"):
                out = core(hr["cropped_image"], hr["joints2D"],
                           hr["joints2Dconfs"], generator=generator)
        fetch = _Fetch({k_: out[k_] for k_ in OUTPUTS_MODE + OUTPUTS_VAR})
        return k, state, fetch

    done = {}

    def materialize(p):
        k, state, fetch = p
        done[k] = (state, fetch.numpy())

    # Set-up: the cell's one shape, through the window's own calls.
    for k in range(traffic["warmup_batches"]):
        materialize(dispatch(-1 - k))
    done.clear()

    ctx.window_start()
    win = lag_one(dispatch, materialize, ctx.seconds)
    window_s, k = win["window_s"], win["calls"]
    latencies = [s for s in win["latencies_s"] for _ in range(B)]
    n_images = len(done) * B
    ctx.result.e2e["predict_img_per_s"] = n_images / window_s
    ctx.result.e2e["predict_ms_p95"] = 1e3 * percentile(latencies, 95)
    ctx.result.attempted = n_images
    ctx.log(f"window: {len(done)} batches of {B} in {window_s:.3f} s; "
            f"{len(latencies)} image latencies, p50 "
            f"{1e3 * percentile(latencies, 50):.3f} ms, p95 "
            f"{1e3 * percentile(latencies, 95):.3f} ms; batches completed in "
            f"each third: {win['thirds']}")

    if spans.enabled:
        layer = ctx.result.layer
        layer["spans_ms"] = spans.device_ms()
        if device.type == "cuda":
            calls = traffic["profile_batches"]
            state = {"k": k, "pending": None}
            marks = []

            def one_batch():
                t = time.time_ns()
                p = dispatch(state["k"])
                t1 = time.time_ns()
                state["k"] += 1
                if state["pending"] is not None:
                    materialize(state["pending"])
                state["pending"] = p
                marks.extend([("dispatch: upload, HRNet and core enqueue", t, t1),
                              ("fetch the previous batch's outputs", t1,
                               time.time_ns())])

            layer["profile"] = profile_calls(one_batch, calls, marks)
            layer["profile_calls"] = calls
            materialize(state["pending"])
        flops_hrnet = counts.conv_linear_flops(meta_hrnet, (1, 3, *reversed(
            ctx.config["hrnet_cfg"]["MODEL"]["IMAGE_SIZE"])))
        flops_pred = counts.predictor_flops(
            meta, ctx.config["pose_shape_cfg"]["MODEL"]["NUM_IN_CHANNELS"],
            ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"])
        layer["flops_per_call"] = counts.predict_batch_flops(
            flops_hrnet, flops_pred, B, ctx.config["num_uncertainty_samples"])
    ctx.read_memory_peak()

    del hrnet_batch, core
    free_cuda()

    # The reference, on a sample of the window's batches drawn from the seed.
    r_hrnet, r_core = build_reference(ctx, weights, hrnet_weights, smpl_arrays)
    window_batches = sorted(i for i in done if 0 <= i < k)
    rng = np.random.default_rng(inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))
    n_check = min(traffic["check_batches"], len(window_batches))
    sample = sorted(rng.choice(window_batches, n_check, replace=False).tolist())
    r_gen = torch.Generator(device=device)
    mode_gap = var_gap = 0.0
    for i in sample:
        state, out = done[i]
        r_gen.set_state(state)
        images = stacks[i % len(stacks)].to(device)
        hr = r_hrnet(images, object_detect_fn=None, object_detect_threshold=threshold)
        ref = r_core(hr["cropped_image"], hr["joints2D"], hr["joints2Dconfs"],
                     generator=r_gen)
        got = {name: torch.from_numpy(out[name]) for name in out}
        g, where = compare.output_gap({n: got[n] for n in OUTPUTS_MODE},
                                      {n: ref[n].cpu() for n in OUTPUTS_MODE})
        if g >= mode_gap:
            mode_gap, ctx.result.info["mode_gap at"] = g, f"batch {i} {where}"
        g, where = compare.output_gap({n: got[n] for n in OUTPUTS_VAR},
                                      {n: ref[n].cpu() for n in OUTPUTS_VAR})
        if g >= var_gap:
            var_gap, ctx.result.info["var_gap at"] = g, f"batch {i} {where}"
    ctx.result.numbers = {"mode_gap": mode_gap, "var_gap": var_gap}
    ctx.log(f"checked batches {sample} of {len(window_batches)}")
