"""Training traffic with the ViT-H/16 predictor (configs/hp3d-vith.json):
closed loop, one trainer, as paths/train.py runs the ResNet predictors.

The window drives the port's `TrainStep.__call__` built by the port's own
`build_pose_shape_model` from the config's MODEL.ENCODER, fed by the port's
`NativeTrainLoader`, lag one, as paths/train.py; its helpers are used by
import. What differs:

  * the reference is the ViT predictor of
    reference/models/pose_mf_shape_gaussian_net_vit.py, built from the
    config's `vit` keys; its weights are inputs.py's draw of the conv and
    linear layers plus the new leaves (LayerNorms the identity, pos_embed
    N(0, 0.02^2) from a stream of its own);
  * set-up fails before any window when the port's predictor is not the
    config's: its parameter count against the config's
    `predictor_parameters` (a port without the ViT builds a ResNet there);
  * the port's predictor is built on the device (638M parameters), and it
    and its Adam are freed before the reference runs its steps;
  * the drop path draws from the step's draw source inside the encoder's
    forward; the reference gets the same draws (its encoder's `draws`);
  * a traced run also times the encoder on the device: CUDA events at its
    forward's start and end, at the start of its backward (the gradient of
    its output) and at its last parameter's gradient, each window step
    (`train.encoder`), and counts its FLOPs (counts_vit.py).

`run` is paths/train.py's, copied with these changes: that file is the
ResNet cells' and stays as it is.
"""

import os
import shutil
import tempfile
import time

import torch

from hp3d_bench import compare, counts, counts_vit, inputs
from hp3d_bench.paths.train import (
    METRICS, RenderRecorder, endless, first_steps, free_cuda, k1_bound,
    span_wrapped, stage_cfg, store_draws, upload, write_stores)
from hp3d_bench.tracing import profile_calls
from hp3d_bench.window import lag_one

# The draw of the ViT's position table: a stream of its own under the seed.
STREAM_POS_EMBED = 5
POS_EMBED_STD = 0.02


def vit_kwargs(config):
    """The reference ViT's arguments from the config's `vit` keys."""
    v = config["vit"]
    return {"img_size": tuple(v["img_size"]), "patch_size": v["patch_size"],
            "in_chans": config["pose_shape_cfg"]["MODEL"]["NUM_IN_CHANNELS"],
            "embed_dim": v["embed_dim"], "depth": v["depth"],
            "num_heads": v["num_heads"], "ratio": v["ratio"],
            "mlp_ratio": v["mlp_ratio"], "qkv_bias": v["qkv_bias"],
            "drop_path_rate": v["drop_path_rate"], "eps": v["layer_norm_eps"]}


def reference_model(config, device=None):
    """The reference's ViT predictor of the config, built on `device`."""
    from hp3d_bench.reference.models.pose_mf_shape_gaussian_net_vit import (
        ViTPoseMFShapeGaussianNet)
    m = config["pose_shape_cfg"]["MODEL"]
    with torch.device(device or "cpu"):
        return ViTPoseMFShapeGaussianNet(
            vit_kwargs(config), fc1_dim=config["fc1_dim"], embed_dim=m["EMBED_DIM"],
            delta_i=m["DELTA_I"], delta_i_weight=m["DELTA_I_WEIGHT"],
            num_smpl_betas=m["NUM_SMPL_BETAS"])


def parameter_count(model):
    return sum(p.numel() for p in model.parameters())


def seeded_inputs(ctx):
    """The weights and SMPL arrays a run hands to both sides: inputs.py's
    draw of every conv and linear leaf, and the ViT's own leaves."""
    meta = reference_model(ctx.config, "meta")
    want = ctx.config["predictor_parameters"]
    if parameter_count(meta) != want:
        raise ValueError(f"the reference's predictor has {parameter_count(meta)} "
                         f"parameters; the config states {want}")
    weights = inputs.seeded_weights(
        meta, inputs.substream(ctx.seed, inputs.STREAM_WEIGHTS), ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(
        inputs.substream(ctx.seed, STREAM_POS_EMBED))
    for name, m in meta.named_modules():
        if isinstance(m, torch.nn.LayerNorm):
            weights[f"{name}.weight"] = torch.ones(m.weight.shape, device=ctx.device)
            weights[f"{name}.bias"] = torch.zeros(m.bias.shape, device=ctx.device)
    pos = meta.image_encoder.pos_embed
    weights["image_encoder.pos_embed"] = torch.randn(
        pos.shape, generator=gen, device=ctx.device) * POS_EMBED_STD
    missing = {k for k, _ in meta.named_parameters()} - set(weights)
    if missing:
        raise KeyError(f"no seeded weights for {sorted(missing)[:5]}")
    smpl_arrays = inputs.smpl_arrays(ctx.config["pose_shape_cfg"]["MODEL"]["NUM_SMPL_BETAS"])
    return weights, smpl_arrays, meta


def build_port_model(ctx):
    """The port's predictor as its CLIs build it from the config, on the
    device; raises when it is not the config's (its parameter count)."""
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.configs import CfgNode
    with torch.device(ctx.device):
        model = build_pose_shape_model(CfgNode(ctx.config["pose_shape_cfg"]), "jacobi")
    got, want = parameter_count(model), ctx.config["predictor_parameters"]
    if got != want:
        raise RuntimeError(
            f"the port built a predictor of {got} parameters for "
            f"{ctx.config['name']}, whose predictor has {want} "
            f"(MODEL.ENCODER {ctx.config['pose_shape_cfg']['MODEL']['ENCODER']!r})")
    return model.to(ctx.device)


def build_port(ctx, model, weights, smpl_arrays):
    """The port's train step and Adam around `model`, as the train CLI
    builds them (paths/train.py::build_port with the model built here)."""
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
    inputs.load_weights(model, weights)
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
    return step, optimizer, renderer, metrics


def build_reference(ctx, weights, smpl_arrays):
    """The reference's train step, ViT predictor and Adam, built alike."""
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.models.canny_edge_detector import CannyEdgeDetector
    from hp3d_bench.reference.models.smpl import SMPL, SMPLParams
    from hp3d_bench.reference.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    from hp3d_bench.reference.train_step import TrainStep

    device = ctx.device
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    model = inputs.load_weights(reference_model(ctx.config, device), weights).to(device)
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
    return step, model, optimizer


class EncoderEvents:
    """CUDA events around a module's work in each train step: its
    forward's start and end (hooks on the module), the start of its
    backward (a hook on its output's gradient) and its last parameter's
    gradient (a hook on every parameter; the last one recorded stays)."""

    def __init__(self, module):
        self.steps = []
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]
        self.handles += [p.register_post_accumulate_grad_hook(self._grad)
                         for p in module.parameters()]

    @staticmethod
    def _event():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _pre(self, module, args):
        if torch.is_grad_enabled():
            self.steps.append([self._event(), None, None, None])

    def _post(self, module, args, out):
        if torch.is_grad_enabled():
            self.steps[-1][1] = self._event()
            out.register_hook(self._backward_start)

    def _backward_start(self, grad):
        self.steps[-1][2] = self._event()

    def _grad(self, param):
        self.steps[-1][3] = self._event()

    def close(self):
        """Remove the hooks; return [forward + backward ms] of each step
        timed, after a synchronize."""
        for h in self.handles:
            h.remove()
        torch.cuda.synchronize()
        return [f0.elapsed_time(f1) + b0.elapsed_time(b1)
                for f0, f1, b0, b1 in self.steps if b1 is not None]


def run(ctx):
    """One run of the ViT training cell; see the module docstring."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeTrainLoader)
    from hierarchicalprobabilistic3dhuman_torch.metrics import (
        TrainingLossesAndMetricsTracker)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        batch_to_device)

    traffic, device, spans = ctx.traffic, ctx.device, ctx.spans
    B = traffic["batch"]
    ctx.mark("imports done")
    model = build_port_model(ctx)
    ctx.mark("port's predictor built")
    weights, smpl_arrays, meta_model = seeded_inputs(ctx)
    ctx.mark("weights and SMPL arrays made")
    step, optimizer, renderer, metrics = build_port(ctx, model, weights, smpl_arrays)
    ctx.mark("port's train step built")
    D = ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"]
    C = ctx.config["pose_shape_cfg"]["MODEL"]["NUM_IN_CHANNELS"]
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
        encoder_events = None
        if spans.enabled:
            step.synth = span_wrapped(spans, "train.synth", step.synth)
            if spans.cuda:
                encoder_events = EncoderEvents(model.image_encoder)

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
            if encoder_events is not None:
                layer["spans_ms"]["train.encoder"] = encoder_events.close()
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
            image_flops, encoder = counts_vit.predictor_flops(meta_model, C, D)
            # The patch embedding's input gradient is not computed.
            layer["flops_per_call"] = counts.train_step_flops(
                image_flops, B, ctx.config["pose_shape_cfg"]["LOSS"]["NUM_SAMPLES"]
            ) - B * encoder["patch_embed"]
            layer["encoder_flops_per_call"] = B * counts_vit.encoder_train_flops(encoder)
            layer["k1"] = k1_bound(
                renderer, D,
                ctx.config["pose_shape_cfg"]["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"])
            layer["k1_calls_per_step"] = 1
        ctx.read_memory_peak()
        ctx.result.info["memory_peak_gb (the port's steps)"] = (
            ctx.result.memory_peak_bytes / 1e9)
    finally:
        if loader is not None:
            loader.close()
        shutil.rmtree(workdir, ignore_errors=True)

    # The port's predictor and Adam leave the device before the reference's.
    del step, model, optimizer, renderer, tracker, call, encoder_events
    free_cuda()

    r_step, r_model, r_optimizer = build_reference(ctx, weights, smpl_arrays)
    del weights
    replay = inputs.Replay(record, inputs.Draws(
        inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device))
    r_model.image_encoder.draws = replay
    fed_iter = iter(fed)
    ref = first_steps(lambda: r_step(replay, *upload(next(fed_iter), device)),
                      r_model, r_optimizer, traffic["check_steps"])
    numbers = compare.train_numbers(got, ref)
    numbers["loader_gap"] = misses[0] / len(fed)
    info = numbers.pop("_info")
    ctx.result.info.update(info)
    ctx.result.numbers = numbers
    ctx.log(f"losses: port {got['losses']} reference {ref['losses']}; "
            f"{replay.mismatches} draws the port made otherwise")
