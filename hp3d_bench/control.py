"""Readings that set the limits of a cell's numbers, on the card at the
cell's own size: the control (the reference put in the port's place and
computed in TF32, the precision below the configuration's float32 with
TF32 off) and, for a training cell, the fault of half the batch left out
(the mean taken over the rest), each against the float32 reference on
the same inputs. A state left unchanged reads 1 by the training cells'
change_gap and needs no run.

    python3 hp3d_bench/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed and variant: the numbers the cell compares.
The benchmark's own runs never run this; the lower readings are those of
the runs themselves (each prints its numbers).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hp3d_bench import compare, harness, inputs  # noqa: E402


@contextmanager
def tf32(on):
    """TF32 for float32 matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def train_readings(ctx, variants):
    """{variant: numbers} of a training cell on one seed."""
    from hp3d_bench.paths import train

    traffic, device = ctx.traffic, ctx.device
    B, n = traffic["batch"], traffic["check_steps"]
    D = ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"]
    weights, smpl_arrays, _ = train.seeded_inputs(ctx)
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_control_")
    try:
        own = train.store_draws(ctx, train.write_stores(
            os.path.join(workdir, "stores"), ctx.seed, traffic, D))
        fed = [own.take() for _ in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def reference_run(draws, rows=None, tf32_on=False):
        step, model, optimizer, _ = train.build_reference(ctx, weights, smpl_arrays)
        feed = iter(fed)

        def call():
            batch = next(feed)
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            return step(draws, *train.upload(batch, device))

        with tf32(tf32_on):
            out = train.first_steps(call, model, optimizer, n)
        del step, model, optimizer
        train.free_cuda()
        return out

    draws = inputs.Draws(inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device)
    draws.recording = True
    ref = reference_run(draws)
    out = {}
    if "tf32" in variants:
        out["tf32"] = compare.train_numbers(
            reference_run(inputs.Replay(draws.record, None), tf32_on=True), ref)
    if "half_batch" in variants:
        half = inputs.Draws(inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device)
        out["half_batch"] = compare.train_numbers(reference_run(half, rows=B // 2),
                                                  ref)
    return out


def predict_readings(ctx, variants):
    """{variant: numbers} of a predict-service cell on one seed: the
    reference in TF32 against it in float32 on `check_batches` batches."""
    from hp3d_bench.paths import predict_service as ps

    traffic, device = ctx.traffic, ctx.device
    weights, hrnet_weights, smpl_arrays, _, _ = ps.seeded_inputs(ctx)
    stacks = ps.photos(ctx.seed, traffic)
    r_hrnet, r_core = ps.build_reference(ctx, weights, hrnet_weights, smpl_arrays)
    cfg = ctx.config["pose_shape_cfg"]
    gen = torch.Generator(device=device).manual_seed(
        inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))
    numbers = {"mode_gap": 0.0, "var_gap": 0.0}
    for i in range(traffic["check_batches"]):
        state = gen.get_state()
        outs = []
        for on in (False, True):
            gen.set_state(state)
            with tf32(on):
                images = stacks[i % len(stacks)].to(device)
                hr = r_hrnet(images, object_detect_fn=None,
                             object_detect_threshold=cfg["DATA"]["BBOX_THRESHOLD"])
                o = r_core(hr["cropped_image"], hr["joints2D"], hr["joints2Dconfs"],
                           generator=gen)
            outs.append({k: v.cpu() for k, v in o.items()})
        ref, got = outs
        for name, keys in (("mode_gap", ps.OUTPUTS_MODE), ("var_gap", ps.OUTPUTS_VAR)):
            g, _ = compare.output_gap({k: got[k] for k in keys},
                                      {k: ref[k] for k in keys})
            numbers[name] = max(numbers[name], g)
    return {"tf32": numbers}


def eval_readings(ctx, variants):
    """{variant: numbers} of an evaluation cell on one seed: the reference
    in TF32 against it in float32 on `check_batches` batches of the sorted
    pass."""
    from hp3d_bench.paths import evaluate as ev
    from hp3d_bench.paths.train import reference_model
    from hp3d_bench.reference.configs import CfgNode
    from hp3d_bench.reference.evaluate_step import sample_draws

    traffic, device = ctx.traffic, ctx.device
    B, N = traffic["batch"], traffic["num_samples"]
    cfg = CfgNode(ctx.config["pose_shape_cfg"])
    weights = inputs.seeded_weights(reference_model(cfg, "meta"),
                                    inputs.substream(ctx.seed, inputs.STREAM_WEIGHTS),
                                    device)
    smpl_arrays = inputs.smpl_arrays(cfg.MODEL.NUM_SMPL_BETAS)
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_control_")
    try:
        root = ev.write_ssp3d_folder(os.path.join(workdir, "ssp3d"), ctx.seed,
                                     traffic["frames"], traffic["frame_wh"])
        steps, dataset = ev.build_reference(ctx, root, weights, smpl_arrays)
        order = ev.sorted_order(dataset.genders, B)
        gen = torch.Generator(device=device).manual_seed(
            inputs.substream(ctx.seed, inputs.STREAM_SAMPLES))
        numbers = {"frame_gap": 0.0, "pred_gap": 0.0}
        per_pass = len(order) // B
        for k in range(traffic["check_batches"]):
            pos = (k * per_pass) // traffic["check_batches"]
            frames = order[pos * B:(pos + 1) * B]
            items = [dataset[int(j)] for j in frames]
            gender = 1 if str(items[0]["gender"]) == "m" else 2
            batch = [torch.as_tensor(np.stack([it[key] for it in items]),
                                     dtype=torch.float32, device=device)
                     for key in ("image", "heatmaps", "pose", "shape")]
            tail = [torch.as_tensor(np.stack([it[key] for it in items]),
                                    dtype=torch.float32, device=device)
                    for key in ("keypoints", "silhouette")]
            draws = sample_draws(gen, B, N, cfg.MODEL.NUM_SMPL_BETAS, device)
            code = torch.full((B,), gender, dtype=torch.int32, device=device)
            outs = []
            for on in (False, True):
                with tf32(on):
                    outs.append(ev.flatten(ev.host(
                        steps[gender](draws, *batch, code, *tail))))
            ref, got = outs
            for name, keys in (("frame_gap", [k for k in ref if k.startswith("frame")]),
                               ("pred_gap", list(ev.PRED_KEYS))):
                g, _ = compare.output_gap({k: torch.from_numpy(got[k]) for k in keys},
                                          {k: torch.from_numpy(ref[k]) for k in keys})
                numbers[name] = max(numbers[name], g)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"tf32": numbers}


READINGS = {"train": train_readings, "predict_service": predict_readings,
            "evaluate": eval_readings}


def readings(cell, seed, variants=("tf32", "half_batch"), device="cuda", files=None):
    ctx = harness.Context(cell, seed, 0, 0, device, 0.0, files=files)
    return READINGS[ctx.path](ctx, variants)


def main(argv=None):
    p = argparse.ArgumentParser(prog="hp3d_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--variants", default="tf32,half_batch")
    args = p.parse_args(argv)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)
    set_full_f32(resolve_device("cuda"))
    variants = tuple(args.variants.split(","))
    limits = harness.cell_files(args.workload)[0]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant, numbers in readings(args.workload, seed, variants).items():
            where = numbers.pop("_info", None)
            correct, _ = compare.judge(
                numbers, {k: v for k, v in limits.items() if k in numbers})
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "numbers": numbers,
                              "where": where, "passes_limits": correct}),
                  flush=True)


if __name__ == "__main__":
    main()
