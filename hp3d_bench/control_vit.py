"""control.py's readings for the ViT training cell (paths/train_vit.py),
whose reference predictor control.py does not build: the ViT reference put
in the port's place and computed in TF32 (the precision below the
configuration's float32 with TF32 off), and the fault of half the batch
left out, each against the float32 reference on the same inputs.

    python3 hp3d_bench/control_vit.py --workload vith.train.s2.b72 --seeds 11,12,13

prints one JSON line a seed and variant, as control.py does.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hp3d_bench import compare, harness, inputs  # noqa: E402
from hp3d_bench.control import tf32  # noqa: E402


def vit_train_readings(ctx, variants):
    """{variant: numbers} of the ViT training cell on one seed."""
    from hp3d_bench.paths import train, train_vit

    traffic, device = ctx.traffic, ctx.device
    B, n = traffic["batch"], traffic["check_steps"]
    D = ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"]
    weights, smpl_arrays, _ = train_vit.seeded_inputs(ctx)
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_control_")
    try:
        own = train.store_draws(ctx, train.write_stores(
            os.path.join(workdir, "stores"), ctx.seed, traffic, D))
        fed = [own.take() for _ in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def reference_run(draws, rows=None, tf32_on=False):
        step, model, optimizer = train_vit.build_reference(ctx, weights, smpl_arrays)
        model.image_encoder.draws = draws
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="hp3d_bench/control_vit.py")
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
        ctx = harness.Context(args.workload, seed, 0, 0, "cuda", 0.0)
        for variant, numbers in vit_train_readings(ctx, variants).items():
            where = numbers.pop("_info", None)
            correct, _ = compare.judge(
                numbers, {k: v for k, v in limits.items() if k in numbers})
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "numbers": numbers,
                              "where": where, "passes_limits": correct}),
                  flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
