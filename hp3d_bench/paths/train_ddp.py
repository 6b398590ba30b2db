"""Training traffic over several cards: closed loop, NCCL data-parallel,
through the port's own launcher and sharded train step.

The run's process is rank 0; it starts the other ranks (one process a card,
`traffic["ranks"]` in all) with the port's parallel/launch.py::_rank, which
joins each to the process group (NCCL on the card, gloo on the CPU) and
hands it its ("data", "sample") mesh of `ranks` x 1. Every rank builds the
port's train step as paths/train.py does and shards it with
parallel/sharded_train.py::make_sharded_train_step: the predictor in DDP
with its BatchNorms synced over "data", the global batch's synthetic stage
on every rank, this rank's rows through the predictor. Every rank reads the
same packed stores (written once by rank 0 before the others start) through
its own NativeTrainLoader of `loader_threads` threads, as the port's train
CLI does on a mesh: the loader hands out its batches in one order for a
seed and thread count, so all ranks take the same global batches. Every
step checks that they did (the CRC-32 of each rank's poses, gathered on a
gloo group of the host) and raises where they did not.

After each dispatch rank 0 decides whether to go on, on the same gather
(no CUDA synchronisation), so every rank runs the same number of steps.
Set-up runs `check_steps` steps on every rank; rank 0's (its global loss,
its first gradient as Adam holds it, its parameters' change) are held
after the window against the single-process reference at the global batch
(paths/train.py::build_reference) on rank 0's card, on the batches and
draws rank 0 recorded. Then WARM_STEPS untimed steps, and the window,
whose clock rank 0 keeps. Rank 0 alone traces (its spans, its profile of
`profile_steps` steps that all ranks run) and prints the result line.

A control may plant a fault on every rank (`traffic["fault"]`, which the
cell's traffic does not set; see FAULTS).

A rank that exits with an error ends the run at once (the others would
wait in a collective).
"""

import os
import shutil
import sys
import tempfile
import threading
import time
import zlib
from types import SimpleNamespace

import torch
import torch.distributed as dist

from hp3d_bench import compare, counts, inputs
from hp3d_bench.paths import train
from hp3d_bench.stores import write_store
from hp3d_bench.tracing import Spans, profile_calls
from hp3d_bench.window import thirds

# Seconds rank 0 waits for the other ranks to exit after the window.
JOIN_S = 120
# Untimed steps between the checked steps and the window.
WARM_STEPS = 8
# The set-up's test of the loader's order: samplers of this many threads
# and batches, each run must hand out its windows in order.
ORDER_THREADS, ORDER_BATCHES, ORDER_RUNS = 8, 64, 4


def rank_context(args, device):
    """What a rank's step needs of the cell (paths/train.py's functions
    read these attributes)."""
    return SimpleNamespace(config=args.config, traffic=args.traffic, seed=args.seed,
                           device=torch.device(device))


def agreed(stop, pose, group):
    """Rank 0's decision to stop, on every rank, over a host (gloo) group;
    raises unless every rank's batch has the same poses (their CRC-32)."""
    mine = torch.tensor([int(stop), zlib.crc32(pose.tobytes())], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    crcs = [int(t[1]) for t in every]
    if len(set(crcs)) > 1:
        raise RuntimeError(f"the ranks took different global batches (their poses' "
                           f"CRC-32s {crcs}): the port's loader does not hand "
                           "out its batches in one order")
    return bool(every[0][0])


def lag_one_ranks(dispatch, complete, until, agree, clock=time.perf_counter):
    """window.lag_one on every rank: call N+1 is dispatched before call N's
    results are read; after each dispatch `agree` gives every rank rank 0's
    `until(calls, seconds)`, and the loop closes when the last call's
    results are on the host."""
    t0 = clock()
    pending, k, done_at = None, 0, []
    while True:
        t = clock()
        handle = dispatch(k)
        k += 1
        if pending is not None:
            complete(pending[1])
            done_at.append(clock())
        pending = (t, handle)
        if agree(until(k, clock() - t0)):
            break
    complete(pending[1])
    done_at.append(clock())
    window_s = done_at[-1] - t0
    done_s = [t - t0 for t in done_at]
    return {"calls": k, "window_s": window_s, "thirds": thirds(done_s, window_s)}


def check_loader_order(workdir):
    """Stop in set-up, before any rank starts, where the port's loader hands
    out its batches in the order its threads finish them (a port before
    batches came in one order): the ranks would take different batches.
    Sequential windows of one-record batches from ORDER_THREADS threads must
    come in order, ORDER_RUNS times."""
    import numpy as np

    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeBatchSampler)

    path = write_store(os.path.join(workdir, "order.bin"),
                       np.arange(ORDER_BATCHES, dtype=np.int64)[:, None])
    for _ in range(ORDER_RUNS):
        sampler = NativeBatchSampler([path], 1, n_threads=ORDER_THREADS,
                                     shuffle=False)
        try:
            got = [int(sampler.next()[0][0, 0]) for _ in range(ORDER_BATCHES)]
        finally:
            sampler.close()
        if got != list(range(ORDER_BATCHES)):
            raise RuntimeError(
                "the port's loader hands out its batches in the order its threads "
                "finish them, so the ranks would take different global batches")


def _local_bucket(_, bucket):
    """A DDP communication hook that reduces nothing: each rank keeps its
    own gradients."""
    fut = torch.futures.Future()
    fut.set_result(bucket.buffer())
    return fut


def _local_grads(step, mesh, seed):
    step.ddp.register_comm_hook(None, _local_bucket)
    return seed


def _local_batchnorm(step, mesh, seed):
    from hierarchicalprobabilistic3dhuman_torch.parallel.sharded_train import (
        sync_batchnorms)
    sync_batchnorms(step.model, None)
    return seed


def _rank_batches(step, mesh, seed):
    return seed + mesh.rank


# What only this cell can get wrong, each fault(step, mesh, loader seed) ->
# loader seed: no gradient all-reduce, BatchNorms over a rank's own rows,
# and ranks that take different batches (which `agreed` stops).
FAULTS = {"local_grads": _local_grads, "local_batchnorm": _local_batchnorm,
          "rank_batches": _rank_batches}


def rank_main(args, mesh):
    """One rank's run (parallel/launch.py::_rank calls it with the rank's
    mesh); rank 0 returns what the comparison reads and fills its Context's
    result."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeTrainLoader)
    from hierarchicalprobabilistic3dhuman_torch.metrics import (
        TrainingLossesAndMetricsTracker)
    from hierarchicalprobabilistic3dhuman_torch.parallel.sharded_train import (
        make_sharded_train_step)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        batch_to_device)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import set_full_f32

    main = mesh.is_main
    torch.set_num_threads(args.threads)
    set_full_f32(mesh.device)
    ctx = args.ctx if main else None
    rctx = rank_context(args, mesh.device)
    traffic, device = args.traffic, rctx.device
    spans = ctx.spans if main else Spans(False, device)
    B = traffic["batch"]
    control = dist.new_group(backend="gloo")
    weights, smpl_arrays, meta_model = train.seeded_inputs(rctx)
    step, model, optimizer, renderer, metrics = train.build_port(rctx, weights,
                                                                 smpl_arrays)
    step = make_sharded_train_step(step, mesh)
    seed = inputs.substream(args.seed, inputs.STREAM_DATA)
    if traffic.get("fault") is not None:
        seed = FAULTS[traffic["fault"]](step, mesh, seed)
    if main:
        ctx.mark("every rank's sharded train step built")
    loader = NativeTrainLoader(args.stores, B, n_threads=traffic["loader_threads"],
                               seed=seed)
    try:
        batches = train.endless(loader)
        if main:
            batches = ctx.wrap("train_batches", batches)
        draws = inputs.Draws(inputs.substream(args.seed, inputs.STREAM_DRAWS), device)
        tracker = TrainingLossesAndMetricsTracker(
            metrics_to_track=list(metrics),
            img_wh=args.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"],
            log_save_path=os.devnull, load_logs=False, current_epoch=0,
            save_logs=False)
        tracker.initialise_loss_metric_sums()
        call = ctx.wrap("train_step", step) if main else step

        def resolve(handle):
            loss, sums = handle
            tracker.update_per_batch_sums(
                split="train", loss=float(loss), batch_size=B,
                metric_sums={k: float(v) for k, v in sums.items()})
            return loss

        fed, misses = [], [0]
        draws.recording = main

        def setup_step():
            batch = next(batches)
            agreed(False, batch["pose"], control)
            if main:
                mine, same = args.own.match(batch)
                fed.append(mine)
                misses[0] += not same
            loss, sums, _ = call(draws, *batch_to_device(batch, device))
            return resolve((loss, sums))

        got = train.first_steps(setup_step, model, optimizer, traffic["check_steps"])
        draws.recording = False
        record, draws.record = draws.record, []
        if spans.enabled:
            step.synth = train.span_wrapped(spans, "train.synth", step.synth)

        taken = [None]

        def dispatch(_k=None):
            t = time.time_ns()
            batch = next(batches)
            taken[0] = batch["pose"]
            inputs_dev = batch_to_device(batch, device)
            t1 = time.time_ns()
            spans.host("data.wait", (t1 - t) / 1e9)
            with spans.span("train.step"):
                loss, sums, _ = call(draws, *inputs_dev)
            return loss, sums, (t, t1, time.time_ns())

        def agree(stop):
            return agreed(stop, taken[0], control)

        def complete(handle):
            resolve(handle[:2])

        lag_one_ranks(dispatch, complete, lambda k, _s: k >= WARM_STEPS, agree)
        if device.type == "cuda":
            torch.cuda.synchronize()
        for kept in (spans.events, spans.host_s, spans.counters):
            kept.clear()  # the spans read the window's steps alone
        if main:
            ctx.window_start()
        win = lag_one_ranks(dispatch, complete, lambda _k, s: s >= args.seconds, agree)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if main:
            steps, window_s = win["calls"], win["window_s"]
            ctx.result.e2e["train_img_per_s"] = steps * B / window_s
            ctx.result.attempted = steps
            ctx.log(f"window: {steps} steps of {B} over {mesh.size} ranks in "
                    f"{window_s:.3f} s; steps completed in each third: "
                    f"{win['thirds']}")

        if args.trace:
            profile = None
            if main and device.type == "cuda":
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

                profile = profile_calls(profiled_step, traffic["profile_steps"], marks)
                resolve(pending[0][:2])
            elif device.type == "cuda":
                pending = None
                for _ in range(traffic["profile_steps"]):
                    handle = dispatch()
                    if pending is not None:
                        resolve(pending[:2])
                    pending = handle
                resolve(pending[:2])
            if main:
                layer = ctx.result.layer
                layer["spans_ms"] = spans.device_ms()
                layer["host_s"] = dict(spans.host_s)
                if profile is not None:
                    layer["profile"] = profile
                    layer["profile_calls"] = traffic["profile_steps"]
                b = B // mesh.shape["data"]
                cfg = args.config["pose_shape_cfg"]
                # This rank's rows through the predictor, its loss and
                # metrics; the global batch's two SMPL calls of the
                # synthetic stage, which every rank runs.
                layer["flops_per_call"] = counts.train_step_flops(
                    counts.predictor_flops(meta_model, cfg["MODEL"]["NUM_IN_CHANNELS"],
                                           cfg["DATA"]["PROXY_REP_SIZE"]),
                    b, cfg["LOSS"]["NUM_SAMPLES"]) + 2 * (B - b) * counts.smpl_flops(
                        cfg["MODEL"]["NUM_SMPL_BETAS"])
                layer["k1"] = train.k1_bound(
                    renderer, cfg["DATA"]["PROXY_REP_SIZE"],
                    cfg["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"])
                layer["k1_calls_per_step"] = 1
        if main:
            ctx.read_memory_peak()
            return {"got": got, "record": record, "fed": fed, "misses": misses[0],
                    "weights": weights, "smpl_arrays": smpl_arrays}
        return None
    finally:
        loader.close()


def _other_rank(index, args, coordinator):
    """Ranks 1 .. ranks - 1, each in a process of its own."""
    from hierarchicalprobabilistic3dhuman_torch.parallel.launch import _rank
    _rank(index + 1, rank_main, args, coordinator, args.traffic["ranks"], 1, None)


def watch(context, stop):
    """End the run as soon as one of the other ranks exits with an error."""
    while not stop.is_set():
        for p in context.processes:
            if p.exitcode not in (None, 0):
                print(f"rank process {p.pid} exited with {p.exitcode}; ending the "
                      "run", file=sys.stderr, flush=True)
                os._exit(1)
        stop.wait(0.5)


def run(ctx):
    """One run of the data-parallel training cell; see the module docstring."""
    import torch.multiprocessing as mp

    from hierarchicalprobabilistic3dhuman_torch.parallel.launch import _rank
    from hierarchicalprobabilistic3dhuman_torch.parallel.mesh import free_port

    traffic, device = ctx.traffic, ctx.device
    ranks, B = traffic["ranks"], traffic["batch"]
    D = ctx.config["pose_shape_cfg"]["DATA"]["PROXY_REP_SIZE"]
    if B != ctx.config["pose_shape_cfg"]["TRAIN"]["BATCH_SIZE"]:
        raise ValueError("the cell's batch must be the config's TRAIN.BATCH_SIZE")
    if B % ranks:
        raise ValueError(f"the global batch {B} must divide over {ranks} ranks")
    if device.type == "cuda" and traffic["backend"] != "nccl":
        raise ValueError("on the card the port's launcher joins the ranks with nccl")
    ctx.mark("imports done")
    workdir = tempfile.mkdtemp(prefix="hp3d_bench_train_ddp_")
    context, stop = None, threading.Event()
    try:
        check_loader_order(workdir)
        stores = os.path.join(workdir, "stores")
        own = train.store_draws(ctx, train.write_stores(stores, ctx.seed, traffic, D))
        ctx.mark("stores written")
        coordinator = f"127.0.0.1:{free_port()}"
        shared = dict(config=ctx.config, traffic=traffic, seed=ctx.seed,
                      seconds=ctx.seconds, trace=ctx.trace, stores=stores,
                      device=device.type,
                      threads=(torch.get_num_threads() if device.type == "cpu"
                               else max(1, torch.get_num_threads() // ranks)))
        context = mp.start_processes(_other_rank, args=(SimpleNamespace(**shared),
                                                        coordinator),
                                     nprocs=ranks - 1, join=False, daemon=True,
                                     start_method="spawn")
        threading.Thread(target=watch, args=(context, stop), daemon=True).start()
        out = _rank(0, rank_main, SimpleNamespace(ctx=ctx, own=own, **shared),
                    coordinator, ranks, 1, None)
        stop.set()
        t = time.monotonic()
        for p in context.processes:
            p.join(max(1.0, JOIN_S - (time.monotonic() - t)))
        codes = [p.exitcode for p in context.processes]
        if codes != [0] * (ranks - 1):
            raise RuntimeError(f"the other ranks exited with {codes}")
        ctx.mark("every rank done")
    finally:
        stop.set()
        if context is not None:
            for p in context.processes:
                if p.is_alive():
                    p.terminate()
        shutil.rmtree(workdir, ignore_errors=True)

    if device.type == "cuda":
        torch.cuda.set_device(0)
    train.free_cuda()
    # The single-process reference at the global batch, on rank 0's batches
    # and draws.
    weights, smpl_arrays = out["weights"], out["smpl_arrays"]
    r_step, r_model, r_optimizer, _ = train.build_reference(ctx, weights, smpl_arrays)
    replay = inputs.Replay(out["record"], inputs.Draws(
        inputs.substream(ctx.seed, inputs.STREAM_DRAWS), device))
    fed_iter = iter(out["fed"])
    ref = train.first_steps(
        lambda: r_step(replay, *train.upload(next(fed_iter), device)),
        r_model, r_optimizer, traffic["check_steps"])
    numbers = compare.train_numbers(out["got"], ref)
    numbers["loader_gap"] = out["misses"] / len(out["fed"])
    ctx.result.info = numbers.pop("_info")
    ctx.result.numbers = numbers
    ctx.log(f"losses: rank 0 {out['got']['losses']} reference {ref['losses']}; "
            f"{replay.mismatches} draws rank 0 made otherwise")
