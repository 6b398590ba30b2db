"""The port's tracing (runtime/profiling.py) on the CPU: trace(None) records
nothing; trace(dir) writes one Chrome trace that parses, also when its
block raises; the span recorder records only while a torch.profiler session
runs, nests spans per thread and bounds its records; --profile_dir on a
small training run from packed stores and on a small SSP-3D evaluation
with the LAPACK-sign SVD each writes one trace with the program's spans
and counts; the benchmark's readers of those spans (hp3d_bench/metrics/,
through hp3d_bench/program_spans.py) on hand-built records. On the card
(`cuda`, skipped elsewhere): spans and kernels on one clock.

This file imports nothing of JAX, so the card's machine can run it without
the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import json
import os
import sys
import threading
import time
import types

import cv2
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import main as eval_main
from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
    NativeTrainLoader)
from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import svd3x3_gesdd
from hierarchicalprobabilistic3dhuman_torch.runtime import profiling
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import (
    RECORDER, SpanRecord, SpanRecorder, TRACE_NAME, count, span, spans_between,
    trace)
from hp3d_bench import harness
from test_torch_native_train import B, SPLITS, small_stores, small_train_argv

torch.set_num_threads(2)
MS = 1_000_000      # ns


def profiler_enabled():
    return torch.autograd.profiler._is_profiler_enabled


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def read_trace(profile_dir):
    """The events of the one trace in profile_dir."""
    assert os.listdir(profile_dir) == [TRACE_NAME]
    with open(os.path.join(profile_dir, TRACE_NAME)) as f:
        return json.load(f)["traceEvents"]


def op_names(events):
    return {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}


def by_index(records):
    return {r.index: r for r in records}


def test_trace_none_records_nothing(tmp_path):
    with trace(None):
        assert not profiler_enabled()
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "ok")):
        assert profiler_enabled()
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert not profiler_enabled()
    assert "aten::mm" in op_names(read_trace(tmp_path / "ok"))
    with pytest.raises(ValueError):
        with trace(str(tmp_path / "raised")):
            torch.ones(3).sum()
            raise ValueError("the block failed")
    assert not profiler_enabled()
    assert "aten::sum" in op_names(read_trace(tmp_path / "raised"))


@pytest.mark.parametrize("dirname", ["plain", "odd]name"])
def test_trace_merges_the_programs_spans(tmp_path, dirname):
    """The spans land in trace.json on the operators' clock: an operator
    run inside a span lies inside it. A `]` in the path hides the end of
    `traceEvents` from the splice, and the trace is parsed and written
    whole instead."""
    profile_dir = tmp_path / dirname
    with trace(str(profile_dir)):
        with span("outer"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
            with span("inner"):
                count("host_syncs", 2)
        count("host_syncs")
    with open(profile_dir / TRACE_NAME) as f:
        doc = json.load(f)
    assert doc["programSpansDropped"] == 0
    events = doc["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(spans) == ["host_syncs", "inner", "outer"]
    outer, inner = spans["outer"], spans["inner"]
    assert inner["args"] == {"index": inner["args"]["index"],
                             "parent": outer["args"]["index"],
                             "root": outer["args"]["index"], "host_syncs": 2}
    assert spans["host_syncs"]["dur"] == 0
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert outer["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]


def test_span_records_nothing_without_a_profiler():
    before = len(RECORDER.records)
    assert not profiler_enabled()
    assert span("a") is profiling._NO_SPAN and span("b") is profiling._NO_SPAN
    with span("a"):
        with span("b"):
            count("host_syncs", 3)
    count("host_syncs")
    assert len(RECORDER.records) == before


def test_span_records_under_a_profiler_session():
    t0 = time.time_ns()
    with cpu_profile():
        with span("outer"):
            count("host_syncs")
            with span("inner"):
                count("host_syncs", 2)
                count("other")
            with span("inner"):
                pass
        count("host_syncs", 5)

        def worker():
            with span("thread"):
                time.sleep(0.001)

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    t1 = time.time_ns()
    recs = spans_between(t0, t1)
    assert [r.name for r in recs] == ["outer", "inner", "inner", "host_syncs",
                                      "thread"]
    outer, inner1, inner2, lone, other = recs
    assert outer.parent is None and outer.root == outer.index
    assert inner1.parent == inner2.parent == outer.index
    assert inner1.root == inner2.root == outer.index
    assert outer.counters == {"host_syncs": 1}
    assert inner1.counters == {"host_syncs": 2, "other": 1}
    assert inner2.counters == {}
    # A count with no span open is a record of its own, of no length.
    assert lone.counters == {"host_syncs": 5} and lone.start_ns == lone.end_ns
    assert lone.parent is None and lone.root == lone.index
    # Another thread's spans are its own roots.
    assert other.parent is None and other.thread != outer.thread
    assert t0 <= outer.start_ns <= inner1.start_ns <= inner1.end_ns <= \
        inner2.start_ns <= inner2.end_ns <= outer.end_ns <= t1


def test_recorder_drops_past_its_bound():
    rec = SpanRecorder(max_records=2)
    with cpu_profile():
        with rec.span("a"):
            with rec.span("b"):
                with rec.span("c"):
                    rec.count("host_syncs")
                    with rec.span("d"):
                        pass
        rec.count("host_syncs")
    assert [r.name for r in rec.records] == ["a", "b"]
    assert rec.dropped == 3
    assert all(r.end_ns is not None and not r.counters for r in rec.records)


@pytest.fixture(scope="module")
def profiled_training(tmp_path_factory):
    """One small training epoch from packed stores under --profile_dir:
    (its profile directory, the program's records of the run, the stores)."""
    root = tmp_path_factory.mktemp("profiled_training")
    stores = small_stores(str(root))
    profile_dir = str(root / "profile")
    t0 = time.time_ns()
    train_main(small_train_argv(str(root / "exp"), stores, epochs=1)
               + ["--profile_dir", profile_dir])
    return profile_dir, spans_between(t0, time.time_ns()), stores


def test_profile_dir_on_training(profiled_training):
    profile_dir, _, _ = profiled_training
    names = op_names(read_trace(profile_dir))
    assert "aten::convolution_backward" in names and "aten::conv2d" in names


def test_training_spans_nest_under_each_step(profiled_training):
    _, recs, _ = profiled_training
    index = by_index(recs)
    steps = [r for r in recs if r.name == "train.step"]
    n_train, n_val = SPLITS["train"][0] // B, SPLITS["val"][0] // B
    assert len(steps) == n_train + n_val
    assert all(r.parent is None and r.root == r.index for r in steps)
    children = {r.index: [c.name for c in recs if c.parent == r.index]
                for r in steps}
    trained = [i for i, c in children.items() if "backward" in c]
    assert len(trained) == n_train
    for i, names in children.items():
        expected = (["synth", "forward", "backward", "optimizer"] if i in trained
                    else ["synth", "forward"])
        assert names == expected
    heads = [r for r in recs if r.name == "pose_head"]
    assert len(heads) == len(steps)
    for r in recs:
        if r.name in ("synth", "forward", "backward", "optimizer", "pose_head"):
            assert index[r.root].name == "train.step"
            assert index[r.root].start_ns <= r.start_ns <= r.end_ns <= \
                index[r.root].end_ns
    for r in heads:
        assert index[r.parent].name == "forward"
    # The loop's loss and metric reads are counted where they happen.
    assert sum(r.counters.get("host_syncs", 0) for r in recs) > len(steps)


def test_training_trace_holds_the_spans(profiled_training):
    profile_dir, recs, _ = profiled_training
    events = read_trace(profile_dir)
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in spans) == sorted(r.name for r in recs)
    assert {e["args"]["root"] for e in spans if e["name"] == "pose_head"} == {
        r.index for r in recs if r.name == "train.step" and r.index in
        {x.root for x in recs if x.name == "pose_head"}}
    others = [e for e in events if "ts" in e and e.get("ph") != "M"
              and e.get("cat") != "program_span"]
    lo = min(e["ts"] for e in others)
    hi = max(e["ts"] + e.get("dur", 0) for e in others)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in spans)


def test_native_loader_records_a_root_span_each_take(profiled_training):
    _, recs, stores = profiled_training
    takes = [r for r in recs if r.name == "data.next"]
    assert len(takes) == SPLITS["train"][0] // B + SPLITS["val"][0] // B
    loader = NativeTrainLoader(os.path.join(stores, "train"), B, n_threads=2)
    try:
        t0 = time.time_ns()
        with cpu_profile():
            batches = iter(loader)
            for _ in range(3):
                next(batches)
        recs = spans_between(t0, time.time_ns())
    finally:
        loader.close()
    assert [r.name for r in recs] == ["data.next"] * 3
    assert all(r.parent is None and r.root == r.index for r in recs)


@pytest.fixture(scope="module")
def profiled_evaluation(tmp_path_factory):
    """A small SSP-3D evaluation with the LAPACK-sign SVD under
    --profile_dir: (its profile directory, output directory, records, QR
    iterations it made)."""
    root = tmp_path_factory.mktemp("profiled_evaluation")
    demo = sorted(f for f in os.listdir(chip_smoke.DEMO) if f.endswith(".png"))[:2]
    images = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(chip_smoke.DEMO, f)),
                                      cv2.COLOR_BGR2RGB), (96, 96)) for f in demo]
    ssp3d = chip_smoke.write_ssp3d_folder(str(root / "ssp3d"), images)
    cfg = root / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 32\n")
    profile_dir = str(root / "profile")
    before = svd3x3_gesdd.iterations
    t0 = time.time_ns()
    eval_main(["--dataset", "ssp3d", "--dataset_path", ssp3d, "--device", "cpu",
               "--batch_size", "2", "-N", "2", "--pose_shape_cfg", str(cfg),
               "--save_path", str(root / "out"), "--num_workers", "0",
               "--svd_impl", "lapack", "--profile_dir", profile_dir])
    recs = spans_between(t0, time.time_ns())
    return profile_dir, root / "out", recs, svd3x3_gesdd.iterations - before


def test_profile_dir_on_evaluation(profiled_evaluation):
    profile_dir, out, _, _ = profiled_evaluation
    assert "aten::conv2d" in op_names(read_trace(profile_dir))
    assert os.path.exists(out / "fname_per_frame.npy")


def test_lapack_evaluation_counts_its_host_syncs(profiled_evaluation):
    profile_dir, _, recs, iterations = profiled_evaluation
    index = by_index(recs)
    assert iterations > 0
    steps = [r for r in recs if r.name == "eval.step"]
    heads = [r for r in recs if r.name == "pose_head"]
    assert len(steps) == len(heads) >= 1
    assert all(index[r.parent].name == "eval.step" for r in heads)
    # One read a test of the QR loop's condition, on the pose head's span.
    head_syncs = sum(r.counters.get("host_syncs", 0) for r in heads)
    assert head_syncs >= iterations + len(heads)
    # The outputs' fetch (_to_host) is counted too, outside the step.
    assert sum(r.counters.get("host_syncs", 0) for r in recs) > head_syncs
    events = [e for e in read_trace(profile_dir) if e.get("cat") == "program_span"]
    assert sum(e["args"].get("host_syncs", 0) for e in events) == sum(
        r.counters.get("host_syncs", 0) for r in recs)


def record(index, name, start_ms, end_ms, parent=None, root=None, **counters):
    r = SpanRecord(index, name, start_ms * MS,
                   None if parent is None else parent.index,
                   None if root is None else root.index, thread=1)
    r.end_ns = end_ms * MS
    r.counters = counters
    return r


def step_records(kind, offset, first):
    """One call's records, as the program would make them, at offset ms;
    indices from `first`."""
    recs = []

    def add(name, a, b, parent=None, **counters):
        r = record(first + len(recs), name, offset + a, offset + b, parent,
                   None if parent is None else
                   next(x for x in recs if x.index == parent.root), **counters)
        recs.append(r)
        return r

    if kind == "train":
        add("data.next", 1, 3)
        top = add("train.step", 5, 45)
        add("synth", 6, 10, top)
        fwd = add("forward", 10, 30, top)
        add("pose_head", 12, 20, fwd)
        add("backward", 30, 40, top)
        add("optimizer", 40, 44, top)
        add("host_syncs", 47, 47, host_syncs=2)
    elif kind == "predict":
        add("predict.hrnet", 0, 10)
        core = add("predict.core", 10, 40)
        add("pose_head", 15, 20, core)
        add("samples", 25, 37, core)
        add("host_syncs", 45, 45, host_syncs=1)
    else:
        top = add("eval.step", 2, 30)
        add("pose_head", 5, 15, top, host_syncs=40)
        for t in (31, 32, 33):
            add("host_syncs", t, t, host_syncs=4)
    return recs


# (device activity start, duration) in ms of one call of each kind
OPS = {"train": [(2, 2), (13, 1), (15, 1), (20, 1), (46, 3)],
       "predict": [(5, 2), (41, 4)],
       "eval": [(6, 3), (31, 1)]}


def hand_built(kind, calls=2, period=50):
    """A traced run's `layer` and the program's records for `calls` calls of
    `kind`, each `period` ms long."""
    recs, ops = [], []
    for k in range(calls):
        recs += step_records(kind, k * period, len(recs))
        ops += [("kernel", (k * period + s) * MS, d * MS) for s, d in OPS[kind]]
    layer = {"profile": {"ops": ops, "host_start_ns": 0,
                         "host_end_ns": calls * period * MS,
                         "span_ns": calls * period * MS, "marks": []},
             "profile_calls": calls}
    return layer, recs


# Per call: train idle 42 ms of 50, 4 ms of it outside any span; predict
# 44 and 6; eval 46 and 21.
READINGS = [
    ("train.host_ms.step", "train", 40.0),
    ("train.host_ms.synth", "train", 4.0),
    ("train.host_ms.forward", "train", 20.0),
    ("train.host_ms.pose_head", "train", 8.0),
    ("train.host_ms.backward", "train", 10.0),
    ("train.host_ms.optimizer", "train", 4.0),
    ("train.launches.pose_head", "train", 3.0),
    ("data.host_ms.next", "train", 2.0),
    ("device.idle_untraced.train", "train", 100.0 * 4 / 42),
    ("predict.host_ms.pose_head", "predict", 5.0),
    ("predict.host_ms.samples", "predict", 12.0),
    ("device.idle_untraced.predict", "predict", 100.0 * 6 / 44),
    ("eval.host_ms.pose_head", "eval", 10.0),
    ("eval.host_syncs", "eval", 52.0),
    ("device.idle_untraced.eval", "eval", 100.0 * 21 / 46),
]

# The readers that take a span under one path's root span, and a path whose
# records hold spans of those names under another root.
UNDER_A_ROOT = {"train.host_ms.synth", "train.host_ms.forward",
                "train.host_ms.pose_head", "train.host_ms.backward",
                "train.host_ms.optimizer", "train.launches.pose_head",
                "predict.host_ms.pose_head", "predict.host_ms.samples",
                "eval.host_ms.pose_head"}
OTHER_PATH = {"train": "eval", "predict": "train", "eval": "predict"}


def install_records(monkeypatch, recs):
    rec = SpanRecorder()
    rec.records = recs
    monkeypatch.setattr(profiling, "spans_between", rec.spans_between)


@pytest.mark.parametrize("name,kind,expected", READINGS)
def test_reader_of_the_programs_spans(monkeypatch, name, kind, expected):
    layer, recs = hand_built(kind)
    install_records(monkeypatch, recs)
    assert harness.metric_module(name).read(layer) == pytest.approx(expected)
    if name in UNDER_A_ROOT:
        # Another path's spans of the same names are not this path's.
        _, foreign = hand_built(OTHER_PATH[kind])
        for r in foreign:
            r.index += len(recs)
            r.root += len(recs)
            r.parent = None if r.parent is None else r.parent + len(recs)
        install_records(monkeypatch, recs + foreign)
        assert harness.metric_module(name).read(layer) == pytest.approx(expected)


def test_readers_of_the_programs_spans_read_nothing_without_them(monkeypatch):
    """On a program without the recorder, on a run with no profile and on a
    profile with no records, every reader gives None and raises nothing."""
    names = [n for n, _, _ in READINGS]
    layer, recs = hand_built("train")
    install_records(monkeypatch, [])
    assert all(harness.metric_module(n).read(layer) is None for n in names)
    install_records(monkeypatch, recs)
    assert all(harness.metric_module(n).read({}) is None for n in names)
    module = "hierarchicalprobabilistic3dhuman_torch.runtime.profiling"
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert all(harness.metric_module(n).read(layer) is None for n in names)


@pytest.mark.parametrize("late_ms,strays,joined", [
    (0.5, 0, True), (1.5, 0, True), (1.5, 1, False), (0, 2, False)])
def test_reader_of_idle_needs_the_shared_clock(monkeypatch, late_ms, strays,
                                               joined):
    """An activity that starts after the profiled calls' end on the host
    clock, as a copy read just before the closing synchronize can on the
    card, is clipped within a millisecond; one further out is left out as a
    record the profiler got wrong, while such records are under 1% of the
    profile; more, and the profile's clock is not the host's."""
    layer, recs = hand_built("train")
    install_records(monkeypatch, recs)
    name = "device.idle_untraced.train"
    ops = layer["profile"]["ops"]
    # 100 short activities inside one already busy interval: the reading
    # stays, and one stray among 111 activities is under 1%.
    ops[4:4] = [("small", 46 * MS + k * 10_000, 10_000) for k in range(100)]
    end = layer["profile"]["host_end_ns"]
    ops.append(("copy", end + int(late_ms * MS), MS // 10))
    ops[:0] = [("lost", -5 * MS - k, 1000) for k in range(strays)]
    got = harness.metric_module(name).read(layer)
    assert got == (pytest.approx(100.0 * 4 / 42) if joined else None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's activity and its clock)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_and_kernels_share_one_clock_on_card(cuda_device):
    """Under a CUDA-only profiler session the recorder records, and a kernel
    launched inside a span, on an idle card, starts inside [span start,
    span end + 1 ms] on the profile's clock."""
    x = torch.ones(1 << 20, device=cuda_device)
    (x * 3).sum()
    torch.cuda.synchronize()
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        with span("probe"):
            y = x * 3
        torch.cuda.synchronize()
    probes = [r for r in spans_between(t0, time.time_ns()) if r.name == "probe"]
    assert len(probes) == 1
    probe = probes[0]
    starts = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            starts.append(e.start_ns() if hasattr(e, "start_ns")
                          else e.start_us() * 1000)
    assert starts
    assert all(probe.start_ns <= s <= probe.end_ns + MS for s in starts), (
        [s - probe.start_ns for s in starts], probe.end_ns - probe.start_ns)
    assert float(y[0]) == 3.0
