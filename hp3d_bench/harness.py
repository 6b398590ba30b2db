"""One run of one cell: find its pieces by name, check the device, run its
path, check its outputs against the reference, and print the result line.

BENCHMARK.json lists the cells and metrics. A cell's file
(workloads/<cell>.json) names its configuration (configs/<name>.json), its
traffic mix (traffic/<name>.json, which names the path, paths/<path>.py)
and the limits of the numbers compared; a per-layer metric's reader is
metrics/<name>.py. Adding a cell, a mix or a metric adds files and edits
none.
"""

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax",
                     "hierarchicalprobabilistic3dhuman_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(cell):
    """The cell's workload, configuration and traffic, by name."""
    workload = load_json(BENCH_DIR, "workloads", f"{cell}.json")
    config = load_json(BENCH_DIR, "configs", f"{workload['config']}.json")
    traffic = load_json(BENCH_DIR, "traffic", f"{workload['traffic']}.json")
    return workload, config, traffic


def applies(metric, cell, bench):
    """Whether a metric of BENCHMARK.json is the cell's: listed for it, or
    (without a `workloads` key) reported wherever what it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(applies(m, cell, bench) for m in bench["end_to_end"]
               if m["name"] == moves)


def metric_module(name):
    """metrics/<name>.py, loaded by its path (names hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"hp3d_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if module.NAME != name:
        raise ValueError(f"{path} defines {module.NAME}")
    return module


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (the port's name begins with the JAX package's)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


class Result:
    def __init__(self):
        self.e2e = {}
        self.layer = {}
        self.numbers = {}
        self.info = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.setup_s = None


class Context:
    """What a path's `run(ctx)` gets: the cell's files, the run's
    arguments, the device, the spans, and where to put its results."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, wrap=None,
                 files=None):
        import torch
        from hp3d_bench.tracing import Spans
        self.cell = cell
        self.workload, self.config, traffic = files or cell_files(cell)
        self.traffic = traffic["params"]
        self.path = traffic["path"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.spans = Spans(bool(trace), self.device)
        self.result = Result()
        self._wrap = wrap or {}

    def wrap(self, what, obj):
        """The object a path drives as `what`; tests put a broken one in."""
        fn = self._wrap.get(what)
        return obj if fn is None else fn(obj)

    def log(self, msg):
        print(f"[{self.cell}] {msg}", file=sys.stderr, flush=True)

    def mark(self, what):
        """Log how far set-up has come, in seconds since process start."""
        self.log(f"{time.monotonic() - self.t_start:.3f} s: {what}")

    def window_start(self):
        """Set-up ends here: synchronize and read the set-up time."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.result.setup_s = time.monotonic() - self.t_start
        self.log(f"set-up {self.result.setup_s:.3f} s; window of {self.seconds} s")

    def read_memory_peak(self):
        import torch
        if self.device.type == "cuda":
            self.result.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device)


def run_cell(cell, seed, seconds, trace, device, t_start, wrap=None, files=None):
    """Drive the cell's path; return the Context with its results."""
    ctx = Context(cell, seed, seconds, trace, device, t_start, wrap, files)
    path = importlib.import_module(f"hp3d_bench.paths.{ctx.path}")
    path.run(ctx)
    return ctx


def result_line(ctx, bench, device_info):
    """The contract's result: correct, attempted, failed, metrics, device
    (and with --trace 1 the breakdown), the numbers compared last."""
    from hp3d_bench import compare
    cell = ctx.cell
    res = ctx.result
    correct, lines = compare.judge(res.numbers, ctx.workload["limits"])
    correct = correct and res.failed == 0
    metrics = {}
    if ctx.trace:
        for m in bench["per_layer"]:
            if not applies(m, cell, bench):
                continue
            value = metric_module(m["name"]).read(res.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(res.e2e, setup_s=res.setup_s)
        for m in bench["end_to_end"]:
            if applies(m, cell, bench):
                if e2e.get(m["name"]) is None:
                    raise RuntimeError(f"{cell}: the path gave no {m['name']}")
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device_info}
    prof = res.layer.get("profile")
    if ctx.trace and prof is not None:
        from hp3d_bench.tracing import busy_ns, idle_gaps, top_ops
        device_info["busy_s"] = busy_ns(prof["ops"]) / 1e9
        device_info["window_s"] = prof["span_ns"] / 1e9
        line["breakdown"] = {"device_ops": top_ops(prof["ops"]),
                             "idle_gaps": idle_gaps(prof)}
    line["compared"] = {name: {"value": plain(res.numbers.get(name)), "limit": limit}
                        for name, limit in sorted(ctx.workload["limits"].items())}
    return line, lines


CARD_QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu,"
              "clocks_throttle_reasons.active")


def card_line():
    """The card's name and power limit, and its power, clocks, temperature
    and throttle reasons as the run ends."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_QUERY}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def host_line():
    """The host's load averages and the time of a fixed piece of Python
    work as the run ends: a launch-bound run slows with its host."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i
    probe_ms = (time.perf_counter() - t) * 1e3
    load = " ".join(f"{v:.2f}" for v in os.getloadavg())
    return (f"load average {load} on {os.cpu_count()} cores; "
            f"a fixed Python loop {probe_ms:.3f} ms")


def parse(argv):
    p = argparse.ArgumentParser(prog="hp3d_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # The port's entry points set this (utils/device.py::set_full_f32).
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)
    device = resolve_device("cuda")
    set_full_f32(device)
    torch.cuda.reset_peak_memory_stats(device)
    ctx = run_cell(args.workload, args.seed, args.seconds, args.trace, "cuda",
                   t_start)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded: {found}", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": int(ctx.result.memory_peak_bytes)}
    line, lines = result_line(ctx, bench, device_info)
    from hp3d_bench.counts import PEAKS_SOURCE
    print(f"card ({CARD_QUERY}): {card_line()}; peaks: {PEAKS_SOURCE}",
          file=sys.stderr)
    print(f"host: {host_line()}", file=sys.stderr)
    for what, value in ctx.result.info.items():
        print(f"{what}: {value}", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


def plain(x):
    """A number for JSON: a non-finite one as its name."""
    return x if x is None or math.isfinite(x) else str(x)
