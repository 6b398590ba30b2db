"""Profiling hooks behind the drivers' --profile_dir flag (absent in the
reference, SURVEY section 5).

Counterpart of hierarchicalprobabilistic3dhuman_tpu/runtime/profiling.py
(trace :15, StageTimer :27): `trace` wraps torch.profiler where the JAX
package wraps jax.profiler, and writes one Chrome trace (open it in
Perfetto or chrome://tracing); StageTimer imports no JAX and is copied.

The profiler keeps every event in memory until the block ends and then
writes them all: a training step at B = 72 makes some 38,000 device
launches, so trace a few steps, not a whole run.
"""

import contextlib
import os
import time

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(profile_dir, device="cpu"):
    """Record the enclosed block with torch.profiler: CPU activity, and the
    card's kernels and copies when `device` is a CUDA device; on exit write
    `profile_dir`/trace.json, also when the block raises (as jax.profiler's
    trace is stopped). A no-op when profile_dir is None."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, TRACE_NAME))


class StageTimer:
    """Lightweight per-stage wall-clock accumulator for driver loops."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name] / self.counts[name], 4)}
                for name in self.totals}
