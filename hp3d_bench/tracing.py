"""What a traced run (`--trace 1`) records from the benchmark's own files:
spans of CUDA events around the calls into each layer over the whole
window, host-clock spans, counters, and a torch.profiler trace of CUDA
activity alone over a few calls after the window.

Spans cost two event records a call, and nothing in an untraced run: the
paths call `Spans.span` either way, and with tracing off it records
nothing.
"""

import time
from contextlib import contextmanager

import torch


class Spans:
    """Named spans. `span(name)` brackets a call with two CUDA events
    (device time, including the device's waits for the host inside it);
    `host(name, seconds)` keeps a host-clock reading."""

    def __init__(self, enabled, device):
        self.enabled = enabled
        self.cuda = enabled and torch.device(device).type == "cuda"
        self.events = {}
        self.host_s = {}
        self.counters = {}

    @contextmanager
    def span(self, name):
        if not self.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def host(self, name, seconds):
        if self.enabled:
            self.host_s.setdefault(name, []).append(seconds)

    def count(self, name, value):
        if self.enabled:
            self.counters.setdefault(name, []).append(value)

    def device_ms(self):
        """{span: [ms of each call]}, after a synchronize."""
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self.events.items()}


def _event_times(event):
    """(start_ns, duration_ns) of a profiler event, in the versions' forms."""
    if hasattr(event, "start_ns"):
        return event.start_ns(), event.duration_ns()
    return event.start_us() * 1000, event.duration_us() * 1000


def profile_calls(fn, calls, marks=None):
    """`calls` calls of fn() under torch.profiler with CUDA activity alone,
    ending in a synchronize.

    :param marks: optional list that fn appends (name, start_ns, end_ns)
        host-clock ranges (time.time_ns, the profiler's clock) to, naming
        what the host was doing
    :return: dict ops [(name, start_ns, duration_ns)] of the device's
        activities (kernels, copies, memsets) in start order, span_ns from the
        first call's start to the synchronize on the host clock, host_start_ns
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = _event_times(e)
        ops.append((e.name(), start, dur))
    ops.sort(key=lambda o: o[1])
    return {"ops": ops, "span_ns": t1 - t0, "host_start_ns": t0,
            "host_end_ns": t1, "marks": list(marks or [])}


def busy_ns(ops):
    """The union of the device activities' intervals, in ns."""
    total, end = 0, None
    for _, start, dur in ops:
        stop = start + dur
        if end is None or start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def top_ops(ops, n=10):
    """The device operations that took most time: [[name, seconds]]."""
    by_name = {}
    for name, _, dur in ops:
        by_name[name] = by_name.get(name, 0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(profile, n=10):
    """The longest idle gaps of the device, each named by the host range
    (`marks`) it falls in where the profiler's clock is the host's, else by
    the operation that ends it: [[name, seconds]]."""
    ops, marks = profile["ops"], profile["marks"]
    if not ops:
        return []
    gaps = []
    end = profile["host_start_ns"]
    aligned = (profile["host_start_ns"] <= ops[0][1]
               and ops[-1][1] <= profile["host_end_ns"])
    for name, start, dur in ops:
        if start > end:
            gaps.append((start - end, end, name))
        end = max(end, start + dur)
    if aligned and profile["host_end_ns"] > end:
        gaps.append((profile["host_end_ns"] - end, end, "synchronize"))
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, at, next_op in gaps[:n]:
        label = None
        if aligned:
            mid = at + length // 2
            for mark, m0, m1 in marks:
                if m0 <= mid <= m1:
                    label = f"host: {mark}"
            if label is None:
                label = "host: between marked ranges"
        else:
            label = f"before {next_op[:100]}"
        out.append([label, length / 1e9])
    return out
