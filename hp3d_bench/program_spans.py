"""The port's own spans and counters (runtime/profiling.py's recorder) in a
traced run's profiled calls, joined with the profile's device activities on
the clock both are stamped on (time.time_ns).

The per-layer readers of metrics/ that read them call here with the run's
record (`layer`): its `profile` ([host_start_ns, host_end_ns] of the
profiled calls, and their device activities) and `profile_calls`. A
program without the recorder, or a run with no records of the kind asked
for, gives None: the metric is then left out of the result line.
"""

import bisect

# The profile's device clock agrees with the host's time.time_ns to within
# CLOCK_NS (the port's `cuda` test of its spans holds a kernel to it). An
# activity further outside the profiled calls is a record the profiler got
# wrong, and is left out; where more than STRAY_SHARE of them are, the
# profile's clock is not the host's, and nothing is joined.
CLOCK_NS = 1_000_000
STRAY_SHARE = 0.01


def records(layer):
    """The program's records that start and end inside the profiled calls,
    or None where there are none to read."""
    prof = layer.get("profile")
    if not prof:
        return None
    try:
        from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import (
            spans_between)
    except ImportError:
        return None
    recs = spans_between(prof["host_start_ns"], prof["host_end_ns"])
    return recs or None


def named(recs, name, root=None):
    """The records called `name`, under a root span called `root` where
    given."""
    by_index = {r.index: r for r in recs}
    return [r for r in recs if r.name == name and (
        root is None or getattr(by_index.get(r.root), "name", None) == root)]


def host_ms(layer, name, root=None):
    """Host ms inside the spans called `name` (under `root`), a call."""
    recs = records(layer)
    spans = named(recs, name, root) if recs else None
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / layer["profile_calls"]


def launches(layer, name, root=None):
    """Device activities that start while the host is inside a span called
    `name` (under `root`), a call."""
    recs = records(layer)
    spans = named(recs, name, root) if recs else None
    if not spans:
        return None
    starts = [start for _, start, _ in layer["profile"]["ops"]]
    n = sum(bisect.bisect_right(starts, r.end_ns) - bisect.bisect_left(starts, r.start_ns)
            for r in spans)
    return n / layer["profile_calls"]


def counter(layer, name):
    """Counter `name` summed over the program's records, a call."""
    recs = records(layer)
    if not recs:
        return None
    return sum(r.counters.get(name, 0) for r in recs) / layer["profile_calls"]


def union(intervals):
    """Sorted disjoint [start, end) intervals covering the given ones."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        elif end > start:
            out.append([start, end])
    return out


def overlap_ns(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_untraced_percent(layer):
    """Share of the profiled calls' device idle time during which no
    program span is open, in %: the idle put down to no layer of the
    program. None where the profile's clock is not the host's (see
    CLOCK_NS) or the device never idled."""
    recs = records(layer)
    if not recs:
        return None
    prof = layer["profile"]
    t0, t1 = prof["host_start_ns"], prof["host_end_ns"]
    ops = [o for o in prof["ops"] if t0 - CLOCK_NS <= o[1] <= t1 + CLOCK_NS]
    if not ops or len(ops) < (1 - STRAY_SHARE) * len(prof["ops"]):
        return None
    window = [[t0, t1]]
    busy = union((max(s, t0), min(s + d, t1)) for _, s, d in ops)
    traced = union((r.start_ns, r.end_ns) for r in recs)
    idle = (t1 - t0) - overlap_ns(busy, window)
    if idle <= 0:
        return None
    idle_traced = overlap_ns(traced, window) - overlap_ns(traced, busy)
    return 100.0 * (idle - idle_traced) / idle
