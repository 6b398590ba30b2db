"""What the per-layer metrics' readers (metrics/<name>.py) share: they
read a traced run's record (`layer`: span times, host-clock readings,
counters, the profile of CUDA activity, the work counted from shapes) and
return a number, or None where the run has nothing to read.
"""

import re

from hp3d_bench import counts
from hp3d_bench.tracing import busy_ns


def span_mean_ms(layer, name):
    """Mean device time of a span's calls over the window, in ms."""
    times = layer.get("spans_ms", {}).get(name)
    return sum(times) / len(times) if times else None


def host_mean_ms(layer, name):
    times = layer.get("host_s", {}).get(name)
    return 1e3 * sum(times) / len(times) if times else None


def counter_mean(layer, name):
    values = layer.get("counters", {}).get(name)
    return sum(values) / len(values) if values else None


def idle_percent(layer):
    """100 x (1 - union of the device's activity / the profiled span)."""
    prof = layer.get("profile")
    if not prof or not prof["ops"]:
        return None
    return 100.0 * (1.0 - busy_ns(prof["ops"]) / prof["span_ns"])


def launches_per_call(layer):
    """Device activities (kernels, copies, memsets) per profiled call."""
    prof = layer.get("profile")
    if not prof or not prof["ops"]:
        return None
    return len(prof["ops"]) / layer["profile_calls"]


def mfu_percent(layer, span):
    """Model FLOPs of a call over (its mean span time x the float32 peak)."""
    ms = span_mean_ms(layer, span)
    flops = layer.get("flops_per_call")
    if not ms or not flops:
        return None
    return 100.0 * flops / (ms / 1e3 * counts.PEAK_F32_FLOPS)


# K1's kernels (csrc/rasterize.cu, in an anonymous namespace): the
# profiler names them "(anonymous namespace)::raster_faces(...)" and
# "void (anonymous namespace)::resolve<4>(...)".
K1_KERNEL = re.compile(
    r"(?:^|\s|\(anonymous namespace\)::)(?:raster_faces|resolve)\s*[<(]")


def is_k1(name):
    return K1_KERNEL.search(name) is not None


def k1_roofline_percent(layer):
    """K1's bound at the call's own tables over K1's device time a call
    (`raster_faces` + `resolve` in the profile)."""
    prof, bound = layer.get("profile"), layer.get("k1")
    if not prof or not bound:
        return None
    k1_ns = sum(dur for name, _, dur in prof["ops"] if is_k1(name))
    calls = layer["profile_calls"] * layer.get("k1_calls_per_step", 1)
    if k1_ns == 0:
        return None
    return 100.0 * bound["s"] / (k1_ns / 1e9 / calls)
