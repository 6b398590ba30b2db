"""device.idle.eval: Share of the profiled evaluation batches in which no
device activity ran."""

from hp3d_bench.readers import idle_percent

NAME = "device.idle.eval"
UNIT = "%"
LAYER = "device"
MOVES = "eval_frames_per_s"
SOURCE = "device_trace"


def read(layer):
    return idle_percent(layer)
