"""device.idle_untraced.eval: Share of the profiled evaluation batches' device
idle time during which no span of the port is open: the idle put down to no
layer of the program."""

from hp3d_bench.program_spans import idle_untraced_percent

NAME = "device.idle_untraced.eval"
UNIT = "%"
LAYER = "device"
MOVES = "eval_frames_per_s"
SOURCE = "device_trace"


def read(layer):
    return idle_untraced_percent(layer)
