"""device.idle_untraced.predict: Share of the profiled predict batches' device
idle time during which no span of the port is open: the idle put down to no
layer of the program."""

from hp3d_bench.program_spans import idle_untraced_percent

NAME = "device.idle_untraced.predict"
UNIT = "%"
LAYER = "device"
MOVES = "predict_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return idle_untraced_percent(layer)
