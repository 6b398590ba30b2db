"""device.idle.predict: Share of the profiled predict batches in which no
device activity ran."""

from hp3d_bench.readers import idle_percent

NAME = "device.idle.predict"
UNIT = "%"
LAYER = "device"
MOVES = "predict_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return idle_percent(layer)
