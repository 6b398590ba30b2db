"""device.idle.train: Share of the profiled train steps in which no device
activity ran."""

from hp3d_bench.readers import idle_percent

NAME = "device.idle.train"
UNIT = "%"
LAYER = "device"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return idle_percent(layer)
