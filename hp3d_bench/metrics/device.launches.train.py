"""device.launches.train: Device activities (kernels, copies, memsets) a train
step in the profile."""

from hp3d_bench.readers import launches_per_call

NAME = "device.launches.train"
UNIT = "count"
LAYER = "device"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return launches_per_call(layer)
