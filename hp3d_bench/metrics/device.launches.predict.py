"""device.launches.predict: Device activities (kernels, copies, memsets) a
predict batch in the profile."""

from hp3d_bench.readers import launches_per_call

NAME = "device.launches.predict"
UNIT = "count"
LAYER = "device"
MOVES = "predict_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return launches_per_call(layer)
