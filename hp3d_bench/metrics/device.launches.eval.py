"""device.launches.eval: Device activities (kernels, copies, memsets) an
evaluation batch in the profile."""

from hp3d_bench.readers import launches_per_call

NAME = "device.launches.eval"
UNIT = "count"
LAYER = "device"
MOVES = "eval_frames_per_s"
SOURCE = "device_trace"


def read(layer):
    return launches_per_call(layer)
