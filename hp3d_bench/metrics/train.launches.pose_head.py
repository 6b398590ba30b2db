"""train.launches.pose_head: Device activities of the profile that start while
the host is inside the port's `pose_head` span, a profiled train step."""

from hp3d_bench.program_spans import launches

NAME = "train.launches.pose_head"
UNIT = "count"
LAYER = "pose-head SVD"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return launches(layer, 'pose_head', root='train.step')
