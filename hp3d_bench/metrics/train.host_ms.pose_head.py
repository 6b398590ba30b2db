"""train.host_ms.pose_head: Host time inside the port's `pose_head` span (the
per-group MLPs and the Jacobi SVD, a child of `forward`) a profiled train step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.pose_head"
UNIT = "ms"
LAYER = "pose-head SVD"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'pose_head', root='train.step')
