"""predict.host_ms.pose_head: Host time inside the port's `pose_head` span (the
per-group MLPs and the Jacobi SVD) a profiled predict batch."""

from hp3d_bench.program_spans import host_ms

NAME = "predict.host_ms.pose_head"
UNIT = "ms"
LAYER = "pose-head SVD"
MOVES = "predict_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'pose_head', root='predict.core')
