"""eval.host_ms.pose_head: Host time inside the port's `pose_head` span (the
per-group MLPs and the LAPACK-sign SVD with its host syncs) a profiled
evaluation batch."""

from hp3d_bench.program_spans import host_ms

NAME = "eval.host_ms.pose_head"
UNIT = "ms"
LAYER = "pose-head SVD"
MOVES = "eval_frames_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'pose_head', root='eval.step')
