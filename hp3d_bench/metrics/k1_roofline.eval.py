"""k1_roofline.eval: K1's bound for a step's two silhouette renders (mode and
samples, counts.raster_bound_s) over K1's device time a step."""

from hp3d_bench.readers import k1_roofline_percent

NAME = "k1_roofline.eval"
UNIT = "%"
LAYER = "kernels"
MOVES = "eval_frames_per_s"
SOURCE = "device_trace"


def read(layer):
    return k1_roofline_percent(layer)
