"""k1_roofline.train: K1's bound at the step's own tables
(counts.raster_bound_s) over K1's device time a call in the profile."""

from hp3d_bench.readers import k1_roofline_percent

NAME = "k1_roofline.train"
UNIT = "%"
LAYER = "kernels"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(layer):
    return k1_roofline_percent(layer)
