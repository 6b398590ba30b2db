"""train.step_ms: Device time of one `TrainStep.__call__` (CUDA events around
the call), mean over the window's steps."""

from hp3d_bench.readers import span_mean_ms

NAME = "train.step_ms"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'train.step')
