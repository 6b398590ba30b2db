"""mfu.train: Model FLOPs of a train step (counts.train_step_flops) over its
mean span time times 67 TFLOP/s."""

from hp3d_bench.readers import mfu_percent

NAME = "mfu.train"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return mfu_percent(layer, 'train.step')
