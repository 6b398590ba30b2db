"""mfu.eval: Model FLOPs of an evaluation batch (counts.eval_batch_flops) over
its mean span time times 67 TFLOP/s."""

from hp3d_bench.readers import mfu_percent

NAME = "mfu.eval"
UNIT = "%"
LAYER = "whole step"
MOVES = "eval_frames_per_s"
SOURCE = "program_span"


def read(layer):
    return mfu_percent(layer, 'eval.step')
