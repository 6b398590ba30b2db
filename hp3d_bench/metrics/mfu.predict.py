"""mfu.predict: Model FLOPs of a predict batch (counts.predict_batch_flops)
over its mean span time (HRNet and core) times 67 TFLOP/s."""

from hp3d_bench.readers import mfu_percent

NAME = "mfu.predict"
UNIT = "%"
LAYER = "whole step"
MOVES = "predict_img_per_s"
SOURCE = "program_span"


def read(layer):
    return mfu_percent(layer, 'predict.batch')
