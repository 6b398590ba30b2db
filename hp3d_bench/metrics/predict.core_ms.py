"""predict.core_ms: Device time of `make_predict_core(render_vis=False)`'s call
on a batch of 8, mean over the window's batches."""

from hp3d_bench.readers import span_mean_ms

NAME = "predict.core_ms"
UNIT = "ms"
LAYER = "predict core"
MOVES = "predict_img_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'predict.core')
