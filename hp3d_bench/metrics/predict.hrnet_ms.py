"""predict.hrnet_ms: Device time of `make_hrnet_batch_predictor`'s call on a
batch of 8, mean over the window's batches."""

from hp3d_bench.readers import span_mean_ms

NAME = "predict.hrnet_ms"
UNIT = "ms"
LAYER = "HRNet keypoints"
MOVES = "predict_img_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'predict.hrnet')
