"""train.encoder_ms: Device time of the image encoder's forward and backward
a train step: CUDA events at the encoder's forward's start and end, at the
start of its backward (its output's gradient) and at its last parameter's
gradient (paths/train_vit.py::EncoderEvents), mean over the window's steps."""

from hp3d_bench.readers import span_mean_ms

NAME = "train.encoder_ms"
UNIT = "ms"
LAYER = "image encoder"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'train.encoder')
