"""train.synth_ms: Device time of the synthetic stage (`TrainStep.synth`: SMPL,
pack_faces + K1 render, crops, augmentation, Canny, heatmaps), mean over the
window's steps."""

from hp3d_bench.readers import span_mean_ms

NAME = "train.synth_ms"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'train.synth')
