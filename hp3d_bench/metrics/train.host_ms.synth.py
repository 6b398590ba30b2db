"""train.host_ms.synth: Host time inside the port's `synth` span (the synthetic
stage of `TrainStep.__call__`) a profiled step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.synth"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'synth', root='train.step')
