"""train.host_ms.step: Host time inside the port's `train.step` span
(`TrainStep.__call__`) a profiled step: the denominator of the train stages'
shares."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.step"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'train.step')
