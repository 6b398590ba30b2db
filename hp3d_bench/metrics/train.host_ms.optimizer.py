"""train.host_ms.optimizer: Host time inside the port's `optimizer` span
(Adam's `step()`) a profiled train step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.optimizer"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'optimizer', root='train.step')
