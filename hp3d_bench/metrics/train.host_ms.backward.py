"""train.host_ms.backward: Host time inside the port's `backward` span (the
loss's `.backward()`) a profiled train step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.backward"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'backward', root='train.step')
