"""data.host_ms.next: Host time inside the port's `data.next` span
(`NativeBatchSampler.next`: the wait for the sampler's batch and its copy) a
profiled train step."""

from hp3d_bench.program_spans import host_ms

NAME = "data.host_ms.next"
UNIT = "ms"
LAYER = "input pipeline"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'data.next')
