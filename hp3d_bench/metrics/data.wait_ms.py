"""data.wait_ms: Host time to take the next batch from `NativeTrainLoader` and
enqueue its upload (`batch_to_device`), mean a step."""

from hp3d_bench.readers import host_mean_ms

NAME = "data.wait_ms"
UNIT = "ms"
LAYER = "input pipeline"
MOVES = "train_img_per_s"
SOURCE = "host_clock"


def read(layer):
    return host_mean_ms(layer, 'data.wait')
