"""train.host_ms.encoder: Host time inside the port's `encoder` span
(`PoseMFShapeGaussianNet.forward` around the image encoder's call) a profiled
train step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.encoder"
UNIT = "ms"
LAYER = "image encoder"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'encoder', root='train.step')
