"""train.host_ms.forward: Host time inside the port's `forward` span
(`TrainStep.forward_loss`: encoder, pose head, SMPL, samples, loss) a profiled
step."""

from hp3d_bench.program_spans import host_ms

NAME = "train.host_ms.forward"
UNIT = "ms"
LAYER = "train"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'forward', root='train.step')
