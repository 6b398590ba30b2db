"""encoder_roofline.train: The image encoder's FLOPs a train step (its
forward, and twice it for the backward, less the patch embedding's input
gradient: counts_vit.encoder_train_flops) over `train.encoder_ms` times 67
TFLOP/s, the float32 peak (counts.PEAK_F32_FLOPS)."""

from hp3d_bench import counts
from hp3d_bench.readers import span_mean_ms

NAME = "encoder_roofline.train"
UNIT = "%"
LAYER = "image encoder"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(layer):
    ms = span_mean_ms(layer, 'train.encoder')
    flops = layer.get("encoder_flops_per_call")
    if not ms or not flops:
        return None
    return 100.0 * flops / (ms / 1e3 * counts.PEAK_F32_FLOPS)
