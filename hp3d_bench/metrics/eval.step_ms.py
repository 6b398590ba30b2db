"""eval.step_ms: Device time of one `make_eval_step` step a batch with its host
fetch, mean over the window's batches."""

from hp3d_bench.readers import span_mean_ms

NAME = "eval.step_ms"
UNIT = "ms"
LAYER = "eval step"
MOVES = "eval_frames_per_s"
SOURCE = "program_span"


def read(layer):
    return span_mean_ms(layer, 'eval.step')
