"""eval.host_syncs: The port's `host_syncs` counter (its deliberate blocking
reads: the LAPACK-sign SVD's loop tests, the outputs' fetch) summed over its
records, a profiled evaluation batch."""

from hp3d_bench.program_spans import counter

NAME = "eval.host_syncs"
UNIT = "count"
LAYER = "eval step"
MOVES = "eval_frames_per_s"
SOURCE = "program_counter"


def read(layer):
    return counter(layer, 'host_syncs')
