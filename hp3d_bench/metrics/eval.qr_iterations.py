"""eval.qr_iterations: Bidiagonal QR iterations of the LAPACK-sign head a step
(`svd3x3_gesdd.iterations`); each is one host sync."""

from hp3d_bench.readers import counter_mean

NAME = "eval.qr_iterations"
UNIT = "count"
LAYER = "pose-head SVD"
MOVES = "eval_frames_per_s"
SOURCE = "program_counter"


def read(layer):
    return counter_mean(layer, 'eval.qr_iterations')
