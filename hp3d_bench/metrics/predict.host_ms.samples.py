"""predict.host_ms.samples: Host time inside the port's `samples` span
(`compute_vertex_uncertainties_by_sampling`: 50 samples, their SMPL and the
per-vertex spread) a profiled predict batch."""

from hp3d_bench.program_spans import host_ms

NAME = "predict.host_ms.samples"
UNIT = "ms"
LAYER = "predict core"
MOVES = "predict_img_per_s"
SOURCE = "program_span"


def read(layer):
    return host_ms(layer, 'samples', root='predict.core')
