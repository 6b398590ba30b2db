"""PyTorch/CUDA port of the hierarchical probabilistic 3D human predictor.

Mirrors the subpackage layout of `hierarchicalprobabilistic3dhuman_tpu`
(configs, utils, ops, models, renderers, predict, cli) so each module has a
named counterpart there. The JAX package is the reference the port is held
against; this package imports neither JAX nor that package. The one
hand-written kernel, the z-buffer rasterizer, lives in `csrc/` and is built
with nvcc at first use (see `ops/rasterizer_cuda.py`).
"""
