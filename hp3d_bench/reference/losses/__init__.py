from hp3d_bench.reference.losses.matrix_fisher_loss import (
    PoseMFShapeGaussianLoss)

__all__ = ["PoseMFShapeGaussianLoss"]
