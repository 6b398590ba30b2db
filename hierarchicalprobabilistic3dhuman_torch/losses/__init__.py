from hierarchicalprobabilistic3dhuman_torch.losses.matrix_fisher_loss import (
    PoseMFShapeGaussianLoss)

__all__ = ["PoseMFShapeGaussianLoss"]
