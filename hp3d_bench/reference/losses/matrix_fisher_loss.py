"""Combined training loss: MF pose NLL + Gaussian shape NLL + MSE terms.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/losses/
matrix_fisher_loss.py (gaussian_nll :23, PoseMFShapeGaussianLoss :41): a
weighted sum of the matrix-Fisher NLL over the 23 body-joint rotations, the
diagonal-Gaussian NLL over SMPL betas, the MSE over visible 2D joints
(targets normalised to [-1, 1]), the MSE over global rotation matrices and
the MSEs over vertices and 3D joints. The visible-joint MSE selects with
`where`, not a multiplication: an invisible joint's target may be inf. It
selects the difference before squaring it, so that such a target gives a
zero gradient too (JAX's form, a `where` on the square, gives the same
value and, for an inf target, a NaN gradient).

On a parallel Mesh each rank computes its share of the global batch's
loss, so that the shares sum to it over the world and their gradients to
its gradient: the terms of the rows it holds, over the global batch's
count, and divided by the "sample" axis, whose ranks hold the same rows;
the 2D-joint term over the 2D-joint sets it holds (its samples, and the
mode's on sample index 0 alone), over the global batch's denominator: the
visible joints summed over "data", without a gradient through the sum
(JAX divides by sum(vis) of the global batch, :88-89).
"""

import math

import torch

from hp3d_bench.reference.ops.matrix_fisher import (
    matrix_fisher_nll)

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_nll(mean, log_std, target):
    """Elementwise diagonal-Gaussian NLL with scale exp(log_std)."""
    var = torch.exp(2.0 * log_std)
    return 0.5 * ((target - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)


def _reduce(x, reduction):
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError(f"Unsupported reduction {reduction}")


class PoseMFShapeGaussianLoss:
    """Stateless callable configured by a LOSS.STAGE* config node
    (REDUCTION, MF_OVERREG, WEIGHTS.{POSE, SHAPE, JOINTS2D, GLOB_ROTMATS,
    VERTS3D, JOINTS3D}); img_wh is the proxy size."""

    def __init__(self, loss_config, img_wh):
        self.cfg = loss_config
        self.img_wh = img_wh

    def __call__(self, target_dict, pred_dict, mesh=None, j2d_sets=None):
        """
        target_dict: pose_params_rotmats (B, 23, 3, 3), shape_params (B, nb),
            joints2D (B, K, 2) pixels, joints2D_vis (B, K) bool,
            glob_rotmats (B, 3, 3), verts (B, V, 3), joints3D (B, J, 3).
        pred_dict: pose_params_{F,U,S,V}, shape_mean, shape_log_std,
            joints2D (B, num_sets, K, 2) in [-1, 1], glob_rotmats, verts,
            joints3D.
        :param mesh: with a parallel Mesh, this rank's rows and 2D-joint
            sets of the global batch, whose 2D-joint sets number `j2d_sets`
        :return: (total loss, dict of the unweighted terms); with a mesh,
            this rank's shares of them
        """
        reduction = self.cfg.REDUCTION
        share = 1.0
        if mesh is not None:
            share = 1.0 / mesh.shape["sample"]
            if reduction == "mean":
                share /= mesh.shape["data"]
        pose_nll = _reduce(matrix_fisher_nll(
            pred_dict["pose_params_F"], pred_dict["pose_params_U"],
            pred_dict["pose_params_S"], pred_dict["pose_params_V"],
            target_dict["pose_params_rotmats"], overreg=self.cfg.MF_OVERREG),
            reduction)
        shape_nll = _reduce(gaussian_nll(
            pred_dict["shape_mean"], pred_dict["shape_log_std"],
            target_dict["shape_params"]).sum(dim=1), reduction)

        target_j2d = (2.0 * target_dict["joints2D"]) / self.img_wh - 1.0  # (B, K, 2)
        pred_j2d = pred_dict["joints2D"]                                  # (B, S, K, 2)
        vis = target_dict["joints2D_vis"].to(pred_j2d.dtype)              # (B, K)
        # Select before squaring: the backward of (pred - inf) ** 2 would
        # be 0 * inf = NaN even where the square is not taken.
        diff = pred_j2d - target_j2d[:, None]
        masked = torch.where(vis[:, None, :, None] > 0, diff,
                             torch.zeros_like(diff)) ** 2
        if reduction == "mean":
            num_vis = torch.sum(vis)
            if mesh is not None:
                num_vis = mesh.all_reduce(num_vis.detach().clone(), "data")
            sets = pred_j2d.shape[1] if j2d_sets is None else j2d_sets
            denom = torch.clamp(num_vis * sets * 2, min=1.0)
            joints2D_loss = torch.sum(masked) / denom
        else:
            joints2D_loss = torch.sum(masked)

        glob_loss = _reduce((pred_dict["glob_rotmats"]
                             - target_dict["glob_rotmats"]) ** 2, reduction)
        verts_loss = _reduce((pred_dict["verts"] - target_dict["verts"]) ** 2,
                             reduction)
        joints3D_loss = _reduce((pred_dict["joints3D"]
                                 - target_dict["joints3D"]) ** 2, reduction)

        if mesh is not None:
            pose_nll, shape_nll, glob_loss, verts_loss, joints3D_loss = (
                t * share for t in (pose_nll, shape_nll, glob_loss, verts_loss,
                                    joints3D_loss))
        W = self.cfg.WEIGHTS
        total = (pose_nll * W.POSE + shape_nll * W.SHAPE
                 + joints2D_loss * W.JOINTS2D + glob_loss * W.GLOB_ROTMATS
                 + verts_loss * W.VERTS3D + joints3D_loss * W.JOINTS3D)
        terms = {"pose_nll": pose_nll, "shape_nll": shape_nll,
                 "joints2D": joints2D_loss, "glob_rotmats": glob_loss,
                 "verts3D": verts_loss, "joints3D": joints3D_loss}
        return total, terms
