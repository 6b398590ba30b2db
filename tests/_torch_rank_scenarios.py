"""Rank scenarios of tests/test_torch_parallel.py: each runs in one rank of a
gloo group started by chip_smoke.run_ranks(module=<this file>), builds its
mesh and returns tensors for the test to hold against the 1-rank results.
Imports torch and the port only."""

import torch

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults)
from hierarchicalprobabilistic3dhuman_torch.losses import PoseMFShapeGaussianLoss
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.resnet import BatchNorm2d
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
from hierarchicalprobabilistic3dhuman_torch.parallel import (
    make_mesh, make_sharded_apply)


def batchnorm(x, upstream, weight, bias, mesh, sync):
    """A train-mode BatchNorm2d on this rank's rows, synced over `mesh`'s
    "data" axis (or, without `sync`, over its own rows only),
    back-propagating `upstream`; the affine gradients summed over "data"."""
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.sync = mesh if sync else None
    x = x.clone().requires_grad_(True)
    y = bn.train()(x)
    (y * upstream).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "w_grad": mesh.all_reduce(bn.weight.grad.clone(), "data"),
            "b_grad": mesh.all_reduce(bn.bias.grad.clone(), "data"),
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def basics(device, inputs):
    """The collectives of a (data, sample) mesh, the synced BatchNorm, the
    loss's global 2D-joint denominator and the sharded predictor forward,
    on a data-only mesh of the same ranks."""
    mesh = make_mesh(sample_parallel=inputs["sample_parallel"], device=device)
    flat = make_mesh(sample_parallel=1, device=device)
    n = inputs["num_samples"]
    sizes = mesh.sample_sizes(n)
    own = torch.arange(n, dtype=torch.float32)[mesh.samples(n)] + 100 * mesh.data_index
    out = {
        "rank": mesh.rank, "position": (mesh.data_index, mesh.sample_index),
        "gather_sample": mesh.all_gather(own[None].repeat(2, 1), "sample", dim=1,
                                         sizes=sizes),
        "gather_data": mesh.all_gather(torch.tensor([float(mesh.rank)]), "data"),
        "sum_world": mesh.all_reduce(torch.tensor([float(mesh.rank + 1)])),
        "sum_data": mesh.all_reduce(torch.tensor([float(mesh.rank + 1)]), "data"),
        "sum_sample": mesh.all_reduce(torch.tensor([float(mesh.rank + 1)]), "sample"),
    }

    bn = inputs["bn"]
    rows = flat.rows(bn["x"].shape[0])
    for name, sync in (("bn_synced", True), ("bn_local", False)):
        out[name] = batchnorm(bn["x"][rows], bn["upstream"][rows], bn["weight"],
                              bn["bias"], flat, sync)

    cfg = get_pose_shape_cfg_defaults()
    crit = PoseMFShapeGaussianLoss(cfg.LOSS.STAGE1, img_wh=inputs["img_wh"])
    target = flat.take_rows(inputs["target"])
    pred = flat.take_rows(inputs["pred"])
    total, terms = crit(target, pred, mesh=flat, j2d_sets=pred["joints2D"].shape[1])
    local_total, local_terms = crit(target, pred)
    out["loss_share"] = {"total": total, **terms}
    out["loss_local"] = {"total": local_total, **local_terms}

    model = PoseMFShapeGaussianNet(embed_dim=64)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out["apply"] = make_sharded_apply(model.eval(), flat)(inputs["proxy"])
    return out


RANK_SCENARIOS = {"basics": basics}
