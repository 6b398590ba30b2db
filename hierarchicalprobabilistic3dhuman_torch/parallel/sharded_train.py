"""Sharded train, eval and apply steps over a Mesh.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/parallel/
sharded_train.py (shard_batch :18, make_sharded_train_step :24,
make_sharded_eval_step :44, make_sharded_apply :53). Where JAX jits a step
with its inputs' shardings, the port's step runs on this rank's rows and
samples (the drivers' steps take the mesh) and these wrappers put the
collectives around it:

  * training: the predictor in torch's DistributedDataParallel, its
    BatchNorms synced over "data" (models/resnet.py), the step's loss
    scaled so that DDP's average of the ranks' gradients is the global
    batch's gradient;
  * evaluation and apply: this rank's rows of the global batch in, the
    per-row outputs gathered back over "data" in row order.
"""

import torch

from hierarchicalprobabilistic3dhuman_torch.models.resnet import BatchNorm2d


def shard_batch(mesh, *tensors):
    """This rank's rows of each global-batch tensor."""
    return tuple(mesh.take_rows(t) for t in tensors)


def sync_batchnorms(model, mesh):
    """Make every BatchNorm2d of `model` normalise over the mesh's "data"
    axis in train mode (None: over its own batch again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync = mesh


def data_parallel(model, mesh):
    """The predictor in DistributedDataParallel over the world, its
    BatchNorms synced over "data". DDP broadcasts rank 0's parameters and
    buffers on construction, and the buffers again before each forward
    (the synced BatchNorms keep them equal anyway)."""
    from torch.nn.parallel import DistributedDataParallel
    sync_batchnorms(model, mesh)
    return DistributedDataParallel(model, device_ids=None)


def make_sharded_train_step(step, mesh, ddp=None):
    """Shard a train/TrainStep over `mesh`: the step takes this rank's rows
    and samples of the global batch, and its train split goes through the
    predictor's DDP (`ddp`, made here unless the steps that share the
    predictor pass theirs: one DDP per module).

    :return: the step, which now returns the global batch's loss, loss
        terms and metric sums on every rank
    """
    step.mesh = mesh
    if step.train:
        step.ddp = ddp if ddp is not None else data_parallel(step.model, mesh)
    return step


def gather_rows(mesh, tree):
    """Per-row tensors (in nested dicts) gathered over "data" in row order;
    0-d tensors, sums over this rank's rows and samples, summed over the
    world."""
    if isinstance(tree, dict):
        return {k: gather_rows(mesh, v) for k, v in tree.items()}
    if tree.dim() == 0:
        return mesh.all_reduce(tree.clone())
    return mesh.all_gather(tree, "data", dim=0)


def make_sharded_eval_step(step_fn, mesh):
    """Wrap an eval step built with the mesh (evaluate/
    make_eval_step(mesh=...), which splits the samples): the dataset batch
    in as the global batch, this rank's rows through the step, the outputs
    back in frame order on every rank.

    :param step_fn: fn(draws, *batch) -> dict, on this rank's rows
    """
    def step(draws, *batch):
        draws = None if draws is None else mesh.take_rows(draws)
        return gather_rows(mesh, step_fn(draws, *shard_batch(mesh, *batch)))

    return step


def make_sharded_apply(apply_fn, mesh):
    """Shard a per-row inference function over "data": this rank's rows in,
    every row's outputs (tensors or dicts of them) out on every rank."""
    def apply(x):
        return gather_rows(mesh, apply_fn(mesh.take_rows(x)))

    return apply
