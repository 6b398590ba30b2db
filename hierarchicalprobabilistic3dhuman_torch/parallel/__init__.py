from hierarchicalprobabilistic3dhuman_torch.parallel.mesh import (
    Mesh, check_visible, distributed_init, free_port, make_mesh)
from hierarchicalprobabilistic3dhuman_torch.parallel.sharded_train import (
    data_parallel, gather_rows, make_sharded_apply, make_sharded_eval_step,
    make_sharded_train_step, shard_batch, sync_batchnorms)

__all__ = ["Mesh", "check_visible", "distributed_init", "free_port",
           "make_mesh", "data_parallel", "gather_rows", "make_sharded_apply",
           "make_sharded_eval_step", "make_sharded_train_step", "shard_batch",
           "sync_batchnorms"]
