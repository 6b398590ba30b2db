"""Start the ranks of a CLI run and hand each its mesh.

The counterpart of the JAX CLIs' device setup (cli/train.py:162-176,
cli/evaluate.py:115-128, cli/predict.py:194-202): JAX sees every local
device from one process; the port runs one process a device.

  * --num_devices N > 1 starts N local ranks with torch.multiprocessing,
    on cuda:0 .. cuda:N-1 (NCCL) or, with --device cpu, on the CPU (gloo);
    N more than torch sees raises;
  * --coordinator_address / --num_processes / --process_id (training) set
    the global world of num_processes x N ranks, rank process_id x N +
    the local rank; with one process and one device the run still goes
    through the process group and the mesh;
  * otherwise (one device, no coordinator) the CLI takes its plain
    single-device path, with no mesh.

Rank 0 prints; the others' standard output is dropped. What rank 0's run
returns comes back to the caller.
"""

import os
import pickle
import sys
import tempfile

import torch

from hierarchicalprobabilistic3dhuman_torch.parallel.mesh import (
    check_visible, distributed_init, free_port, make_mesh)


def local_devices(num_devices, device_type):
    """--num_devices, or its JAX default: every local device (the CUDA
    devices torch sees; one on the CPU)."""
    if num_devices is not None:
        return num_devices
    return torch.cuda.device_count() if device_type == "cuda" else 1


def world_size(args, device_type):
    """The ranks a CLI's flags ask for."""
    return ((getattr(args, "num_processes", None) or 1)
            * local_devices(args.num_devices, device_type))


def is_parallel(args, device_type):
    return (world_size(args, device_type) > 1
            or getattr(args, "coordinator_address", None) is not None)


def _rank(local_rank, run, args, coordinator, n_local, sample_parallel,
          result_path):
    device_type = torch.device(args.device).type
    device = torch.device(f"cuda:{local_rank}" if device_type == "cuda" else "cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    distributed_init(coordinator, getattr(args, "num_processes", None),
                     getattr(args, "process_id", None),
                     backend="nccl" if device_type == "cuda" else "gloo",
                     local_devices=n_local, local_rank=local_rank)
    mesh = make_mesh(sample_parallel=sample_parallel, device=device)
    if not mesh.is_main:
        sys.stdout = open(os.devnull, "w")
    try:
        result = run(args, mesh)
        if mesh.is_main and result_path is not None:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
        return result
    finally:
        torch.distributed.destroy_process_group()


def launch(run, args, sample_parallel=1):
    """Run `run(args, mesh)` on the ranks the flags ask for (see the module
    docstring), or `run(args, None)` on the plain path.

    :param sample_parallel: the "sample" axis (predict: every rank)
    :return: what rank 0's run returned (None on a process other than the
        one holding rank 0)
    """
    device_type = torch.device(args.device).type
    if not is_parallel(args, device_type):
        return run(args, None)
    n_local = local_devices(args.num_devices, device_type)
    check_visible(n_local, device_type)
    coordinator = getattr(args, "coordinator_address", None)
    if coordinator is None:
        if (getattr(args, "num_processes", None) or 1) > 1:
            raise ValueError("--num_processes > 1 needs --coordinator_address")
        coordinator = f"127.0.0.1:{free_port()}"
    if n_local == 1:
        return _rank(0, run, args, coordinator, 1, sample_parallel, None)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "result.pkl")
        mp.spawn(_rank, args=(run, args, coordinator, n_local, sample_parallel,
                              path), nprocs=n_local, join=True)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)
