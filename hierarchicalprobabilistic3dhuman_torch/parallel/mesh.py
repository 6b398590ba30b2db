"""The ranks of a run on a ("data", "sample") grid, and the collectives
between them.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/parallel/mesh.py
(make_mesh :26, data_sharding :45, sample_sharding :54,
flat_sample_sharding :60, constrain :69, distributed_init :76). JAX runs a
sharded step as one global computation and XLA inserts the collectives;
the port runs one process per device (a rank of torch.distributed) and
says where each collective goes. Its N-rank result on a global batch is
its own 1-rank result on that batch, within float32 reduction order:

  * "data": each rank holds B / data rows of the global batch (`rows`);
  * "sample": the N distribution samples of each row split into `sample`
    near-equal parts, as torch.tensor_split splits them (`samples`), so
    N = 50 over 4 ranks is 13 / 13 / 12 / 12.

Rank r sits at (r // sample, r % sample), the JAX grid's
reshape(n // sample, sample). The data group of a rank is the ranks of its
sample index (together they hold every row once); its sample group is the
ranks of its row slice. The collectives are all_reduce (a sum) and
broadcast only, the two that gloo runs on CUDA tensors as well as NCCL
does: an all-gather is the sum of zero buffers each filled with one rank's
part. So one code path serves gloo on the CPU, gloo with several ranks on
one card, and NCCL with one rank a card. A collective over a group of one
rank is skipped, which keeps such a group's arithmetic that of the 1-rank
code; the world group always communicates.
"""

import socket

import torch
import torch.distributed as dist


def free_port():
    """A TCP port of localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_devices(device_type):
    """Devices a run may spread over: the CUDA devices torch sees, or, on
    the CPU, any number (each rank is a process on the same CPU)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return None


def check_visible(n_local, device_type):
    """Raise unless `n_local` devices of `device_type` are visible (JAX's
    make_mesh quietly takes fewer, :33-34)."""
    n_visible = visible_devices(device_type)
    if n_visible is not None and n_local > n_visible:
        raise RuntimeError(
            f"{n_local} {device_type} devices were asked for but torch sees "
            f"{n_visible}; the port does not run on fewer devices than asked")


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, backend="gloo", local_devices=1,
                     local_rank=0):
    """Join the run's process group: rank process_id * local_devices +
    local_rank of num_processes * local_devices, through
    init_process_group(init_method="tcp://<coordinator_address>").

    A single process (no coordinator, num_processes None or 1, one local
    device) is a no-op, as in JAX :84; so is a second call. The backend is
    the caller's choice (nccl on the card, gloo on the CPU or for several
    ranks on one card); nothing switches it when it fails.

    :return: True if this call initialised the process group
    """
    if (coordinator_address is None and num_processes in (None, 1)
            and local_devices == 1):
        return False
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        raise ValueError("a run of several processes needs "
                         "--coordinator_address host:port")
    world = (num_processes or 1) * local_devices
    rank = (process_id or 0) * local_devices + local_rank
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def _split_sizes(n, parts):
    """torch.tensor_split's part sizes of n items in `parts`."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


class Mesh:
    """This rank's place on the ("data", "sample") grid, its device, and the
    process groups of its two axes."""

    def __init__(self, data, sample, rank, device, groups):
        self.shape = {"data": data, "sample": sample}
        self.size = data * sample
        self.rank = rank
        self.data_index, self.sample_index = divmod(rank, sample)
        self.device = torch.device(device)
        self._groups = groups       # axis -> process group, or None (one rank)
        # A mesh of one rank may stand without a process group.
        self._distributed = dist.is_initialized()

    @property
    def is_main(self):
        """Rank 0 alone writes checkpoints, logs, figures and outputs."""
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} at "
                f"({self.data_index}, {self.sample_index}), {self.device})")

    # ---- which part of a global tensor this rank holds ----

    def rows(self, n):
        """This rank's slice of a global batch of n rows (n must divide
        over "data", as JAX's drivers assert)."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"batch size {n} must divide the mesh data "
                             f"axis ({d})")
        b = n // d
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def sample_sizes(self, n):
        return _split_sizes(n, self.shape["sample"])

    def samples(self, n):
        """This rank's slice of n samples (tensor_split's, so the first
        n % sample ranks hold one more)."""
        sizes = self.sample_sizes(n)
        lo = sum(sizes[:self.sample_index])
        return slice(lo, lo + sizes[self.sample_index])

    def take_rows(self, x):
        """x[rows] for a tensor (or a dict of tensors) of a global batch."""
        if isinstance(x, dict):
            return {k: self.take_rows(v) for k, v in x.items()}
        return x[self.rows(x.shape[0])]

    # ---- collectives ----

    def group(self, axis):
        """The process group of `axis` ("data", "sample", or None for the
        world)."""
        return self._groups[axis] if axis is not None else None

    def axis_size(self, axis):
        return self.size if axis is None else self.shape[axis]

    def all_reduce(self, x, axis=None):
        """Sum x in place over the ranks of `axis` (None: the world);
        returns x."""
        if self.axis_size(axis) == 1 and (axis is not None
                                          or not self._distributed):
            return x
        dist.all_reduce(x, group=self.group(axis))
        return x

    def all_gather(self, x, axis, dim=0, sizes=None):
        """The parts of `axis`'s ranks concatenated along `dim`, in rank
        order: a zero buffer with this rank's part in place, summed.

        :param sizes: each rank's part size along `dim` (default: equal)
        """
        k = self.shape[axis]
        if k == 1:
            return x
        index = self.data_index if axis == "data" else self.sample_index
        sizes = sizes or [x.shape[dim]] * k
        if sizes[index] != x.shape[dim]:
            raise ValueError(f"part of {x.shape[dim]} where {sizes[index]} "
                             "was expected")
        shape = list(x.shape)
        shape[dim] = sum(sizes)
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, sum(sizes[:index]), sizes[index]).copy_(x)
        dist.all_reduce(full, group=self.group(axis))
        return full

    def broadcast(self, x, src=0):
        """x from world rank `src`, in place."""
        if self._distributed:
            dist.broadcast(x, src)
        return x

    def barrier(self):
        """Wait until every rank has come here (a one-element all-reduce,
        read back on the host)."""
        flag = torch.ones(1, device=self.device)
        self.all_reduce(flag)
        return float(flag)


def make_mesh(n_devices=None, sample_parallel=1, device=None):
    """The ("data", "sample") mesh of this process's rank.

    :param n_devices: ranks the mesh spans (default: the world); it must
        be the world's size, never fewer
    :param sample_parallel: size of the "sample" axis; "data" gets the rest
    :param device: this rank's device (default: cuda:<local index> when
        CUDA is available, else the CPU)
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else n_devices
    if n != world:
        raise RuntimeError(
            f"a mesh of {n} devices was asked for but the run has {world} "
            "ranks; the port does not run on fewer devices than asked")
    if n % sample_parallel:
        raise ValueError(f"{n} devices do not divide into sample axes of "
                         f"{sample_parallel}")
    data = n // sample_parallel
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if torch.cuda.is_available() else "cpu")
    # Every rank creates every group, in the same order (new_group's rule);
    # an axis of one rank has none.
    groups = {"data": None, "sample": None}
    if data > 1:
        for s in range(sample_parallel):
            g = dist.new_group([d * sample_parallel + s for d in range(data)])
            if rank % sample_parallel == s:
                groups["data"] = g
    if sample_parallel > 1:
        for d in range(data):
            g = dist.new_group([d * sample_parallel + s
                                for s in range(sample_parallel)])
            if rank // sample_parallel == d:
                groups["sample"] = g
    return Mesh(data, sample_parallel, rank, device, groups)
