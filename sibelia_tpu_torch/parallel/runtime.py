"""Multi-process runtime of the port (twin of
``sibelia_tpu/parallel/runtime.py``).

  * ``init_distributed()`` starts ``torch.distributed`` from
    ``SIBELIA_TPU_COORD`` (host:port), ``SIBELIA_TPU_NPROCS`` and
    ``SIBELIA_TPU_PROC_ID``, so that N processes run one program: NCCL
    when the run's device is a card (each process takes
    ``cuda:{PROC_ID % device_count}``), gloo on the CPU.  It returns False,
    and starts nothing, when those are unset or name one process.
  * ``seq_mesh()`` is the flat mesh of the sharded enumeration over the
    group, one shard a process; ``host_chip_mesh()`` the ('host', 'chip')
    mesh, whose 'chip' axis is 1 wide since a process holds one shard.
    With no group up both are meshes of this process's devices.

A group that ``init_distributed`` started is destroyed at the process's
exit unless its caller destroyed it first: a gloo process that exits with
its group up can abort in the group's threads ("terminate called without
an active exception").

N processes on one machine test it without a cluster: gloo on the CPU
(tests/test_torch_multihost.py), NCCL on one or more cards.
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist

from ..core.platform import resolve_device, sync_wait
from .sharded import Mesh, _nbytes


def group_size() -> int:
    """The default process group's size, 0 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: torch.device | None = None) -> bool:
    """Join the process group.  Returns True when a multi-process run was
    started, False for a single-process run."""
    coordinator = coordinator or os.environ.get("SIBELIA_TPU_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("SIBELIA_TPU_NPROCS", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("SIBELIA_TPU_PROC_ID", "-1") or -1)
    if not coordinator or num_processes <= 1 or process_id < 0:
        return False
    device = resolve_device() if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    atexit.register(_destroy_at_exit, dist.group.WORLD)
    return True


def _destroy_at_exit(group) -> None:
    """Destroy the default group if it is still the one
    ``init_distributed`` started; nothing when it is gone already."""
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


class ProcessGroupMesh(Mesh):
    """One shard a process of the default group; collectives are the
    group's (gloo on the CPU, NCCL on cards)."""

    def __init__(self, axis_names=("seq",), shape=None):
        world = dist.get_world_size()
        self.rank = dist.get_rank()
        if dist.get_backend() == "nccl":
            count = torch.cuda.device_count()
            devices = [torch.device("cuda", r % count) for r in range(world)]
            devices[self.rank] = torch.device("cuda",
                                              torch.cuda.current_device())
        else:
            devices = [torch.device("cpu")] * world
        super().__init__(devices, axis_names, shape)

    def local_shards(self) -> list[int]:
        return [self.rank]

    def ppermute(self, xs, shift):
        (x,) = xs
        n = self.size
        if n == 1:
            return [x.clone()]
        recv = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), (self.rank - shift) % n),
               dist.P2POp(dist.irecv, recv, (self.rank + shift) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.exchanged_bytes += _nbytes(x)
        return [recv]

    def all_to_all(self, xs, counts):
        (x,), (c,) = xs, counts
        recv_counts = torch.empty_like(c)
        dist.all_to_all_single(recv_counts, c.contiguous())
        with sync_wait("enum_scalar"):
            both = torch.cat([c, recv_counts]).tolist()
        send, got = both[:self.size], both[self.size:]
        out = x.new_empty((sum(got),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes=got,
                               input_split_sizes=send)
        row = _nbytes(x) // max(x.shape[0], 1)
        self.exchanged_bytes += row * (sum(send) - send[self.rank])
        return [out]

    def all_gather(self, xs):
        (x,) = xs
        sizes = [torch.zeros(1, dtype=torch.int64, device=x.device)
                 for _ in range(self.size)]
        dist.all_gather(sizes, torch.tensor([x.shape[0]], device=x.device))
        with sync_wait("enum_scalar"):
            sizes = torch.cat(sizes).tolist()
        top = max(sizes)
        pad = x.new_zeros((top,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(parts, pad)
        self.exchanged_bytes += _nbytes(x) * (self.size - 1)
        return [torch.cat([p[:m] for p, m in zip(parts, sizes)])]

    def gather_first(self, xs):
        return self.all_gather(xs)[0]

    def psum(self, xs):
        return self._all_reduce(xs, dist.ReduceOp.SUM)

    def pmax(self, xs):
        return self._all_reduce(xs, dist.ReduceOp.MAX)

    def _all_reduce(self, xs, op):
        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, op)
        self.exchanged_bytes += _nbytes(x)
        return [out]

    def gather_objects(self, objs):
        (obj,) = objs
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def seq_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    """The flat mesh of the sharded enumeration: the process group's, one
    shard a process, when a group is up; else ``make_mesh(n_devices)``."""
    if group_size():
        if n_devices not in (None, group_size()):
            raise RuntimeError(f"a mesh of {n_devices} shards asked for in a "
                               f"process group of {group_size()}")
        return ProcessGroupMesh((axis,))
    from .sharded import make_mesh
    return make_mesh(n_devices, axis)


def host_chip_mesh() -> Mesh:
    """The ('host', 'chip') mesh: (processes, 1) over the process group,
    (1, shards) over this process's devices when no group is up."""
    if group_size():
        return ProcessGroupMesh(("host", "chip"), (group_size(), 1))
    from .sharded import make_mesh
    flat = make_mesh()
    return Mesh(flat.devices, ("host", "chip"), (1, flat.size))
