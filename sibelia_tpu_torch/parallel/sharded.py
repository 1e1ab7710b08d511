"""Meshes of shards and their collectives (twin of ``make_mesh`` in
``sibelia_tpu/parallel/sharded.py``).

A ``Mesh`` is an ordered list of devices, one a shard, which may repeat
(four shards on ``cuda:0`` run one after another in this thread, each
kernel on its device's current stream), and an axis name.  Every shard of
a ``Mesh`` lives in this process.  ``ProcessGroupMesh`` (built by
``parallel/runtime.py``) holds one shard a process of a
``torch.distributed`` group, and its collectives are the group's.

The collectives are plain functions on lists of per-shard tensors, one
entry for each shard this process holds (``local_shards``), in that order:

  * ``ppermute(xs, shift)``: shard i receives shard (i + shift) mod n's
    tensor (the ring halo);
  * ``all_to_all(xs, counts)``: each shard sends its rows, ordered by
    destination, with the int64 count for each destination; each receives
    the rows sent to it, ordered by source;
  * ``all_gather(xs)``: the concatenation of every shard's tensor, in shard
    order, on each shard; ``gather_first`` on the first local shard only;
  * ``psum(xs)`` and ``pmax(xs)``: elementwise over equal shapes.

Exact split sizes take the place of the JAX package's fixed capacity and
overflow retry (``sibelia_tpu/parallel/sharded_enum.py``, ``_exchange`` and
the loop of ``enumerate_bifurcations_sharded``): the counts go first, then
exactly the rows, so nothing overflows and nothing is sent twice.  The
counts come to the host to cut the rows: one blocking copy an exchange,
counted by ``sync_wait`` as ``syncs_enum_scalar``.

``exchanged_bytes`` adds up the bytes that moved between shards (rows a
shard sends to itself are not counted).
"""
from __future__ import annotations

import os
import sys

import torch

from ..core.platform import resolve_device, sync_wait


class Mesh:
    """Shards on devices of this process."""

    def __init__(self, devices, axis_names=("seq",), shape=None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape else (len(self.devices),)
        self.exchanged_bytes = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> list[int]:
        return list(range(self.size))

    def ppermute(self, xs: list[torch.Tensor], shift: int
                 ) -> list[torch.Tensor]:
        n = self.size
        out = []
        for s in range(n):
            src = (s + shift) % n
            if src != s:
                self.exchanged_bytes += _nbytes(xs[src])
            out.append(xs[src].to(self.devices[s]))
        return out

    def all_to_all(self, xs: list[torch.Tensor], counts: list[torch.Tensor]
                   ) -> list[torch.Tensor]:
        n = self.size
        # one blocking copy for every shard's counts
        dev0 = self.devices[0]
        with sync_wait("enum_scalar"):
            splits = torch.stack([c.to(dev0) for c in counts]).tolist()
        parts = [x.split(sp) for x, sp in zip(xs, splits)]
        out = []
        for j in range(n):
            self.exchanged_bytes += sum(_nbytes(parts[i][j])
                                        for i in range(n) if i != j)
            out.append(torch.cat([parts[i][j].to(self.devices[j])
                                  for i in range(n)]))
        return out

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        out = []
        for s in range(self.size):
            self.exchanged_bytes += sum(_nbytes(x) for i, x in enumerate(xs)
                                        if i != s)
            out.append(torch.cat([x.to(self.devices[s]) for x in xs]))
        return out

    def gather_first(self, xs: list[torch.Tensor]) -> torch.Tensor:
        dev = self.devices[0]
        self.exchanged_bytes += sum(_nbytes(x) for x in xs[1:])
        return torch.cat([x.to(dev) for x in xs])

    def psum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(xs, torch.add)

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(xs, torch.maximum)

    def _reduce(self, xs, op) -> list[torch.Tensor]:
        dev0 = self.devices[0]
        acc = xs[0]
        for x in xs[1:]:
            self.exchanged_bytes += _nbytes(x)
            acc = op(acc, x.to(dev0))
        return [acc.to(d) for d in self.devices]

    def gather_objects(self, objs: list) -> list:
        """Every shard's object, in shard order (host objects)."""
        return list(objs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def make_mesh(n_devices: int | None = None, axis: str = "seq",
              device: torch.device | None = None) -> Mesh:
    """A flat mesh of n shards: the process group's mesh when a group of n
    ranks is up (as ``jax.devices()`` is global in the JAX package), else
    n CPU shards for a CPU run and ``cuda:0 .. cuda:n-1`` for a card run.
    Raises when the run's card count or group size cannot give n shards."""
    from . import runtime
    if runtime.group_size() > 1 or runtime.group_size() == n_devices:
        return runtime.seq_mesh(n_devices, axis)
    device = resolve_device() if device is None else torch.device(device)
    if device.type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), (axis,))
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise RuntimeError(f"make_mesh: {n} shards asked for, {count} cards")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def available_shards(device: torch.device) -> int:
    """How many shards a mesh of this run can have: the process group's
    size when one is up, the card count on a card, any number on the CPU
    (the counterpart of the tests' virtual devices)."""
    from . import runtime
    if runtime.group_size() > 1:
        return runtime.group_size()
    if torch.device(device).type == "cpu":
        return 1 << 30
    return torch.cuda.device_count()


_SAID: set = set()


def requested_mesh(device: torch.device | None, axis: str = "seq"
                   ) -> Mesh | None:
    """The mesh ``SIBELIA_TPU_SHARDED=N`` asks for (N > 1), or None.  With
    fewer than N shards available the single-device route runs, as the JAX
    package's ``len(jax.devices()) >= N`` gate does, and one line on stderr
    says so."""
    n = os.environ.get("SIBELIA_TPU_SHARDED")
    if not (n and n.isdigit() and int(n) > 1):
        return None
    n = int(n)
    device = resolve_device() if device is None else torch.device(device)
    have = available_shards(device)
    if have < n:
        if (n, have) not in _SAID:
            _SAID.add((n, have))
            print(f"SIBELIA_TPU_SHARDED={n}: {have} {device.type} "
                  f"device(s); the single-device route runs",
                  file=sys.stderr)
        return None
    return make_mesh(n, axis, device)
