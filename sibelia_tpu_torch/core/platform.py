"""Device choice and run accounting for the PyTorch port.

Twin of ``sibelia_tpu/core/platform.py``.  The port runs on one CUDA
card; ``SIBELIA_TPU_TORCH_DEVICE`` selects ``cuda`` (the default) or
``cpu``, where every kernel wrapper takes its plain PyTorch version.
Asking for ``cuda`` without a card raises: the port never drops to the
CPU on its own.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from . import timings

# kernel name -> launches on the card; each wrapper adds one per launch
LAUNCHES: dict[str, int] = {}
# pairs in each gap batch the fast aligner closed, in order
GOTOH_FLUSHES: list[int] = []


def resolve_device() -> torch.device:
    """The device of this run, from ``SIBELIA_TPU_TORCH_DEVICE``."""
    name = os.environ.get("SIBELIA_TPU_TORCH_DEVICE", "cuda")
    if name not in ("cuda", "cpu"):
        raise RuntimeError(
            f"SIBELIA_TPU_TORCH_DEVICE={name!r}: expected 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SIBELIA_TPU_TORCH_DEVICE=cuda but torch.cuda.is_available() is "
            "false; set SIBELIA_TPU_TORCH_DEVICE=cpu to run the plain "
            "PyTorch versions on the CPU")
    return torch.device(name)


def card_free_bytes(device: torch.device) -> int | None:
    """What a card can give an allocation: its free memory and the
    caching allocator's reserved but unused bytes; None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


@contextmanager
def sync_wait(tag: str, n: int = 1):
    """A blocking copy between host and device (`n` of them) in the block:
    its seconds go to the span ``sync_wait``, its count to the counter
    ``syncs_<tag>``."""
    with timings.phase("sync_wait"):
        yield
    timings.add("syncs_" + tag, n)


def note_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def note_flush(pairs: int) -> None:
    GOTOH_FLUSHES.append(pairs)
    timings.add("gotoh_flushes", 1)
    timings.add("gotoh_pairs", pairs)


def reset_counts() -> None:
    LAUNCHES.clear()
    GOTOH_FLUSHES.clear()
