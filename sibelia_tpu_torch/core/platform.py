"""Device choice and run accounting for the PyTorch port.

Twin of ``sibelia_tpu/core/platform.py``.  The port runs on one CUDA
card; ``SIBELIA_TPU_TORCH_DEVICE`` selects ``cuda`` (the default) or
``cpu``, where every kernel wrapper takes its plain PyTorch version.
Asking for ``cuda`` without a card raises: the port never drops to the
CPU on its own.
"""
from __future__ import annotations

import os

import torch

# ``SIBELIA_TPU_COUNT_SYNCS=1``: blocking host<->device transfers by tag
SYNC_COUNTS: dict[str, int] = {}
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


def note_sync(tag: str, n: int = 1) -> None:
    if os.environ.get("SIBELIA_TPU_COUNT_SYNCS") == "1":
        SYNC_COUNTS[tag] = SYNC_COUNTS.get(tag, 0) + n


def note_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def note_flush(pairs: int) -> None:
    GOTOH_FLUSHES.append(pairs)


def reset_counts() -> None:
    SYNC_COUNTS.clear()
    LAUNCHES.clear()
    GOTOH_FLUSHES.clear()
