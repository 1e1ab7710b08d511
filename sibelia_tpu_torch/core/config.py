"""Simplification stage presets and stage-file parsing.

Capability parity with the reference presets (reference: src/util.cpp:52-87)
and the stage file format (reference: src/util.cpp:11-50). A stage is a pair
(k, min_branch_size): the de Bruijn vertex size and the bulge branch bound
used during one round of graph simplification.
"""
from __future__ import annotations

from dataclasses import dataclass, field


Stage = tuple[int, int]

PRESETS: dict[str, list[Stage]] = {
    "loose": [(30, 150), (100, 1000), (1000, 5000), (5000, 15000)],
    "fine": [(30, 150), (100, 500), (500, 1500)],
    "far": [(15, 120), (100, 500), (500, 1500)],
}


def read_stage_file(file_name: str) -> list[Stage]:
    """Parse a manual stage file: whitespace-separated token stream whose
    first integer is the stage count followed by count (k, minBranch) pairs.
    Validation mirrors reference src/util.cpp:11-50."""
    try:
        with open(file_name) as f:
            tokens = f.read().split()
    except OSError:
        raise RuntimeError("cannot open stage file")

    def next_int(it):
        try:
            return int(next(it))
        except (StopIteration, ValueError):
            raise RuntimeError("cannot read stage file")

    it = iter(tokens)
    count = next_int(it)
    if count < 0:
        raise RuntimeError("number of stages must be nonnegative")
    ret: list[Stage] = []
    for _ in range(count):
        try:
            k = int(next(it))
            d = int(next(it))
        except (StopIteration, ValueError):
            raise RuntimeError("too few records in the stage file")
        if k < 2:
            raise RuntimeError("vertex size in stage record must be at least 2")
        if d < 0:
            raise RuntimeError("minimum branch size in stage record must be nonnegative")
        ret.append((k, d))
    return ret


MAX_INPUT_SIZE = 1 << 30  # reference: src/common.h:52


@dataclass
class SibeliaConfig:
    """Full flag surface of the reference CLI (reference: src/sibelia.cpp:61-185)."""

    stages: list[Stage] = field(default_factory=lambda: PRESETS["loose"])
    min_block_size: int = 5000
    max_iterations: int = 4
    last_k: int | None = None       # --lastk (default derived)
    shared_only: bool = False        # -a
    in_ram: bool = False             # -r (no temp files; we never use temp files)
    no_blocks: bool = False          # --noblocks
    no_postprocess: bool = False     # --nopostprocess
    correct_boundaries: bool = False # --correctboundaries
    all_stages: bool = False         # --allstages
    gff: bool = False                # --gff
    graph_file: bool = False         # -g
    sequences_file: bool = False     # -q
    hierarchy_picture: bool = False  # -v
    out_dir: str = "."
    temp_dir: str = "."

    def resolved_last_k(self) -> int:
        if self.last_k is not None:
            return self.last_k
        last_stage_k = self.stages[-1][0] if self.stages else (1 << 31)
        return min(last_stage_k, self.min_block_size)

    def resolved_trim_k(self) -> int:
        trim_k = 1 << 31
        for k, _ in self.stages:
            trim_k = min(trim_k, k)
        return min(trim_k, self.min_block_size)
