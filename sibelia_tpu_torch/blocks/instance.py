"""BlockInstance: one placed copy of a synteny block.

Reference: src/blockinstance.{h,cpp}. Coordinates are half-open 0-based
[start, end); "conventional" coordinates are 1-based and strand-dependent
(blockinstance.cpp:59-77).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..io.fasta import FASTARecord


@dataclass(frozen=True)
class BlockInstance:
    signed_id: int
    chr: FASTARecord
    start: int
    end: int

    @property
    def block_id(self) -> int:
        return abs(self.signed_id)

    @property
    def sign(self) -> int:
        return 1 if self.signed_id > 0 else -1

    @property
    def chr_id(self) -> int:
        return self.chr.id

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def conventional_start(self) -> int:
        return self.start + 1 if self.signed_id > 0 else self.end

    @property
    def conventional_end(self) -> int:
        return self.end if self.signed_id > 0 else self.start + 1
