"""Mutable genome state as flat per-chromosome arrays.

Replaces the reference's unrolled doubly-linked list DNASequence
(reference: src/dnasequence.{h,cpp}, src/unrolledlist.h) with numpy arrays:

  chars[c]   uint8 ASCII bases of chromosome c (no separators stored)
  origpos[c] int32 "original position" metadata per element
             (the reference fits this in 30 bits of per-element meta,
              src/stranditerator.cpp:148-156; int32 covers the 1 GB
              input cap and halves the memory-story footprint)

A *strand position* is (strand, chr, pos) where pos is the positive-frame
index of the element a reference StrandIterator would point at. Advancing
on the negative strand decreases pos; reading on the negative strand
complements (reference: src/stranditerator.cpp:202-210).

Splicing (used by bulge collapse) replaces a positive-frame span with new
content; callers handle original-position interpolation (that logic lives
in graph/simplify.py next to the collapse protocol it belongs to,
mirroring reference src/dnasequence.cpp:189-252).
"""
from __future__ import annotations

import numpy as np

COMP_LUT = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ATGCatgc", b"TACGtacg"):
    COMP_LUT[a] = b


class _LazyIdentityPos(list):
    """List of identity position maps (np.arange) materialized on first
    read.  Writing a slot converts it to an ordinary list slot, so a
    caller that parks None there (native engine handoff) reads its None
    back instead of a fabricated arange."""

    def __init__(self, lens):
        super().__init__([None] * len(lens))
        self._lens = list(lens)

    def __getitem__(self, i):
        v = list.__getitem__(self, i)
        if v is None and self._lens[i] is not None:
            v = np.arange(self._lens[i], dtype=np.int32)
            list.__setitem__(self, i, v)
            self._lens[i] = None
        return v

    def __setitem__(self, i, v):
        self._lens[i] = None
        list.__setitem__(self, i, v)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class MutableSequence:
    def __init__(self, chromosomes: list[bytes | np.ndarray],
                 original_pos: list[np.ndarray] | None = None):
        # ndarray inputs are ADOPTED (no copy): callers hand over
        # ownership (BlockFinder rebinds its state from this object after
        # every stage, so sharing is safe and saves a full-genome copy
        # per stage); bytes inputs are copied into fresh arrays.
        self.chars: list[np.ndarray] = [
            c if isinstance(c, np.ndarray)
            else np.frombuffer(c, dtype=np.uint8).copy() for c in chromosomes
        ]
        if original_pos is None:
            # identity maps, materialized lazily on first read: the trim
            # mini-sequences (synteny.py) never touch origpos, and the
            # eager aranges were ~7 s of pure allocation over a
            # 16-strain run.  A slot written through __setitem__ becomes
            # an ordinary slot (the native engine parks None there
            # mid-handoff; fabricating an arange for it would be wrong).
            self.origpos = _LazyIdentityPos([len(c) for c in chromosomes])
        else:
            self.origpos = [np.ascontiguousarray(p, dtype=np.int32)
                            for p in original_pos]
        # original position recorded on the separator element after each
        # chromosome (reference: dnasequence.cpp:95-96) — the chromosome's
        # length at construction time.
        self.sep_origpos = [len(c) for c in chromosomes]

    @property
    def n_chr(self) -> int:
        return len(self.chars)

    def chr_len(self, c: int) -> int:
        return len(self.chars[c])

    def valid(self, c: int, pos: int) -> bool:
        return 0 <= pos < len(self.chars[c])

    def char_at(self, strand: int, c: int, pos: int) -> int:
        """Byte value as spelled on `strand` (0=positive, 1=negative)."""
        b = self.chars[c][pos]
        return int(COMP_LUT[b]) if strand else int(b)

    def origpos_at(self, c: int, pos: int) -> int:
        """Original position; pos == len(chr) reads the separator element."""
        if pos == len(self.chars[c]):
            return self.sep_origpos[c]
        return int(self.origpos[c][pos])

    def spell(self, strand: int, c: int, pos: int, length: int) -> bytes:
        """The `length` chars spelled from (strand, c, pos) forward."""
        if strand == 0:
            return self.chars[c][pos:pos + length].tobytes()
        seg = self.chars[c][pos - length + 1:pos + 1]
        return COMP_LUT[seg][::-1].tobytes()

    def splice(self, c: int, start: int, stop: int, new_chars: np.ndarray) -> None:
        """Replace chars[c][start:stop] with new_chars; origpos over the new
        span is zero-filled (caller interpolates)."""
        self.chars[c] = np.concatenate(
            [self.chars[c][:start], new_chars, self.chars[c][stop:]])
        self.origpos[c] = np.concatenate(
            [self.origpos[c][:start],
             np.zeros(len(new_chars), dtype=np.int32),
             self.origpos[c][stop:]])

    def to_strings(self) -> list[bytes]:
        return [c.tobytes() for c in self.chars]
