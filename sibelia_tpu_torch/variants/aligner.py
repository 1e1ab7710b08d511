"""Anchored pairwise / progressive alignment engine (port of
``sibelia_tpu/variants/aligner.py``).

Replacement for the vendored LAGAN toolkit (reference: src/lagan/ — chaos
seeding via threaded trie + skiplist chaining, then `order`'s anchored
banded Needleman-Wunsch; driven by lagan.pl/mlagan for C-Sibelia's block
alignment, C-Sibelia.py:279-292).

Anchors are unique shared k-mers, chained by longest-increasing
subsequence; the inter-anchor gaps are closed with affine-gap global
alignment (Gotoh) using LAGAN's substitution matrix and gap parameters
(``scoring.py``).  Gap subproblems are independent, so they batch: every
inter-anchor gap with both sides in 1..DEVICE_BATCH_T bytes is deferred into
a ``GapBatcher``, which closes the batch with
``kernels/gotoh.py::batch_align`` on its device when the alignment that
collected it ends (twin of ``_DeviceGapBatcher``).  An alignment nested
inside a large gap defers into the same batcher and flushes it when it ends,
as the JAX nesting does.  The batcher is passed down explicitly, where the
JAX module keeps it in a module global set by ``device_gap_batching``.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

from ..core import timings
from ..core.platform import note_flush
from ..kernels.gotoh import batch_align
from .scoring import _SM, GAP_EXTEND, GAP_OPEN

# traceback state preference on exact score ties (0=M diag, 1=Ix up-gap,
# 2=Iy left-gap); tuned against lagan.pl's anchored DP on real block pairs
_TRACE_PREF = (0, 1, 2)


def _gotoh(a: bytes, b: bytes) -> tuple[str, str]:
    """Affine-gap global alignment; returns aligned rows with '-' gaps.
    Its seconds go to the span ``host_gotoh``."""
    with timings.phase("host_gotoh"):
        return _gotoh_rows(a, b)


def _gotoh_rows(a: bytes, b: bytes) -> tuple[str, str]:
    n, m = len(a), len(b)
    if n == 0:
        return "-" * m, b.decode()
    if m == 0:
        return a.decode(), "-" * n
    NEG = -(1 << 30)
    aa = np.frombuffer(a, dtype=np.uint8)
    bb = np.frombuffer(b, dtype=np.uint8)
    sub = _SM[aa[:, None], bb[None, :]]
    M = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    Ix = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in b (up moves)
    Iy = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in a (left moves)
    M[0, 0] = 0
    for i in range(1, n + 1):
        Ix[i, 0] = GAP_OPEN + GAP_EXTEND * i
    for j in range(1, m + 1):
        Iy[0, j] = GAP_OPEN + GAP_EXTEND * j
    # anti-diagonal vectorization
    for d in range(1, n + m + 1):
        i = np.arange(max(1, d - m), min(n, d) + 1)
        j = d - i
        ok = (j >= 1) & (j <= m)
        i, j = i[ok], j[ok]
        if i.size:
            best_prev = np.maximum(np.maximum(M[i - 1, j - 1], Ix[i - 1, j - 1]),
                                   Iy[i - 1, j - 1])
            M[i, j] = best_prev + sub[i - 1, j - 1]
            Ix[i, j] = np.maximum(M[i - 1, j] + GAP_OPEN + GAP_EXTEND,
                                  Ix[i - 1, j] + GAP_EXTEND)
            Iy[i, j] = np.maximum(M[i, j - 1] + GAP_OPEN + GAP_EXTEND,
                                  Iy[i, j - 1] + GAP_EXTEND)
        # handle j == 0 or i == 0 borders already initialized
    # traceback; _TRACE_PREF is the state preference order on score ties
    out_a: list[str] = []
    out_b: list[str] = []
    i, j = n, m

    def pick(vals):
        best = _TRACE_PREF[0]
        for s in _TRACE_PREF[1:]:
            if vals[s] > vals[best]:
                best = s
        return best

    state = pick([M[n, m], Ix[n, m], Iy[n, m]])
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            prev = [M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1]]
            out_a.append(chr(aa[i - 1]))
            out_b.append(chr(bb[j - 1]))
            i -= 1
            j -= 1
            state = pick(prev)
        elif state == 1 and i > 0:
            out_a.append(chr(aa[i - 1]))
            out_b.append("-")
            if Ix[i, j] == M[i - 1, j] + GAP_OPEN + GAP_EXTEND:
                state = 0
            i -= 1
        elif state == 2 and j > 0:
            out_a.append("-")
            out_b.append(chr(bb[j - 1]))
            if Iy[i, j] == M[i, j - 1] + GAP_OPEN + GAP_EXTEND:
                state = 0
            j -= 1
        else:
            # border fallback
            if i > 0:
                out_a.append(chr(aa[i - 1]))
                out_b.append("-")
                i -= 1
            else:
                out_a.append("-")
                out_b.append(chr(bb[j - 1]))
                j -= 1
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def _unique_kmer_positions(s: bytes, k: int) -> dict[bytes, int]:
    seen: dict[bytes, int] = {}
    dup = set()
    for i in range(len(s) - k + 1):
        km = s[i:i + k]
        if km in dup:
            continue
        if km in seen:
            del seen[km]
            dup.add(km)
        else:
            seen[km] = i
    return seen


def _chain_anchors(pairs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Longest chain with strictly increasing coordinates on both axes
    (weight = 1 per anchor), via patience-LIS on the second coordinate."""
    if not pairs:
        return []
    pairs.sort()
    tails: list[int] = []
    tails_idx: list[int] = []
    parent = [-1] * len(pairs)
    for idx, (_, y) in enumerate(pairs):
        at = bisect.bisect_left(tails, y)
        if at == len(tails):
            tails.append(y)
            tails_idx.append(idx)
        else:
            tails[at] = y
            tails_idx[at] = idx
        parent[idx] = tails_idx[at - 1] if at > 0 else -1
    chain = []
    cur = tails_idx[-1]
    while cur != -1:
        chain.append(pairs[cur])
        cur = parent[cur]
    chain.reverse()
    return chain


_MAX_DP_AREA = 1 << 24  # ~16M cells for a single Gotoh subproblem
DEVICE_BATCH_T = 128


class _GapSlot:
    """The rows of one deferred gap, filled in by GapBatcher.flush."""

    rows = ("", "")


class GapBatcher:
    """Gap subproblems deferred during anchored alignment, closed in one
    batch on `device` (the kernel on a card, its plain version on the
    CPU); the rows equal the host Gotoh's."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pairs: list[tuple[bytes, bytes]] = []
        self.slots: list[_GapSlot] = []

    def defer(self, a: bytes, b: bytes) -> _GapSlot:
        slot = _GapSlot()
        self.pairs.append((a, b))
        self.slots.append(slot)
        return slot

    def flush(self) -> None:
        """Closes the deferred gaps (the span ``gap_batch``)."""
        if not self.pairs:
            return
        with timings.phase("gap_batch"):
            results = batch_align(self.pairs, DEVICE_BATCH_T, self.device)
        note_flush(len(self.pairs))
        for slot, rows in zip(self.slots, results):
            slot.rows = rows
        self.pairs = []
        self.slots = []


def _align_gap(a: bytes, b: bytes, depth: int = 0,
               batcher: GapBatcher | None = None) -> tuple[str, str]:
    if (len(a) == 0 or len(b) == 0
            or (len(a) + 1) * (len(b) + 1) <= _MAX_DP_AREA):
        return _gotoh(a, b)
    if depth < 3:
        k = (12, 10, 8)[depth]
        return align_pair(a, b, k=k, _depth=depth + 1, batcher=batcher)
    # band fallback: chop the longer side to keep memory bounded
    half = _MAX_DP_AREA // max(len(a) + 1, len(b) + 1)
    ra1, rb1 = _gotoh(a[:half], b[:half])
    ra2, rb2 = _align_gap(a[half:], b[half:], depth + 1, batcher)
    return ra1 + ra2, rb1 + rb2


def _align_gap_maybe_defer(a: bytes, b: bytes, depth: int,
                           batcher: GapBatcher | None):
    if (batcher is not None and 0 < len(a) <= DEVICE_BATCH_T
            and 0 < len(b) <= DEVICE_BATCH_T):
        slot = batcher.defer(a, b)
        return slot, slot
    return _align_gap(a, b, depth, batcher)


def align_pair(a: bytes, b: bytes, k: int = 16, _depth: int = 0,
               batcher: GapBatcher | None = None) -> tuple[str, str]:
    """Anchored global alignment of two sequences; returns aligned rows.
    With a batcher, the small inter-anchor gaps are closed in one batch
    when this alignment ends."""
    if isinstance(a, str):
        a = a.encode()
    if isinstance(b, str):
        b = b.encode()
    if (len(a) + 1) * (len(b) + 1) <= (1 << 20):
        return _gotoh(a, b)
    with timings.phase("anchoring"):
        ua = _unique_kmer_positions(a, k)
        ub = _unique_kmer_positions(b, k)
        shared = [(pa, ub[km]) for km, pa in ua.items() if km in ub]
        chain = _chain_anchors(shared)
        # merge chained anchors into exact-match runs; drop inconsistent
        # overlaps
        merged: list[tuple[int, int, int]] = []  # (pa, pb, length)
        for pa, pb in chain:
            if merged:
                la, lb, ln = merged[-1]
                if pa - la == pb - lb and pa - la <= ln:
                    merged[-1] = (la, lb, pa - la + k)
                    continue
                if pa < la + ln or pb < lb + ln:
                    continue  # overlapping inconsistently; skip anchor
            merged.append((pa, pb, k))
    rows_a: list = []
    rows_b: list = []
    ca = cb = 0
    for pa, pb, ln in merged:
        ga, gb = _align_gap_maybe_defer(a[ca:pa], b[cb:pb], _depth, batcher)
        rows_a.append(ga)
        rows_b.append(gb)
        rows_a.append(a[pa:pa + ln].decode())
        rows_b.append(b[pb:pb + ln].decode())
        ca, cb = pa + ln, pb + ln
    ga, gb = _align_gap_maybe_defer(a[ca:], b[cb:], _depth, batcher)
    rows_a.append(ga)
    rows_b.append(gb)
    if batcher is not None:
        batcher.flush()
        rows_a = [x.rows[0] if isinstance(x, _GapSlot) else x for x in rows_a]
        rows_b = [x.rows[1] if isinstance(x, _GapSlot) else x for x in rows_b]
    return "".join(rows_a), "".join(rows_b)


def align_multiple(seqs: list[bytes]) -> list[str]:
    """Progressive multiple alignment (mlagan capability): aligns each
    sequence against the growing consensus-free profile via its first row
    projection. Used for repeat-block MAF/XMFA output; its seconds go to
    the span ``multi_align``."""
    with timings.phase("multi_align"):
        return _align_multiple(seqs)


def _align_multiple(seqs: list[bytes]) -> list[str]:
    if not seqs:
        return []
    if len(seqs) == 1:
        return [seqs[0].decode() if isinstance(seqs[0], bytes) else seqs[0]]
    rows = [seqs[0] if isinstance(seqs[0], str) else seqs[0].decode()]
    for s in seqs[1:]:
        base = rows[0].replace("-", "").encode()
        new = s if isinstance(s, bytes) else s.encode()
        ra, rb = align_pair(base, new)
        # merge: walk the old alignment's columns and the (base, new)
        # alignment in lockstep; base chars == non-gap chars of rows[0]
        out_rows = [[] for _ in rows]
        out_new = []
        col = 0  # old alignment column
        n_cols = len(rows[0])

        def emit_old_col(c, new_ch):
            for r, orow in zip(rows, out_rows):
                orow.append(r[c])
            out_new.append(new_ch)

        for ch_a, ch_b in zip(ra, rb):
            if ch_a == "-":
                for orow in out_rows:
                    orow.append("-")
                out_new.append(ch_b)
            else:
                # flush old columns where rows[0] has a gap
                while col < n_cols and rows[0][col] == "-":
                    emit_old_col(col, "-")
                    col += 1
                emit_old_col(col, ch_b)
                col += 1
        while col < n_cols:
            emit_old_col(col, "-")
            col += 1
        rows = ["".join(r) for r in out_rows] + ["".join(out_new)]
    return rows
