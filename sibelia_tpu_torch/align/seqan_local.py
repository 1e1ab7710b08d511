"""Exact replica of SeqAn 1.3.1 localAlignment (SmithWaterman tag).

Used by boundary correction (reference: src/postprocessor.cpp:257-277 with
Score<int>(25, -75, -75)). The SeqAn implementation (vendored at
reference src/include/seqan/align/align_local_dynprog.h) has several
non-standard behaviors that the reference's output depends on, all
replicated here:

  * the matrix is filled over SUFFIXES (backward), so the best cell is
    the alignment's BEGIN; traceback runs forward
  * on matching characters the recurrence takes the diagonal
    unconditionally: M[i][j] = M[i+1][j+1] + match (no gap choice,
    no zero clamp)
  * on mismatch: M = max(0, diag + mismatch, gap + max(right, down))
  * best cell: maximum value; ties resolved to the cell pushed first
    into SeqAn's binary heap == largest j (str2 pos), then largest i
    (fill order is j descending, i descending; sift-up only moves
    strictly-less parents, so the first-pushed maximum stays on top)
  * if the best score is 0 the alignment is left untouched: clipped
    positions remain (0, len) for both rows
  * traceback: on match forced diagonal; else with v = M[i+1][j] + gap,
    d = M[i+1][j+1] + mismatch, h = M[i][j+1] + gap:
    go-down = (v >= h) | (d >= h), go-right = (h > v) | (d >= v);
    stops at a zero cell or when either sequence is exhausted
"""
from __future__ import annotations

import numpy as np

MATCH = 25
MISMATCH = -75
GAP = -75


def _fill_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Suffix-based SW matrix, shape (len(a)+1, len(b)+1)."""
    n0, n1 = len(a), len(b)
    M = np.zeros((n0 + 1, n1 + 1), dtype=np.int64)
    # anti-diagonal wavefront from the bottom-right corner
    # diagonal d = i0 + i1, processed descending
    eq = a[:, None] == b[None, :]
    for d in range(n0 + n1 - 2, -1, -1):
        i0_lo = max(0, d - (n1 - 1))
        i0_hi = min(n0 - 1, d)
        i0 = np.arange(i0_lo, i0_hi + 1)
        i1 = d - i0
        diag = M[i0 + 1, i1 + 1]
        right = M[i0, i1 + 1]
        down = M[i0 + 1, i1]
        m = eq[i0, i1]
        mis = np.maximum(np.maximum(diag + MISMATCH,
                                    GAP + np.maximum(right, down)), 0)
        M[i0, i1] = np.where(m, diag + MATCH, mis)
    return M


def seqan_local_alignment(s1: bytes, s2: bytes):
    """Return (begin0, end0, begin1, end1, score) with SeqAn semantics."""
    a = np.frombuffer(s1, dtype=np.uint8)
    b = np.frombuffer(s2, dtype=np.uint8)
    n0, n1 = len(a), len(b)
    if n0 == 0 or n1 == 0:
        return 0, n0, 0, n1, 0
    M = _fill_matrix(a, b)
    core = M[:n0, :n1]
    best = int(core.max()) if core.size else 0
    if best <= 0:
        return 0, n0, 0, n1, 0
    # tie-break: largest i1, then largest i0
    cand = np.argwhere(core == best)
    order = np.lexsort((cand[:, 0], cand[:, 1]))  # by i1 then i0
    i0, i1 = cand[order[-1]]
    i0, i1 = int(i0), int(i1)
    b0, b1 = i0, i1
    while M[i0, i1] != 0 and i0 < n0 and i1 < n1:
        if a[i0] == b[i1]:
            gv = gh = True
        else:
            v = M[i0 + 1, i1] + GAP
            d = M[i0 + 1, i1 + 1] + MISMATCH
            h = M[i0, i1 + 1] + GAP
            gv = (v >= h) or (d >= h)
            gh = (h > v) or (d >= v)
        if gv:
            i0 += 1
        if gh:
            i1 += 1
    return b0, i0, b1, i1, best
