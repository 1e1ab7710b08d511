"""A plain reference of the port's fast aligner (C-Sibelia under
``SIBELIA_TPU_ALIGNER=fast``): the anchored alignment of one unique pair,
the rows the VCF is derived from, in plain PyTorch on CPU tensors.  It
imports nothing of the program.

Written from the aligner's published rules (README, "PyTorch/CUDA port";
the docstrings of ``variants/aligner.py``, ``variants/scoring.py`` and
``kernels/gotoh.py``):

1. A pair whose DP has at most 2^20 cells, (len(a) + 1)(len(b) + 1), is
   aligned whole by Gotoh (rule 6).
2. Anchors are the k-mers (k = 16) that occur exactly once in a and
   exactly once in b, as pairs of start positions.
3. They are chained by the longest chain strictly increasing in both
   sequences.  Of several, the chain is read backwards from the last
   anchor (in a's order) that ends a longest chain, each step to the
   last anchor before it that ends a chain one shorter.
4. The chained anchors, in order, merge into exact runs: an anchor on
   the current run's diagonal that starts inside it or right after it
   extends it; one that starts inside the run on either sequence but off
   its diagonal is dropped; any other starts a new run of k bases.
5. Each gap (before the first run, between two, after the last) is
   closed: a side that is empty by gaps against the other; a DP of at
   most 2^24 cells by Gotoh; a larger one at nesting depth 0, 1 or 2 by
   rules 2-5 again with k = 12, 10 or 8 (depth one more); deeper, the
   first h bases of both sides, h = 2^24 // (the longer side + 1), by
   Gotoh and the rest as a gap one level deeper.
6. Gotoh: global, affine gaps under LAGAN's matrix (HOXD70 for upper-case
   A, C, G, T; -43 for a pair with any other byte), a run of L gap columns
   -400 - 25 L, a gap in a never next to a gap in b.  The traceback starts
   in the best of the three states at the corner; after a column of two
   bases it takes the best state of the cell before; on equal scores it
   prefers a column of two bases, then a gap in b, then a gap in a; inside
   a gap it leaves the gap as soon as opening it there gives the cell's
   score.  So, of equal-score places, a gap run takes the first.

Departures: the port defers gaps with both sides of 1-128 bases into a
batch that its Gotoh kernel (on the CPU, its plain version) closes; its
contract is the host Gotoh's rows, so here every gap is aligned alone.
The DP runs a row at a time in int32 (the port: numpy anti-diagonals in
int64; the kernel: a warp a pair); the scores are integers and far from
either type's range, so the choices are the same.

``align_multiple`` (blocks of more than two instances) is not covered:
its rows are held by ``maf_errors`` and the rest of ``judge_variants``
alone.
"""
from __future__ import annotations

import bisect

import torch

GAP_OPEN = -400           # a gap's first column costs GAP_OPEN + GAP_COLUMN
GAP_COLUMN = -25
OTHER = -43               # any pair with a byte outside upper-case ACGT
HOXD70 = {"AA": 91, "AC": -114, "AG": -31, "AT": -123, "CC": 100,
          "CG": -125, "CT": -31, "GG": 100, "GT": -114, "TT": 91}
WHOLE_PAIR_CELLS = 1 << 20
GAP_CELLS = 1 << 24
NESTED_K = (12, 10, 8)
NEG = -(1 << 30)


def score_table() -> torch.Tensor:
    """int32 [256, 256]: the score of a column of two bytes."""
    table = torch.full((256, 256), OTHER, dtype=torch.int32)
    for pair, v in HOXD70.items():
        x, y = (ord(c) for c in pair)
        table[x, y] = table[y, x] = v
    return table


SCORE = score_table()


def gotoh(a: bytes, b: bytes) -> tuple[str, str]:
    """Rule 6: the rows of the global affine-gap alignment of a and b."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return a.decode() + "-" * m, "-" * n + b.decode()
    ta = torch.frombuffer(bytearray(a), dtype=torch.uint8).long()
    tb = torch.frombuffer(bytearray(b), dtype=torch.uint8).long()
    open1 = GAP_OPEN + GAP_COLUMN
    cols = GAP_COLUMN * torch.arange(m + 1, dtype=torch.int32)
    M = torch.full((n + 1, m + 1), NEG, dtype=torch.int32)
    X = torch.full((n + 1, m + 1), NEG, dtype=torch.int32)  # gap in b
    Y = torch.full((n + 1, m + 1), NEG, dtype=torch.int32)  # gap in a
    M[0, 0] = 0

    def gap_in_a(i):
        # Y[i, j] = max(Y[i, j-1], M[i, j-1] + GAP_OPEN) + GAP_COLUMN,
        # Y[i, 0] = NEG, unrolled into a running max along the row
        before = torch.cummax(M[i, :-1] - cols[:-1], 0).values
        Y[i, 1:] = torch.maximum(NEG + cols[1:],
                                 before + cols[1:] + GAP_OPEN)

    gap_in_a(0)
    for i in range(1, n + 1):
        best = torch.maximum(torch.maximum(M[i - 1], X[i - 1]), Y[i - 1])
        M[i, 1:] = best[:-1] + SCORE[ta[i - 1], tb]
        X[i] = torch.maximum(M[i - 1] + open1, X[i - 1] + GAP_COLUMN)
        gap_in_a(i)

    def prefer(i, j):  # the best state of a cell, ties to the lower state
        vals = (int(M[i, j]), int(X[i, j]), int(Y[i, j]))
        return max(range(3), key=lambda s: (vals[s], -s))

    ra, rb = [], []
    i, j = n, m
    state = prefer(n, m)
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            ra.append(a[i - 1])
            rb.append(b[j - 1])
            state = prefer(i - 1, j - 1)
            i, j = i - 1, j - 1
        elif state == 1 and i > 0:
            ra.append(a[i - 1])
            rb.append(45)
            if int(X[i, j]) == int(M[i - 1, j]) + open1:
                state = 0
            i -= 1
        elif state == 2 and j > 0:
            ra.append(45)
            rb.append(b[j - 1])
            if int(Y[i, j]) == int(M[i, j - 1]) + open1:
                state = 0
            j -= 1
        elif i > 0:
            ra.append(a[i - 1])
            rb.append(45)
            i -= 1
        else:
            ra.append(45)
            rb.append(b[j - 1])
            j -= 1
    return bytes(ra[::-1]).decode("latin-1"), bytes(rb[::-1]).decode("latin-1")


def unique_shared_kmers(a: bytes, b: bytes, k: int) -> list[tuple[int, int]]:
    """Rule 2: (position in a, position in b) of each k-mer that occurs
    once in a and once in b, in a's order."""
    if len(a) < k or len(b) < k:
        return []
    wa = torch.frombuffer(bytearray(a), dtype=torch.uint8).unfold(0, k, 1)
    wb = torch.frombuffer(bytearray(b), dtype=torch.uint8).unfold(0, k, 1)
    _, ids = torch.unique(torch.cat([wa, wb]), dim=0, return_inverse=True)
    ia, ib = ids[:wa.shape[0]], ids[wa.shape[0]:]
    size = int(ids.max()) + 1
    once = ((torch.bincount(ia, minlength=size) == 1)
            & (torch.bincount(ib, minlength=size) == 1))
    pa = torch.nonzero(once[ia])[:, 0]
    pb = torch.nonzero(once[ib])[:, 0]
    at_b = torch.empty(size, dtype=torch.long)
    at_b[ib[pb]] = pb
    return list(zip(pa.tolist(), at_b[ia[pa]].tolist()))


def chain(anchors: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Rule 3 over anchors in a's order (their a positions all differ)."""
    if not anchors:
        return []
    tails: list[int] = []  # least b position that ends a chain of each length
    last: list[int] = []   # latest anchor so far that ends a chain of each length
    pred = []
    for idx, (_, y) in enumerate(anchors):
        length = bisect.bisect_left(tails, y) + 1
        if length > len(tails):
            tails.append(y)
            last.append(idx)
        else:
            tails[length - 1] = y
            last[length - 1] = idx
        pred.append(last[length - 2] if length > 1 else -1)
    out = []
    cur = last[-1]
    while cur != -1:
        out.append(anchors[cur])
        cur = pred[cur]
    return out[::-1]


def runs(chained: list[tuple[int, int]], k: int) -> list[list[int]]:
    """Rule 4: [start in a, start in b, length] of each exact run."""
    out: list[list[int]] = []
    for pa, pb in chained:
        if out:
            la, lb, ln = out[-1]
            if pa - la == pb - lb and pa - la <= ln:
                out[-1][2] = pa - la + k
                continue
            if pa < la + ln or pb < lb + ln:
                continue
        out.append([pa, pb, k])
    return out


def close_gap(a: bytes, b: bytes, depth: int) -> tuple[str, str]:
    """Rule 5."""
    if not a or not b or (len(a) + 1) * (len(b) + 1) <= GAP_CELLS:
        return gotoh(a, b)
    if depth < len(NESTED_K):
        return anchored(a, b, NESTED_K[depth], depth + 1)
    h = GAP_CELLS // (max(len(a), len(b)) + 1)
    ha, hb = gotoh(a[:h], b[:h])
    ta, tb = close_gap(a[h:], b[h:], depth + 1)
    return ha + ta, hb + tb


def anchored(a: bytes, b: bytes, k: int = 16, depth: int = 0
             ) -> tuple[str, str]:
    """The two rows the fast aligner writes for the pair (a, b)."""
    if (len(a) + 1) * (len(b) + 1) <= WHOLE_PAIR_CELLS:
        return gotoh(a, b)
    rows_a, rows_b = [], []
    ca = cb = 0
    for pa, pb, ln in runs(chain(unique_shared_kmers(a, b, k)), k):
        ga, gb = close_gap(a[ca:pa], b[cb:pb], depth)
        rows_a += [ga, a[pa:pa + ln].decode()]
        rows_b += [gb, b[pb:pb + ln].decode()]
        ca, cb = pa + ln, pb + ln
    ga, gb = close_gap(a[ca:], b[cb:], depth)
    return "".join(rows_a) + ga, "".join(rows_b) + gb
