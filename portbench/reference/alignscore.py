"""Hold each pairwise alignment to the aligner's own scoring, around its
gaps.

The exact aligner (LAGAN's ``order``) scores a column of two bases by a
substitution matrix, and a run of L gap columns between two such columns
by ``gap_start + (L + 1) * gap_cont``.  Its alignment is the best path of
that scoring inside its band, but for its traceback's choice among the
three states of a cell, which can cost up to one ``gap_cont``.  So,
around every gap run of a pair, a window from a column of two bases some
columns before the run to one some columns after it can be aligned again
here, by a plain dynamic program over the same scoring with the window's
end columns fixed: the program's path through the window is one of the
paths it weighs, so the window's best score is never below the
program's.  The gap between the two, the window's score deficit, is 0 or
a traceback tie where the program's path is the best one.  A gap moved a
few columns off its place, or a wrong choice in the band DP or its
traceback, shows as a deficit of the order of a few mismatches.  Where
several places of a gap run score the same (a gap in a repeat), the
traceback takes the last: no gap run can move one column on at an equal
score (``tie_errors``).  Only windows with no more gap columns than the
band's half-width are held to their score: the band confines the path
around a wider indel, which the aligner may also split into narrower
runs, and there its own answer can lie far below the window's best.  The scoring is the configuration's
(``scoring``); nothing here comes from the program.
"""
from __future__ import annotations

import numpy as np

GAP = ord("-")


def subst_table(scoring: dict) -> np.ndarray:
    """256 x 256 scores of two bases from the configuration's matrix
    (letters, and rows of scores in their order); upper and lower case
    alike."""
    letters = scoring["letters"]
    table = np.zeros((256, 256), np.float64)
    for i, a in enumerate(letters):
        for j, b in enumerate(letters):
            v = scoring["matrix"][i][j]
            for x in (a.upper(), a.lower()):
                for y in (b.upper(), b.lower()):
                    table[ord(x), ord(y)] = v
    return table


def path_score(r0: np.ndarray, r1: np.ndarray, table: np.ndarray,
               gap_start: float, gap_cont: float) -> float:
    """The score of the columns of a window after its first column, which
    ends in a column of two bases: each such column by the matrix, each
    gap run by gap_start + (L + 1) * gap_cont."""
    both = (r0 != GAP) & (r1 != GAP)
    score = float(table[r0[both], r1[both]].sum())
    kind = np.where(r0 == GAP, 1, np.where(r1 == GAP, 2, 0))
    edges = np.flatnonzero(np.diff(kind)) + 1
    starts = np.concatenate([[0], edges])
    for s, e in zip(starts, np.concatenate([edges, [kind.size]])):
        if kind[s]:
            score += gap_start + (e - s + 1) * gap_cont
    return score


def best_score(a: np.ndarray, b: np.ndarray, table: np.ndarray,
               gap_start: float, gap_cont: float) -> float:
    """The best score of aligning `a` with `b` when the path starts just
    after a column of two bases and ends on a column of a[-1] and b[-1]:
    LAGAN's three-state recurrence (a gap opens from the match state of
    the same cell and closes into the next match with one more
    gap_cont)."""
    n1, n2 = a.size, b.size
    neg = -np.inf
    steps = np.arange(n2 + 1) * gap_cont
    m = np.full(n2 + 1, neg)
    m[0] = 0.0
    n = m + gap_start
    o = np.maximum.accumulate(m + gap_start - steps) + steps
    for i in range(1, n1 + 1):
        mi = np.full(n2 + 1, neg)
        mi[1:] = table[a[i - 1], b] + np.maximum(
            m[:-1], np.maximum(n[:-1], o[:-1]) + gap_cont)
        n = np.maximum(mi + gap_start, n + gap_cont)
        o = np.maximum.accumulate(mi + gap_start - steps) + steps
        m = mi
    return float(m[n2])


def worst_deficit(row0: str, row1: str, scoring: dict,
                  margin: int = 24, table: np.ndarray | None = None) -> float:
    """The largest score deficit over the windows around the pair's gap
    runs: each from the last column of two bases at least `margin`
    columns before the run to the first at least `margin` after it, held
    where it holds no more gap columns than the scoring's
    ``band_half_width``.  A run with no such column on a side (at the
    alignment's ends) has no window."""
    if table is None:
        table = subst_table(scoring)
    gs, gc = scoring["gap_start"], scoring["gap_cont"]
    widest = scoring["band_half_width"]
    r0 = np.frombuffer(row0.encode(), np.uint8)
    r1 = np.frombuffer(row1.encode(), np.uint8)
    gap = (r0 == GAP) | (r1 == GAP)
    if not gap.any() or r0.size != r1.size:
        return 0.0
    both = np.flatnonzero(~gap)
    edges = np.flatnonzero(np.diff(gap.astype(np.int8))) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [gap.size]])
    worst = 0.0
    for s, e in zip(starts, ends):
        if not gap[s] or e - s > widest:
            continue
        i = np.searchsorted(both, s - margin, side="right") - 1
        j = np.searchsorted(both, e - 1 + margin, side="left")
        if i < 0 or j >= both.size:
            continue
        c0, c1 = both[i], both[j]
        if gap[c0 + 1:c1 + 1].sum() > widest:
            continue
        w0, w1 = r0[c0 + 1:c1 + 1], r1[c0 + 1:c1 + 1]
        have = path_score(w0, w1, table, gs, gc)
        best = best_score(w0[w0 != GAP], w1[w1 != GAP], table, gs, gc)
        worst = max(worst, best - have)
    return worst


def gap_runs(row0: str, row1: str):
    """(row with the gaps, first column, end column) of every run of gaps
    in one row."""
    n = len(row0)
    c = 0
    while c < n:
        if row0[c] == "-" or row1[c] == "-":
            k = 0 if row0[c] == "-" else 1
            e = c
            while e < n and (row0, row1)[k][e] == "-":
                e += 1
            yield k, c, e
            c = e
        else:
            c += 1


def tie_errors(row0: str, row1: str) -> int:
    """Gap runs between two columns of two bases that could move one
    column on at an equal score: the base after the run scores the same
    against the other row's first base under the run as against its own
    column's."""
    rows = (row0, row1)
    n = 0
    for k, s, e in gap_runs(row0, row1):
        gapped, other = rows[k], rows[1 - k]
        if (s == 0 or e >= len(gapped) or "-" in (row0[s - 1], row1[s - 1])
                or "-" in (gapped[e], other[e])):
            continue
        n += other[s].upper() == other[e].upper()
    return n
