"""The score check of the exact aligner's alignments, and the verdict's
rule."""
import json
import os

import numpy as np
import pytest

from portbench.faults import _gap_shifted, _gap_tie_back, _gap_tie_on
from portbench.reference.anchored import anchored
from portbench.reference.alignscore import (best_score, path_score,
                                            subst_table, tie_errors,
                                            worst_deficit)
from portbench.run import ROOT, is_correct

SCORING = json.load(open(os.path.join(
    ROOT, "portbench", "configs", "csibelia_default.json")))["scoring"]
TABLE = subst_table(SCORING)
GS, GC = SCORING["gap_start"], SCORING["gap_cont"]


def _codes(s):
    return np.frombuffer(s.encode(), np.uint8)


def _paths(a, b):
    """Every alignment of a and b, as pairs of rows."""
    if not a and not b:
        yield "", ""
        return
    if a and b:
        for p, q in _paths(a[1:], b[1:]):
            yield a[0] + p, b[0] + q
    if a:
        for p, q in _paths(a[1:], b):
            yield a[0] + p, "-" + q
    if b:
        for p, q in _paths(a, b[1:]):
            yield "-" + p, b[0] + q


def _recurrence_path(r0, r1):
    """No run of gaps in one row right after a run in the other: the
    three-state recurrence closes a gap into a column of two bases."""
    kind = [1 if x == "-" else 2 if y == "-" else 0 for x, y in zip(r0, r1)]
    return all(not (k and n and k != n) for k, n in zip(kind, kind[1:]))


@pytest.mark.parametrize("seed", range(4))
def test_best_score_is_the_best_path_of_the_recurrence(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        a = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
        b = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
        best = max(path_score(_codes(p + a[-1]), _codes(q + b[-1]), TABLE, GS, GC)
                   for p, q in _paths(a[:-1], b[:-1])
                   if _recurrence_path(p + a[-1], q + b[-1]))
        assert best_score(_codes(a), _codes(b), TABLE, GS, GC) == best


def test_a_gap_in_its_place_reads_0_and_moved_reads_mismatches():
    rng = np.random.default_rng(1)
    a = "".join(rng.choice(list("ACGT"), 200))
    b = a[:100] + a[103:]
    row0, row1 = a, b[:100] + "---" + b[100:]
    assert worst_deficit(row0, row1, SCORING) == 0
    moved = _gap_shifted((row0, row1))
    assert moved[1].replace("-", "") == row1.replace("-", "")
    assert moved[1].index("-") == 104
    assert worst_deficit(*moved, SCORING) > 300


def test_a_gap_at_the_ends_or_wider_than_the_band_has_no_window():
    assert worst_deficit("ACGTACGT", "---TACGT", SCORING) == 0
    rng = np.random.default_rng(2)
    a = "".join(rng.choice(list("ACGT"), 200))
    wide = SCORING["band_half_width"] + 1
    row1 = a[:100] + "-" * wide + a[100 + wide:]
    assert worst_deficit(a, row1, SCORING) == 0
    assert _gap_shifted((a, row1)) == (a, row1)
    assert worst_deficit(a, a[:96] + "-" * wide + a[96 + wide:], SCORING) == 0
    # a wide insertion split into two narrow runs, one of them misplaced:
    # the window holds more gap columns than the band's half-width
    inserted = a[:100] + "".join(rng.choice(list("ACGT"), 18)) + a[100:]
    split = a[:95] + "-" * 8 + a[95:100] + "-" * 10 + a[100:]
    assert worst_deficit(split, inserted, SCORING) == 0
    assert worst_deficit(split, inserted, {**SCORING, "band_half_width": 18}) > 0


def test_a_gap_in_a_repeat_goes_last_and_back_is_a_tie_error():
    row0 = "ACGTTTTGCA"
    row1 = "ACGTTT-GCA"
    assert tie_errors(row0, row1) == 0
    back = _gap_tie_back((row0, row1))
    assert back == (row0, "ACGTT-TGCA")
    assert tie_errors(*back) == 1
    assert worst_deficit(*back, SCORING) == 0
    assert tie_errors("ACGTAGCA", "ACG--GCA") == 0
    assert _gap_tie_back(("ACGTAGCA", "ACG--GCA")) == ("ACGTAGCA", "ACG--GCA")


def test_a_tie_moved_on_scores_the_same_and_is_not_the_references_rows():
    """The fast traceback puts a tied gap run first; the fault moves it one
    column on, which no score window sees and the rows' comparison does."""
    a, b = b"ACGTTTTGCA", b"ACGTTTGCA"
    rows = anchored(a, b)
    assert rows == ("ACGTTTTGCA", "ACG-TTTGCA")
    moved = _gap_tie_on(rows)
    assert moved == ("ACGTTTTGCA", "ACGT-TTGCA")
    assert moved != anchored(a, b)
    assert worst_deficit(*moved, SCORING) == worst_deficit(*rows, SCORING) == 0
    assert _gap_tie_on(("ACGTAGCA", "ACG--GCA")) == ("ACGTAGCA", "ACG--GCA")


def test_every_limited_number_must_be_there_and_within():
    limits = {"a": 0, "b": 0.5}
    assert is_correct({"a": 0, "b": 0.5}, limits, 1, 0)
    assert not is_correct({"a": 0}, limits, 1, 0)
    assert not is_correct({}, limits, 1, 0)
    assert not is_correct({"a": 1, "b": 0}, limits, 1, 0)
    assert not is_correct({"a": 0, "b": 0}, limits, 0, 0)
    assert not is_correct({"a": 0, "b": 0}, limits, 2, 1)
