"""The fast aligner's ``align_pair`` against the benchmark's plain
reference of it (``portbench/reference/anchored.py``), row for row, with a
gap batcher on the CPU and without one, over pairs that reach each of its
paths: the whole-pair DP, deferred gaps of 1-128 bases, host gaps past
128, one nested re-anchoring, gaps whose places tie on score, and gaps
whose rows a change of 1 in the scoring would change."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.reference import anchored
from portbench.reference.alignscore import tie_errors
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.variants import aligner
from tests.test_device_e2e import REPO_ROOT

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random(rng, n):
    return ACGT[rng.integers(0, 4, n)]


def _related(rng, a, snp_rate, indels, longest=30):
    """a with SNPs at `snp_rate` (each a different base) and `indels`
    insertions or deletions of 1..`longest` bases."""
    b = a.copy()
    hit = np.flatnonzero(rng.random(b.size) < snp_rate)
    b[hit] = ACGT[(np.searchsorted(ACGT, b[hit]) + rng.integers(1, 4, hit.size)) % 4]
    for _ in range(indels):
        at, n = int(rng.integers(b.size)), int(rng.integers(1, longest + 1))
        if rng.random() < 0.5:
            b = np.concatenate([b[:at], b[at + n:]])
        else:
            b = np.concatenate([b[:at], _random(rng, n), b[at:]])
    return b


def whole_pair(rng):
    """At most 2^20 DP cells: aligned whole."""
    a = _random(rng, 700)
    return a, _related(rng, a, 0.03, 4)


def deferred(rng):
    """3 kbp, SNPs and short indels: gaps of 1-128 bases between anchors."""
    a = _random(rng, 3000)
    return a, _related(rng, a, 0.03, 6)


def host_gap(rng):
    """A stretch of 200 bases replaced by 170 others: one gap past 128."""
    a = _random(rng, 3000)
    b = _related(rng, a, 0.01, 2)
    b = np.concatenate([b[:1400], _random(rng, 170), b[1600:]])
    return a, b


def nested(rng):
    """A middle of 4,200 bases with every 14th base changed: no shared
    16-mer there, a gap of more than 2^24 cells, re-anchored at k = 12."""
    a = _random(rng, 7200)
    b = a.copy()
    mid = np.arange(1500, 5700, 14)
    b[mid] = ACGT[(np.searchsorted(ACGT, b[mid]) + rng.integers(1, 4, mid.size)) % 4]
    return a, b


def ties(rng):
    """Short tandem repeats with indels inside them: gap runs that could
    sit at several places for the same score."""
    units = [b"A" * 9, b"AT" * 6, b"CAG" * 4, b"G" * 7, b"TTC" * 5]
    parts_a, parts_b = [], []
    for _ in range(40):
        flank = _random(rng, int(rng.integers(20, 40))).tobytes()
        unit = units[int(rng.integers(len(units)))]
        parts_a += [flank, unit]
        cut = int(rng.integers(1, 4))
        parts_b += [flank, unit[cut:] if rng.random() < 0.5 else unit + unit[:cut]]
    a = np.frombuffer(b"".join(parts_a), dtype=np.uint8)
    return a, np.frombuffer(b"".join(parts_b), dtype=np.uint8)


# gap regions whose rows change when the gap open or column cost, or any
# entry of the matrix but C/G lowered, moves by 1 (found by a search)
CLOSE_CALLS = [(b"ACGAACCC", b"CTTGAAT"), (b"AGGGCCA", b"TTCATT"),
               (b"CCAC", b"TAGTCT"), (b"CCCCGG", b"GC"),
               (b"GATCCGGT", b"ACTAGCCG"), (b"GC", b"CTCCTAG"),
               (b"GTCCA", b"CAGCTAGG"), (b"TAGGT", b"GA"),
               (b"TATCT", b"CATATACA")]


def close_calls(rng):
    """The close calls between shared stretches of 60 bases."""
    shared = [_random(rng, 1100)] + [_random(rng, 60) for _ in CLOSE_CALLS]
    parts = [[shared[0]], [shared[0]]]
    for flank, pair in zip(shared[1:], CLOSE_CALLS):
        for side in (0, 1):
            parts[side] += [np.frombuffer(pair[side], dtype=np.uint8), flank]
    return np.concatenate(parts[0]), np.concatenate(parts[1])


CASES = {"whole_pair": whole_pair, "deferred": deferred,
         "host_gap": host_gap, "nested": nested, "ties": ties,
         "close_calls": close_calls}


@pytest.fixture(autouse=True)
def one_thread():
    """One of torch's threads: these DPs are many small operations, which
    a pool of threads per test worker only slows down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def spied(monkeypatch):
    """A fresh record, and the sizes of every host Gotoh and the k of every
    anchored alignment that the port runs."""
    monkeypatch.setattr(timings, "_ACC", {})
    seen = {"gotoh": [], "k": []}
    rows, pair = aligner._gotoh_rows, aligner.align_pair

    def gotoh_rows(a, b):
        seen["gotoh"].append((len(a), len(b)))
        return rows(a, b)

    def align_pair(a, b, k=16, **kw):
        seen["k"].append(k)
        return pair(a, b, k=k, **kw)
    monkeypatch.setattr(aligner, "_gotoh_rows", gotoh_rows)
    monkeypatch.setattr(aligner, "align_pair", align_pair)
    return seen


@pytest.mark.parametrize("batched", [False, True], ids=["host", "batcher"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_align_pair_equals_the_plain_reference(case, batched, spied):
    rng = np.random.default_rng(sorted(CASES).index(case) + 20261018)
    a, b = (x.tobytes() for x in CASES[case](rng))
    batcher = aligner.GapBatcher(torch.device("cpu")) if batched else None
    got = aligner.align_pair(a, b, batcher=batcher)
    want = anchored.anchored(a, b)
    assert got == want
    assert got[0].replace("-", "") == a.decode()
    assert got[1].replace("-", "") == b.decode()
    cells = (len(a) + 1) * (len(b) + 1)
    record = timings._ACC
    if case == "whole_pair":
        assert cells <= anchored.WHOLE_PAIR_CELLS
        assert spied["gotoh"] == [(len(a), len(b))]
        assert "anchoring" not in record
        return
    assert cells > anchored.WHOLE_PAIR_CELLS and record["anchoring"] > 0
    small = [(x, y) for x, y in spied["gotoh"] if 0 < x <= 128 and 0 < y <= 128]
    if batched:
        assert not small
        assert record["gotoh_pairs"] > 0 or case == "host_gap"
    else:
        assert small and "gotoh_pairs" not in record
    if case == "host_gap":
        assert any(max(x, y) > 128 for x, y in spied["gotoh"])
    if case == "nested":
        assert spied["k"] == [16, 12]
    if case == "ties":
        assert tie_errors(*got) > 0
    if case == "close_calls":
        sizes = sorted((len(x), len(y)) for x, y in CLOSE_CALLS)
        if batched:
            assert record["gotoh_pairs"] == len(sizes)
        else:
            assert sorted(small) == sizes


def test_the_reference_imports_neither_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.anchored; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'sibelia_tpu', 'sibelia_tpu_torch'}))" % REPO_ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr
