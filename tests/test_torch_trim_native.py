"""The native trim round (``native/trim.cpp`` through
``blocks/synteny.py::trim_blocks``): on the host route a block's round is
one call that enumerates the copies and walks them; on the card route the
card's enumeration (here on the CPU: the plain versions of the kernels) is
walked by the same native walk.  Each block is trimmed to its fixpoint, as
``generate_synteny_blocks`` does, against the port's numpy route
(``SIBELIA_TPU_NATIVE=0``) and the JAX package's ``trim_blocks``
(``SIBELIA_TPU_DEVICE=0``): the drop flags, the edges of every round and
the GlibcRand stream equal, and ``trim_native_calls`` counts the native
rounds.  The native enumeration equals the numpy formulation's
BifEnumeration in every array, dtypes included."""
import numpy as np
import pytest
import torch

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu.blocks import edges as jax_edges
from sibelia_tpu.blocks import synteny as jax_synteny
from sibelia_tpu.core.glibc_rand import GlibcRand as JaxRand
from sibelia_tpu.io.fasta import FASTARecord as JaxRecord
from sibelia_tpu_torch import native
from sibelia_tpu_torch.blocks import edges, synteny
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.core.glibc_rand import GlibcRand
from sibelia_tpu_torch.index.enumeration import (build_supergenome,
                                                 enumerate_numpy)
from sibelia_tpu_torch.io.fasta import FASTARecord

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MIN_SIZE = 60


def _two(rows):
    """Two copies' lengths whose supergenome has `rows` rows (odd)."""
    bases = (rows - 1) // 2 - 2
    return (bases // 2, bases - bases // 2)


def _block(lengths, directions, iupac=0, unrelated=0, tandem=0, seed=11):
    """(records, edge tuples): related copies of one random base, one a
    chromosome, each an edge over `lengths[i]` bases from position 40 in
    direction `directions[i]`, the last `unrelated` of them drawn anew;
    `iupac` N and IUPAC codes planted in each copy's range; `tandem`: each
    copy's middle third a repeat of a 6-base unit, so that many marks tie
    on their sum and the bifurcation id and walk index decide."""
    rng = np.random.default_rng(seed)
    size = max(lengths) + 80
    base = ACGT[rng.integers(0, 4, size)]
    if tandem:
        lo, hi = 40 + min(lengths) // 3, 40 + 2 * min(lengths) // 3
        base[lo:hi] = np.resize(ACGT[rng.integers(0, 4, 6)], hi - lo)
    recs, tuples = [], []
    for i, (n, d) in enumerate(zip(lengths, directions)):
        s = (base.copy() if i < len(lengths) - unrelated
             else ACGT[rng.integers(0, 4, size)])
        hit = rng.integers(0, s.size, max(1, s.size // 60))
        s[hit] = ACGT[rng.integers(0, 4, hit.size)]
        if iupac:
            s[40 + rng.integers(0, n, iupac)] = \
                np.frombuffer(b"NNRYKN", np.uint8)[rng.integers(0, 6, iupac)]
        recs.append(s.tobytes().decode())
        tuples.append((i, d, 7, 9, 40, n, 40, n, ord("A")))
    return recs, tuples


def _fixpoint(module, record, edge, rand, recs, tuples, k, *dev):
    """Trim to the fixpoint; the drop flags and the edges of every round."""
    chr_list = [record(s, f"chr{i}", i) for i, s in enumerate(recs)]
    block = [edge(*t) for t in tuples]
    rounds = []
    while True:
        drop = module.trim_blocks(chr_list, block, k, MIN_SIZE, rand, *dev)
        rounds.append((drop, [tuple(vars(e).values()) for e in block]))
        if not drop:
            return rounds


# (lengths, directions, N/IUPAC codes a copy, unrelated copies, tandem):
# two copies at C-Sibelia's sizes of a host round (its median 373 rows, p90
# 1,025, p99 2,001, largest 4,045) and at 101 and 12,287 rows (the largest
# host-route supergenome: odd, under TRIM_CARD_MIN_ROWS), tandem repeats in
# both directions, N and IUPAC codes, a copy that shares nothing (dropped),
# three and four copies; the copies of 101 rows are shorter than k = 30
BLOCKS = {
    **{f"{rows} rows": (_two(rows), (0, 1), 0, 0, 0)
       for rows in (101, 373, 1025, 2001, 4045, 12_287)},
    "tandem, forward": ((700, 690), (0, 0), 0, 0, 1),
    "tandem, both directions": ((650, 660), (1, 0), 0, 0, 1),
    "tandem, reverse": ((400, 420), (1, 1), 0, 0, 1),
    "N and IUPAC": ((500, 520), (0, 1), 8, 0, 0),
    "a copy that shares nothing": ((600, 640, 620), (1, 0, 0), 0, 1, 0),
    "three copies, N and IUPAC": ((700, 650, 720), (0, 1, 0), 4, 0, 0),
    "four copies": ((900, 880, 910, 870), (0, 1, 1, 0), 2, 0, 1),
}


def _rounds(monkeypatch, name, k, native_on, *dev):
    if not native_on:
        monkeypatch.setenv("SIBELIA_TPU_NATIVE", "0")
    recs, tuples = _block(*BLOCKS[name])
    rand = GlibcRand(3)
    timings.reset()
    got = _fixpoint(synteny, FASTARecord, edges.Edge, rand, recs, tuples, k,
                    *dev)
    monkeypatch.delenv("SIBELIA_TPU_NATIVE", raising=False)
    return got, rand._buf, timings.snapshot()


@pytest.mark.parametrize("k", [15, 30, 100])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_native_round_matches_numpy_and_jax(monkeypatch, name, k):
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    lengths, _, iupac, unrelated, _ = BLOCKS[name]
    recs, tuples = _block(*BLOCKS[name])
    want_rand = JaxRand(3)
    want = _fixpoint(jax_synteny, JaxRecord, jax_edges.Edge, want_rand, recs,
                     tuples, k)
    numpy_got, numpy_buf, numpy_phases = _rounds(monkeypatch, name, k, False,
                                                 CPU)
    got, buf, phases = _rounds(monkeypatch, name, k, True, CPU)
    assert got == want and numpy_got == want
    assert buf == want_rand._buf and numpy_buf == want_rand._buf
    if iupac:
        assert buf != GlibcRand(3)._buf
    if unrelated or min(lengths) < k:
        assert got[0][0]  # a copy without a shared k-mer: dropped
    # every round of these blocks takes the host route: one native call
    # each with the library, none without
    assert phases["trim_host_calls"] == phases["trim_calls"] == len(got)
    assert phases["trim_native_calls"] == len(got)
    assert "trim_enum" not in phases
    assert numpy_phases["trim_host_calls"] == len(got)
    assert "trim_native_calls" not in numpy_phases
    assert "trim_native" not in numpy_phases


@pytest.mark.parametrize("name,k", [("373 rows", 30), ("tandem, both "
                                    "directions", 15), ("four copies", 30),
                                    ("a copy that shares nothing", 100)])
def test_card_route_through_the_native_walk(monkeypatch, name, k):
    """The card's enumeration walked natively: the rounds of the numpy walk
    over the same enumeration and of the JAX package's host branch."""
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    monkeypatch.setattr(synteny, "TRIM_CARD_MIN_ROWS", 0)
    recs, tuples = _block(*BLOCKS[name])
    want_rand = JaxRand(3)
    want = _fixpoint(jax_synteny, JaxRecord, jax_edges.Edge, want_rand, recs,
                     tuples, k)
    numpy_got, numpy_buf, _ = _rounds(monkeypatch, name, k, False, CPU)
    got, buf, phases = _rounds(monkeypatch, name, k, True, CPU)
    assert got == want and numpy_got == want
    assert buf == want_rand._buf and numpy_buf == want_rand._buf
    # a round of an empty block (every copy dropped) has no rows: the host
    card = sum(1 for kept in [tuples] + [b for _, b in got[:-1]] if kept)
    assert phases["trim_card_calls"] == card > 0 and "trim_enum" in phases
    assert phases["trim_calls"] == len(got)
    assert phases.get("trim_native_calls", 0) == len(got) - card


@pytest.mark.parametrize("k", [15, 30, 100])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_native_enumeration_and_walk_equal_numpy(name, k):
    """``native.trim_enum`` against ``enumerate_numpy`` over the block's
    copies (N and IUPAC codes left in: separators to both), array for array
    and dtype for dtype; ``native.trim_walk`` and ``trim_round`` against
    the numpy walk over that enumeration, in both directions of each
    copy."""
    recs, tuples = _block(*BLOCKS[name])
    copies = [np.frombuffer(s.encode(), np.uint8)[40:40 + t[7]]
              for s, t in zip(recs, tuples)]
    chars = np.concatenate(copies)
    lens = np.array([c.size for c in copies], dtype=np.int64)
    count, strands = native.trim_enum(chars, lens, k)
    want = enumerate_numpy(*build_supergenome(copies), len(copies), k)
    assert count == want.count
    for s in (0, 1):
        for got_a, field in zip(strands[s], ("chr", "pos", "bif_id")):
            want_a = getattr(want, field)[s]
            assert got_a.dtype == want_a.dtype
            np.testing.assert_array_equal(got_a, want_a)
    for flip in (0, 1):
        dirs = np.array([t[1] ^ flip for t in tuples], dtype=np.int8)
        drop, out = synteny._trim_walk(lens, dirs, want, k, MIN_SIZE)
        for res in (native.trim_walk(want, lens, dirs, k, MIN_SIZE),
                    native.trim_round(chars, lens, dirs, k, MIN_SIZE)):
            assert res[0] == drop
            np.testing.assert_array_equal(res[1], out)
