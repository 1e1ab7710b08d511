"""Port vs JAX: ``trim_blocks`` (sibelia_tpu_torch/blocks/synteny.py), whose
per-block enumerations take the device route from ``TRIM_CARD_MIN_ROWS``
supergenome rows on (here on the CPU: the plain versions of the kernels),
against ``sibelia_tpu.blocks.synteny.trim_blocks`` under both branches of
the JAX package's dispatch: ``SIBELIA_TPU_DEVICE=0`` (numpy, and native
from 2^16 rows) and ``=1`` (its fused device enumeration, which on the CPU
pads every call to 2^20 rows, so only a few calls take it).  Each block is
trimmed to its fixpoint, as ``generate_synteny_blocks`` does: the ``drop``
flags, the edges and the GlibcRand stream equal, and the port's ``trim_*``
timing keys count each call and its route."""
import numpy as np
import pytest
import torch

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu.blocks import edges as jax_edges
from sibelia_tpu.blocks import synteny as jax_synteny
from sibelia_tpu.core.glibc_rand import GlibcRand as JaxRand
from sibelia_tpu.io.fasta import FASTARecord as JaxRecord
from sibelia_tpu_torch.blocks import edges, synteny
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.core.glibc_rand import GlibcRand
from sibelia_tpu_torch.io.fasta import FASTARecord

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _block(lengths, directions, iupac=0, unrelated=0, seed=5):
    """(records, edge tuples): related copies of one random base, one a
    chromosome, each an edge over `lengths[i]` bases from position 40 in
    direction `directions[i]`, the last `unrelated` of them drawn anew;
    `iupac` N and IUPAC codes planted in each copy's range (the rand
    stream)."""
    rng = np.random.default_rng(seed)
    size = max(lengths, default=0) + 80
    base = ACGT[rng.integers(0, 4, size)]
    recs, tuples = [], []
    for i, (n, d) in enumerate(zip(lengths, directions)):
        s = (base.copy() if i < len(lengths) - unrelated
             else ACGT[rng.integers(0, 4, size)])
        hit = rng.integers(0, s.size, max(1, s.size // 60))
        s[hit] = ACGT[rng.integers(0, 4, hit.size)]
        if iupac:
            s[40 + rng.integers(0, max(n, 1), iupac)] = \
                np.frombuffer(b"NNRYKN", np.uint8)[rng.integers(0, 6, iupac)]
        recs.append(s.tobytes().decode())
        tuples.append((i, d, 7, 9, 40, n, 40, n, ord("A")))
    return recs, tuples


def _rows(lengths):
    return 1 + 2 * sum(n + 1 for n in lengths) if lengths else 0


def _fixpoint(module, record, edge, rand, recs, tuples, k, min_size, *dev):
    """Trim to the fixpoint; the drop flags and the edges of every round."""
    chr_list = [record(s, f"chr{i}", i) for i, s in enumerate(recs)]
    block = [edge(*t) for t in tuples]
    rounds = []
    while True:
        drop = module.trim_blocks(chr_list, block, k, min_size, rand, *dev)
        rounds.append((drop, [tuple(vars(e).values()) for e in block]))
        if not drop:
            return rounds


# (lengths, directions, N/IUPAC codes a copy, unrelated copies): an empty
# block, one copy, copies with ambiguous bases, a copy that shares nothing
# (dropped), and supergenomes of 4,095 and 4,097 rows astride the scan
# kernel's 4,096-row tile (a supergenome, 1 + 2 (bases + copies) rows,
# never has 4,096)
BLOCKS = {
    "empty": ((), (), 0, 0),
    "one copy": ((900,), (0,), 0, 0),
    "three copies, N and IUPAC": ((700, 650, 720), (0, 1, 0), 6, 0),
    "two copies and an unrelated one": ((600, 640, 620), (1, 0, 0), 0, 1),
    "4,095 rows": ((1022, 1023), (0, 1), 0, 0),
    "4,097 rows": ((1023, 1023), (1, 0), 2, 0),
    "four copies, 2^16 rows and more": ((8300, 8200, 8250, 8100),
                                        (0, 0, 1, 1), 3, 0),
}


@pytest.mark.parametrize("min_rows", ["constant", 0, 1 << 40])
@pytest.mark.parametrize("k", [15, 30, 100])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_trim_blocks_matches_jax_host_branch(monkeypatch, name, k, min_rows):
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    if min_rows != "constant":
        monkeypatch.setattr(synteny, "TRIM_CARD_MIN_ROWS", min_rows)
    lengths, directions, iupac, unrelated = BLOCKS[name]
    recs, tuples = _block(lengths, directions, iupac, unrelated)
    want_rand, got_rand = JaxRand(1), GlibcRand(1)
    want = _fixpoint(jax_synteny, JaxRecord, jax_edges.Edge, want_rand, recs,
                     tuples, k, 60)
    timings.reset()
    got = _fixpoint(synteny, FASTARecord, edges.Edge, got_rand, recs, tuples,
                    k, 60, CPU)
    assert got == want
    assert got_rand._buf == want_rand._buf
    if iupac:
        assert got_rand._buf != GlibcRand(1)._buf
    if unrelated or len(lengths) == 1:
        assert got[0][0]  # a copy without a shared k-mer: dropped
    # each round enumerates the copies the round before it left
    rows = [_rows([t[7] for t in block])
            for block in [tuples] + [kept for _, kept in got[:-1]]]
    card = sum(1 for n in rows if n and n >= synteny.TRIM_CARD_MIN_ROWS)
    phases = timings.snapshot()
    assert phases["trim_calls"] == len(got)
    assert phases["trim_rows"] == sum(rows)
    assert phases.get("trim_card_calls", 0) == card
    assert phases.get("trim_host_calls", 0) == len(got) - card
    # the host route's rounds are native calls, the card route's enumerate
    assert phases.get("trim_native_calls", 0) == len(got) - card
    assert ("trim_native" in phases) == (len(got) > card)
    assert ("trim_enum" in phases) == (card > 0)
    assert "trim_walk" in phases


@pytest.mark.parametrize("name,k", [("three copies, N and IUPAC", 30),
                                    ("4,097 rows", 15)])
def test_trim_blocks_matches_jax_device_branch(monkeypatch, name, k):
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
    monkeypatch.setattr(synteny, "TRIM_CARD_MIN_ROWS", 0)
    lengths, directions, iupac, unrelated = BLOCKS[name]
    recs, tuples = _block(lengths, directions, iupac, unrelated)
    want_rand, got_rand = JaxRand(1), GlibcRand(1)
    want = _fixpoint(jax_synteny, JaxRecord, jax_edges.Edge, want_rand, recs,
                     tuples, k, 60)
    got = _fixpoint(synteny, FASTARecord, edges.Edge, got_rand, recs, tuples,
                    k, 60, CPU)
    assert got == want
    assert got_rand._buf == want_rand._buf


def test_trim_enumeration_routes_by_size(monkeypatch):
    """Below TRIM_CARD_MIN_ROWS the host enumeration, from it on the
    device's: equal enumerations, counted by route."""
    lengths = (300, 310)
    recs, _ = _block(lengths, (0, 0))
    chroms = [s.encode()[40:40 + n] for s, n in zip(recs, lengths)]
    rows = _rows(lengths)
    seen = {}
    for name in ("enumerate_bifurcations", "enumerate_bifurcations_host"):
        real = getattr(synteny, name)

        def spy(*args, real=real, name=name):
            seen[name] = seen.get(name, 0) + 1
            return real(*args)
        monkeypatch.setattr(synteny, name, spy)
    timings.reset()
    results = []
    for min_rows in (rows, rows + 1):
        monkeypatch.setattr(synteny, "TRIM_CARD_MIN_ROWS", min_rows)
        results.append(synteny.trim_enumeration(chroms, 15, CPU))
    assert seen == {"enumerate_bifurcations": 1,
                    "enumerate_bifurcations_host": 1}
    a, b = results
    assert a.count == b.count > 0
    for field in ("chr", "pos", "bif_id"):
        for s in (0, 1):
            np.testing.assert_array_equal(getattr(a, field)[s],
                                          getattr(b, field)[s])
    phases = timings.snapshot()
    assert (phases["trim_calls"], phases["trim_card_calls"],
            phases["trim_host_calls"], phases["trim_rows"]) == (
        2, 1, 1, 2 * rows)
