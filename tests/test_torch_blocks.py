"""Port vs JAX: synteny block generation whose whole-genome index is
enumerated through the port (sibelia_tpu_torch/blocks/synteny.py) against
``sibelia_tpu.blocks.finder.BlockFinder.generate_synteny_blocks`` on the
host, on the fixture of tests/test_device_e2e.py with ambiguous bases.
Exact equality of the blocks, the working sequence and the random stream,
and the ``block_trim`` split with the trim enumerations' route counts (the
host route's rounds each one native call)."""
import numpy as np
import pytest
import torch

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu.blocks.finder import BlockFinder as HostBlockFinder
from sibelia_tpu.io.fasta import FASTARecord, read_fasta
from sibelia_tpu_torch.blocks.finder import BlockFinder
from sibelia_tpu_torch.core import timings
from tests.test_device_e2e import _write_fixture


def _records(tmp_path):
    """The e2e fixture's three 20 kbp chromosomes with N and other IUPAC
    codes planted, so block generation draws from the GlibcRand stream."""
    fa, _ = _write_fixture(tmp_path)
    recs = []
    read_fasta(str(fa), recs)
    rng = np.random.default_rng(4)
    out = []
    for r in recs:
        s = bytearray(r.sequence.encode())
        for i in rng.integers(0, len(s), size=25):
            s[i] = ord(rng.choice(list("NNNRY")))
        out.append(FASTARecord(s.decode(), r.description, r.id))
    return out


def _blocks(blocks):
    return [(b.signed_id, b.chr_id, b.start, b.end) for b in blocks]


@pytest.mark.parametrize("simplified", [False, True])
@pytest.mark.parametrize("k", [15, 30, 100])
def test_generate_synteny_blocks_matches_jax(tmp_path, monkeypatch, k,
                                             simplified):
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    recs = _records(tmp_path)
    want_f = HostBlockFinder(recs)
    got_f = BlockFinder(recs, torch.device("cpu"))
    if simplified:
        # the fixture's first stage (tests/test_device_e2e.py stages.txt)
        want_f.perform_graph_simplifications(10, 60, 4)
        got_f.perform_graph_simplifications(10, 60, 4)
    timings.reset()
    stream = list(got_f.rand._buf)
    want = want_f.generate_synteny_blocks(k, min(k, 10), 100)
    got = got_f.generate_synteny_blocks(k, min(k, 10), 100)
    assert len(want) > 0
    assert _blocks(got) == _blocks(want)
    # both consumed the stream, and in the same order
    assert got_f.rand._buf == want_f.rand._buf != stream
    for a, b in zip(got_f.raw_seq, want_f.raw_seq):
        np.testing.assert_array_equal(a, b)
    phases = timings.snapshot()
    for name in ("block_index", "block_edges", "block_trim", "trim_resolve",
                 "trim_walk", "trim_rows"):
        assert name in phases, name
    # the host route's rounds in trim_native, the card route's enumerations
    # in trim_enum
    assert ("trim_native" in phases) == ("trim_host_calls" in phases)
    assert ("trim_enum" in phases) == ("trim_card_calls" in phases)
    # every trim enumeration counted, by its route
    assert phases["trim_calls"] >= len({abs(b.signed_id) for b in got}) > 0
    assert (phases.get("trim_card_calls", 0)
            + phases.get("trim_host_calls", 0)) == phases["trim_calls"]
    # with the native library every host-route round is one native call
    assert phases.get("trim_native_calls", 0) == phases.get(
        "trim_host_calls", 0)
