"""Port vs JAX: the fused k <= 32 enumeration and the candidate prefilter
(sibelia_tpu_torch/index/enum_device.py vs sibelia_tpu/index/enum_device.py,
XLA scans on the CPU backend).  Exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibelia_tpu.index.enum_device import _candidate_scan, _enum_device_k32
from sibelia_tpu.index.enumeration import build_supergenome
from sibelia_tpu_torch.index.enum_device import (candidate_scan,
                                                 fused_enumeration)
from tests.test_sharded_sweep import _genomes, _instance_table


def _homopolymer_chroms():
    """tests/test_enumeration.py::test_device_k32_homopolymer_matches_host:
    G..C-flanked T32 runs whose group is not a bifurcation at k == 32."""
    rng = np.random.default_rng(7)
    ctx = rng.choice(list(b"ACGT"), size=600).astype(np.uint8)
    t32 = np.frombuffer(b"G" + b"T" * 32 + b"C", dtype=np.uint8)
    ctx = ctx[~np.isin(ctx, np.frombuffer(b"TA", np.uint8))][:300]
    a = np.concatenate([ctx[:100], t32, ctx[100:200]])
    b = np.concatenate([ctx[50:150], t32, ctx[200:300]])
    return [bytes(a), bytes(b)]


def _strains():
    return _genomes(11, 3, 3001, 40)


@pytest.mark.parametrize("k", [11, 30, 32])
@pytest.mark.parametrize("chroms", [_strains, _homopolymer_chroms])
def test_enum_device_k32_matches_jax(k, chroms):
    codes, _ = build_supergenome(chroms())
    j_pos, j_ids, j_ns, j_ng = _enum_device_k32(jnp.asarray(codes), k)
    t_pos, t_ids, t_ns, t_ng = fused_enumeration(torch.from_numpy(codes), k)
    ns = int(j_ns)
    assert ns > 0
    assert int(t_ns) == ns and int(t_ng) == int(j_ng)
    np.testing.assert_array_equal(t_pos[:ns].numpy(), np.asarray(j_pos)[:ns])
    np.testing.assert_array_equal(t_ids[:ns].numpy(), np.asarray(j_ids)[:ns])


@pytest.mark.parametrize("k,d", [(9, 40), (11, 90), (30, 150)])
def test_candidate_scan_matches_jax(k, d):
    codes, pos, ids, m, count = _instance_table(_genomes(17, 3, 6000, 60), k)
    want = np.asarray(_candidate_scan(codes, pos, ids, k, d, np.int32(m)))
    got = candidate_scan(torch.from_numpy(codes), torch.from_numpy(pos),
                         torch.from_numpy(ids), k, d, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want[:count].sum() < count  # the fixture must prune


@pytest.mark.parametrize("row_budget", [0, 1, 4])
def test_candidate_scan_by_owner_ranges_matches_jax(row_budget, monkeypatch):
    """A pair budget below the band's pairs sorts them by ranges of owner
    ids (one id a range at 0 bytes a row): the same bitmap."""
    from sibelia_tpu_torch.index import enum_device
    k, d = 30, 150
    codes, pos, ids, m, count = _instance_table(_genomes(17, 3, 6000, 60), k)
    want = np.asarray(_candidate_scan(codes, pos, ids, k, d, np.int32(m)))
    seen = []
    ranges = enum_device._owner_ranges

    def spy(*args):
        seen.append(ranges(*args))
        return seen[-1]

    monkeypatch.setattr(enum_device, "_owner_ranges", spy)
    monkeypatch.setattr(enum_device, "PAIR_ROW_BUDGET", row_budget)
    got = candidate_scan(torch.from_numpy(codes), torch.from_numpy(pos),
                         torch.from_numpy(ids), k, d, m)
    np.testing.assert_array_equal(got.numpy(), want)
    (cuts,) = seen
    assert len(cuts) > 1
    assert cuts[0][0] == 0 and cuts[-1][1] == pos.shape[0] + 1
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    per_range = max(row_budget * codes.shape[0] // enum_device.PAIR_BYTES, 1)
    # a range over the budget holds one id alone
    assert all(n <= per_range or hi == lo + 1 for lo, hi, n in cuts)


@pytest.mark.parametrize("room", [None, 0, 10**12])
def test_candidate_scan_cuts_by_what_the_card_gives(room, monkeypatch):
    """The pairs' budget is half of what the card gives when that is more
    than PAIR_ROW_BUDGET bytes a row: with room the pairs are sorted at
    once, without it (or on the CPU, None) they are cut into ranges."""
    from sibelia_tpu_torch.index import enum_device
    k, d = 30, 150
    codes, pos, ids, m, count = _instance_table(_genomes(17, 3, 6000, 60), k)
    want = np.asarray(_candidate_scan(codes, pos, ids, k, d, np.int32(m)))
    calls = []
    ranges = enum_device._owner_ranges
    monkeypatch.setattr(enum_device, "_owner_ranges",
                        lambda *args: calls.append(1) or ranges(*args))
    monkeypatch.setattr(enum_device, "PAIR_ROW_BUDGET", 1)
    monkeypatch.setattr(enum_device, "card_free_bytes", lambda device: room)
    got = candidate_scan(torch.from_numpy(codes), torch.from_numpy(pos),
                         torch.from_numpy(ids), k, d, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == (0 if room else 1)
