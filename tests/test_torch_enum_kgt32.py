"""Port vs JAX: k > 32 bifurcation enumeration by prefix doubling
(sibelia_tpu_torch/index/ranking_device.py::kmer_ranks and the fused
enumeration) against the JAX package's forced-device path, which runs
``enumerate_bifurcations_sharded`` on ``production_mesh(1)``, and against
its host path.  Exact equality; against the native host path (2^16 rows
and up) in value, as its chr and pos are int32 where the JAX package's
device paths, which the port twins, give int64."""
import numpy as np
import pytest
import torch

import sibelia_tpu.parallel.sharded_enum as sharded_enum
from sibelia_tpu.index import enumeration as E
from sibelia_tpu.index.enumeration import build_supergenome
from sibelia_tpu_torch.index import enumeration as port_enum
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations
from sibelia_tpu_torch.index.ranking_device import doubling_shifts, kmer_ranks
from tests.test_torch_enumeration import _assert_same_enum
from tests.test_wave_device import _genomes

CPU = torch.device("cpu")
ACGT = list(b"ACGT")


def _strains():
    return _genomes(n_mut=120, size=7000, n_strains=3)


def _large_strains():
    """Past 2^16 supergenome rows, where the host path is native."""
    return _genomes(n_mut=300, size=12000, n_strains=3)


def _all_t():
    """tests/test_sharded_enum.py::test_sharded_all_t_runs, widened past
    2^14 supergenome rows: a real all-T window packs to the sentinel key."""
    rng = np.random.default_rng(3)
    base = rng.choice(ACGT, size=6000).astype(np.uint8)
    base[500:700] = ord("T")
    mut = base.copy()
    mut[100] = ord("A") if mut[100] != ord("A") else ord("C")
    mut[600] = ord("G")
    return [bytes(base), bytes(mut)]


def _short_chromosomes():
    """Many chromosomes of 20-300 bp and an exact duplicate."""
    rng = np.random.default_rng(11)
    chroms = [bytes(rng.choice(ACGT, size=int(ln)).astype(np.uint8))
              for ln in rng.integers(20, 301, size=60)]
    return chroms + [chroms[3]]


def _some_shorter_than_k():
    """Chromosomes of 40, 80 and 300 bp beside two related 5 kbp ones."""
    rng = np.random.default_rng(5)
    base = rng.choice(ACGT, size=5000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, base.size, size=40)
    mut[pos] = rng.choice(ACGT, size=40)
    short = [bytes(rng.choice(ACGT, size=n).astype(np.uint8))
             for n in (40, 300, 80)]
    return [short[0], bytes(base), short[1], bytes(mut), short[2]]


@pytest.mark.parametrize("chroms,k", [
    (_strains, 33), (_strains, 64), (_strains, 100), (_strains, 500),
    (_strains, 1000), (_large_strains, 100), (_all_t, 40),
    (_short_chromosomes, 35), (_some_shorter_than_k, 500)])
def test_kgt32_matches_jax_device_and_host(monkeypatch, chroms, k):
    chroms = chroms()
    # at 2^14 rows and up the JAX package takes its doubling pipeline
    assert 1 + 2 * sum(len(c) + 1 for c in chroms) >= 1 << 14
    calls = []
    sharded = sharded_enum.enumerate_bifurcations_sharded

    def counted(*args):
        calls.append(args[1])
        return sharded(*args)

    monkeypatch.setattr(sharded_enum, "enumerate_bifurcations_sharded",
                        counted)
    monkeypatch.setenv("SIBELIA_TPU_FORCE_DEVICE_ENUM", "1")
    want_device = E.enumerate_bifurcations(chroms, k, 150)
    assert calls == [k]
    monkeypatch.delenv("SIBELIA_TPU_FORCE_DEVICE_ENUM")
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    want_host = E.enumerate_bifurcations(chroms, k)
    got = enumerate_bifurcations(chroms, k, 150, CPU)
    assert got.count > 0
    _assert_same_enum(got, want_device)
    assert want_host.count == got.count
    for s in (0, 1):
        for field in ("chr", "pos", "bif_id"):
            np.testing.assert_array_equal(getattr(got, field)[s],
                                          getattr(want_host, field)[s])


def test_doubling_shifts_match_jax():
    for k in range(33, 5001):
        assert doubling_shifts(k) == sharded_enum._doubling_shifts(k), k
    assert doubling_shifts(5000) == (32, 64, 128, 256, 512, 1024, 2048, 904)


@pytest.mark.parametrize("k", [33, 47, 90])
def test_kmer_ranks_are_dense_lexicographic_ranks(k):
    """Against the definition: the dense rank of each separator-free
    k-window among all of them in byte order, and n elsewhere."""
    rng = np.random.default_rng(k)
    chroms = [bytes(rng.choice(list(b"AAT"), size=int(n)).astype(np.uint8))
              for n in (300, 20, 90, 400)]
    chroms.append(chroms[0][:150])
    codes, _ = build_supergenome(chroms)
    n = codes.shape[0]
    text = codes.tobytes()
    windows = {i: text[i:i + k] for i in range(n - k + 1)
               if 0 not in text[i:i + k]}
    order = {w: r for r, w in enumerate(sorted(set(windows.values())))}
    want = np.full(n, n, dtype=np.int32)
    for i, w in windows.items():
        want[i] = order[w]
    got = kmer_ranks(torch.from_numpy(codes), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_kgt32_never_reaches_the_host_enumeration(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("k > 32 reached the host enumeration")

    monkeypatch.setattr(port_enum, "enumerate_bifurcations_host", refuse)
    # no size threshold: tiny and mid-sized supergenomes alike
    for chroms in (_all_t()[:1], [c[:500] for c in _strains()], _strains()):
        for k in (33, 100):
            got = enumerate_bifurcations(chroms, k, 150, CPU)
            assert got.count > 0
