"""Port vs JAX: enumerate_bifurcations with the candidate bitmap, and the
engine's device re-prefilter on a live engine export.  Exact equality."""
import ctypes

import numpy as np
import pytest
import torch

import sibelia_tpu.native as native
from sibelia_tpu.core.platform import device_dispatch
from sibelia_tpu.graph.sequence import MutableSequence
from sibelia_tpu.index import enumeration as E
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations
from sibelia_tpu_torch.native.engine_runner import device_reprefilter
from tests.test_wave_device import _genomes

CPU = torch.device("cpu")


def _assert_same_enum(got, want):
    assert got.count == want.count
    for s in (0, 1):
        for field in ("chr", "pos", "bif_id"):
            a, b = getattr(got, field)[s], getattr(want, field)[s]
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    if want.candidates is None:
        assert got.candidates is None
    else:
        assert got.candidates.dtype == want.candidates.dtype == np.uint8
        np.testing.assert_array_equal(got.candidates, want.candidates)


@pytest.mark.parametrize("k,min_branch", [(11, 80), (30, 150), (32, None),
                                          (40, None)])
def test_enumerate_bifurcations_matches_jax_device(monkeypatch, k,
                                                   min_branch):
    chroms = _genomes(n_mut=120, size=7000, n_strains=3)
    monkeypatch.setenv("SIBELIA_TPU_FORCE_DEVICE_ENUM", "1")
    want = E.enumerate_bifurcations(chroms, k, min_branch)
    # the port reads only its own variable and leaves the JAX package's
    # dispatch as it found it
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
    got = enumerate_bifurcations(chroms, k, min_branch)
    assert device_dispatch()
    assert got.count > 0
    _assert_same_enum(got, want)


def _live_engine(genomes, k):
    """An engine holding a fresh enumeration of `genomes` at k."""
    lib = native.load()
    native._configure_reprefilter_api(lib)
    seq = MutableSequence([np.frombuffer(g, np.uint8).copy() for g in genomes])
    enum = E.enumerate_bifurcations(list(genomes), k)
    n_chr = seq.n_chr
    bufs = [np.ascontiguousarray(seq.chars[c]) for c in range(n_chr)]
    ops = [np.ascontiguousarray(seq.origpos[c], dtype=np.int32)
           for c in range(n_chr)]
    handle = lib.engine_create(
        n_chr, (ctypes.c_int64 * n_chr)(*[len(b) for b in bufs]),
        (ctypes.c_void_p * n_chr)(*[b.ctypes.data for b in bufs]),
        (ctypes.c_void_p * n_chr)(*[b.ctypes.data for b in ops]),
        (ctypes.c_int64 * n_chr)(*seq.sep_origpos))
    lens = np.asarray([len(b) for b in bufs], dtype=np.int64)
    wire = []
    for s in (0, 1):
        chrs = enum.chr[s].astype(np.int32)
        pos = enum.pos[s].astype(np.int64)
        coords = pos if s == 0 else lens[chrs] - 1 - pos
        wire += [chrs, coords.astype(np.int32), enum.bif_id[s].astype(np.uint32)]
    lib.engine_set_bifs(handle, enum.count, len(wire[0]),
                        *[a.ctypes.data for a in wire[:3]], len(wire[3]),
                        *[a.ctypes.data for a in wire[3:]])
    return lib, handle, n_chr, enum.count, (bufs, ops, wire)


@pytest.mark.parametrize("k,d", [(11, 80), (11, 25)])
def test_device_reprefilter_matches_jax(k, d):
    if native.load() is None:
        pytest.skip("native engine unavailable")
    genomes = _genomes(n_mut=300, size=16000, n_strains=4)
    lib, handle, n_chr, count, _keep = _live_engine(genomes, k)
    try:
        want = native._device_reprefilter(lib, handle, n_chr, k, d, count)
        got = device_reprefilter(lib, handle, n_chr, k, d, count, CPU)
    finally:
        lib.engine_destroy(handle)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < count
