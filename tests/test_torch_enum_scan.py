"""Port vs JAX: the post-sort segment scan.

The port's plain version (sibelia_tpu_torch/kernels/enum_scan.py) against
the Pallas kernels in interpret mode and against the XLA formulation of
tests/test_enum_scan.py, and the CUDA kernel against the plain version
on the card.  Integer outputs: exact equality.

JAX is imported inside the tests that compare with it, so the CUDA test
also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_enum_scan.py``."""
import numpy as np
import pytest
import torch

from chip_smoke import off_boundary, scan_edge_cases
from sibelia_tpu_torch.core.convert import u32_to_i32
from sibelia_tpu_torch.core.platform import LAUNCHES
from sibelia_tpu_torch.kernels.enum_scan import (TILE_ROWS, enum_segment_scan,
                                                 enum_segment_scan_plain)

TILE = 256 * 128  # rows per grid step of the Pallas kernels


def _segments(rng, n, max_len):
    """Sorted key columns of random segment lengths in [1, max_len]
    (as tests/test_enum_scan.py builds them)."""
    k1 = np.zeros(n, np.uint32)
    k2 = np.zeros(n, np.uint32)
    i = v = 0
    while i < n:
        length = int(rng.integers(1, max_len + 1))
        k1[i:i + length] = v // 5
        k2[i:i + length] = v
        i += length
        v += 1
    return k1, k2


def _inputs(seed: int, n: int, max_len: int):
    rng = np.random.default_rng(seed)
    k1, k2 = _segments(rng, n, max_len)
    aux = rng.integers(0, 64, size=n).astype(np.uint32)
    order = rng.permutation(n).astype(np.int32)
    return rng, k1, k2, aux, order


def _torch_cols(k1, k2, aux, order, device="cpu"):
    return tuple(u32_to_i32(torch.from_numpy(a.astype(np.int64))).to(device)
                 for a in (k1, k2, aux)) + (torch.from_numpy(order).to(device),)


def _assert_same(got, want):
    ids, poskey, ng, ns = got
    r_ids, r_poskey, r_ng, r_ns = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ids.cpu().numpy(), r_ids)
    np.testing.assert_array_equal(poskey.cpu().numpy(), r_poskey)
    assert int(ng) == int(r_ng) and int(ns) == int(r_ns)


@pytest.mark.parametrize("seed,max_len,tiles", [(0, 8, 2), (2, 300, 3)])
def test_plain_matches_pallas_interpret(seed, max_len, tiles):
    import jax.numpy as jnp

    from sibelia_tpu.kernels.enum_scan import \
        enum_segment_scan as pallas_segment_scan
    n = tiles * TILE
    rng, k1, k2, aux, order = _inputs(seed, n, max_len)
    nv = np.int32(n - int(rng.integers(0, n // 3)))
    want = pallas_segment_scan(jnp.asarray(k1), jnp.asarray(k2),
                               jnp.asarray(aux), jnp.asarray(order), True,
                               jnp.asarray(nv), n)
    got = enum_segment_scan(*_torch_cols(k1, k2, aux, order), int(nv), n)
    _assert_same(got, want)


def _nv_cases(k1, k2, n):
    """nv = 0, n, and one row inside a segment of several rows (the
    middle row where no segment has two)."""
    inner = np.flatnonzero((k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])) + 1
    return [0, n, int(inner[len(inner) // 2]) if len(inner) else n // 2]


@pytest.mark.parametrize("n,max_len", [(1, 4), (1000, 1), (5003, 300)])
def test_plain_matches_xla_any_n(n, max_len):
    import jax.numpy as jnp

    from tests.test_enum_scan import _xla_reference
    _, k1, k2, aux, order = _inputs(n, n, max_len)
    for nv in _nv_cases(k1, k2, n):
        want = _xla_reference(jnp.asarray(k1), jnp.asarray(k2),
                              jnp.asarray(aux), jnp.asarray(order),
                              jnp.int32(nv), n)
        got = enum_segment_scan(*_torch_cols(k1, k2, aux, order), nv, n)
        _assert_same(got, want)


SMALL_TILE = 64  # the edge cases at a small n, laid around this tile
EDGE_NAMES = [name for name, _, _ in scan_edge_cases(SMALL_TILE)]


@pytest.mark.parametrize("index", range(len(EDGE_NAMES)), ids=EDGE_NAMES)
def test_edge_cases_match_xla_and_pallas_interpret(index):
    """The cases the CUDA kernel is held to on the card (chip_smoke.py
    phase 2, there at the kernel's own tile), through the plain version:
    against the XLA formulation as they are, and against the Pallas
    kernels in interpret mode on the same columns padded to one Pallas
    tile with single-row segments."""
    import jax.numpy as jnp

    from sibelia_tpu.kernels.enum_scan import \
        enum_segment_scan as pallas_segment_scan
    from tests.test_enum_scan import _xla_reference
    _, cols, nvs = scan_edge_cases(SMALL_TILE)[index]
    n = len(cols[0])
    pad = np.arange(1, TILE - n + 1, dtype=np.int32)
    padded = [np.concatenate([cols[0], cols[0][-1] + pad]),
              np.concatenate([cols[1], cols[1][-1] + pad]),
              np.concatenate([cols[2], np.full(TILE - n, 9, np.int32)]),
              np.concatenate([cols[3], n + pad - 1])]
    for nv in nvs:
        want = _xla_reference(*(jnp.asarray(c) for c in cols), jnp.int32(nv),
                              n)
        got = enum_segment_scan(*(torch.from_numpy(c) for c in cols), nv, n)
        _assert_same(got, want)
        want = pallas_segment_scan(*(jnp.asarray(c) for c in padded), True,
                                   jnp.asarray(np.int32(nv)), TILE)
        got = enum_segment_scan(*(torch.from_numpy(c) for c in padded), nv,
                                TILE)
        _assert_same(got, want)


def test_cpu_tensors_take_the_plain_version():
    _, k1, k2, aux, order = _inputs(5, 300, 7)
    before = dict(LAUNCHES)
    enum_segment_scan(*_torch_cols(k1, k2, aux, order), 200, 300)
    assert LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_len", [(1, 1), (1000, 300), (32768 + 7, 300),
                                       ((1 << 20) + 13, 300)])
def test_cuda_kernel_matches_plain(n, max_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, k1, k2, aux, order = _inputs(n, n, max_len)
    cols = _torch_cols(k1, k2, aux, order, "cuda")
    for nv in _nv_cases(k1, k2, n):
        got = enum_segment_scan(*cols, nv, n)
        want = enum_segment_scan_plain(*cols, nv, n)
        torch.cuda.synchronize()
        _assert_same(got, tuple(x.cpu() for x in want))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_edge_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, cols, nvs in scan_edge_cases(TILE_ROWS):
        cols = [torch.from_numpy(c).cuda() for c in cols]
        n = cols[0].shape[0]
        for cs in (cols, [off_boundary(c) for c in cols]):
            for nv in nvs:
                got = enum_segment_scan(*cs, nv, n)
                want = enum_segment_scan_plain(*cs, nv, n)
                torch.cuda.synchronize()
                _assert_same(got, tuple(x.cpu() for x in want))
