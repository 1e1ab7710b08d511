"""Packed k-mer keys and k > 32 ranks by prefix doubling on the device.

``packed_keys`` is the twin of
``sibelia_tpu/index/ranking_device.py::_packed_keys``.  See
``sibelia_tpu/index/ranking.py`` for the algorithm: base-4 words of ``b``
characters built by doubling passes, and the overlapped pair
``(p_b[i], p_b[i + m - b])`` covering ``m = min(k, 32)`` characters.

``kmer_ranks`` is the single-device algebra of the ranking rounds of
``sibelia_tpu/parallel/sharded_enum.py`` (``_build_step``, ``_rank_round``)
with the mesh machinery (owners, splitters, all_to_all, capacities,
overflow retry) dropped: on one device it is the identity.
"""
from __future__ import annotations

import torch

from ..core.convert import pack_sort_key
from .ranking import _SENT32, SEP_CODE, _pack_plan

_PAD = 40  # >= the widest overlap offset the pair reads past n


def next_separator(codes: torch.Tensor) -> torch.Tensor:
    """int64[n]: index of the first separator at or after each position
    (n where none follows).  The JAX twin's reverse running minimum, as a
    search over the separator positions: torch.cummin took 187 ms a call
    at 64 M rows on an H100 80GB HBM3 (700 W power limit)."""
    n = codes.shape[0]
    seps = torch.nonzero(codes == SEP_CODE).squeeze(1)
    seps = torch.cat([seps, seps.new_full((1,), n)])
    idx = torch.arange(n, dtype=torch.int64, device=codes.device)
    return seps[torch.searchsorted(seps, idx)]


def packed_keys(codes: torch.Tensor, k: int):
    """(key1, key2, next_sep) for '#ACGT' codes (0..4): the packed key
    pair as int64 holding uint32 values, the sentinel 0xFFFFFFFF where the
    min(k, 32)-window crosses a separator, and the int32 next-separator
    index over the codes padded with _PAD separators."""
    n = codes.shape[0]
    dev = codes.device
    b, m = _pack_plan(k)
    c = torch.zeros(n + _PAD, dtype=torch.int64, device=dev)
    c[:n] = codes
    next_sep = next_separator(c)[:n]
    p = (c - 1) & 3
    width = 1
    while width < b:
        shifted = torch.zeros_like(p)
        shifted[:-width] = p[width:]
        p = (p << (2 * width)) | shifted
        width *= 2
    off = m - b
    valid = torch.arange(n, dtype=torch.int64, device=dev) + m <= next_sep
    sent = int(_SENT32)
    key1 = torch.where(valid, p[:n], sent)
    key2 = torch.where(valid, p[off:off + n], sent)
    return key1, key2, next_sep.to(torch.int32)


def doubling_shifts(k: int) -> tuple[int, ...]:
    """Prefix-doubling shifts that take the min(k, 32)-char keys to cover
    exactly k chars, the last one overlapping (restated from
    ``sibelia_tpu/parallel/sharded_enum.py::_doubling_shifts``, whose
    module imports jax)."""
    shifts = []
    cover = min(k, 32)
    while cover < k:
        shifts.append(min(cover, k - cover))
        cover += shifts[-1]
    return tuple(shifts)


def dense_ranks(key: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n]: the dense rank of each int64 `key` among all keys,
    ascending, at its row `rows` (int64 indices of the valid rows); n at
    every other row.  The ranks go back to position order by a scatter."""
    skey, perm = torch.sort(key)
    newgrp = torch.ones(skey.shape, dtype=torch.bool, device=skey.device)
    newgrp[1:] = skey[1:] != skey[:-1]
    del skey
    rank = torch.full((n,), n, dtype=torch.int32, device=key.device)
    rank[rows[perm]] = torch.cumsum(newgrp, 0, dtype=torch.int32) - 1
    return rank


def kmer_ranks(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int32[n] for '#ACGT' codes and k > 32: the dense rank of the
    k-window at each position in lexicographic order, over the windows
    that cross no separator; n at every other position.

    The first round ranks the 32-char packed key pair, later rounds rank
    ``(rank[i], rank[i + shift])`` at ``cover += shift``.  Each round ranks
    only the rows whose cover window is separator-free; validity travels
    out of band, so a real all-T window never meets the sentinel key."""
    n = codes.shape[0]
    key1, key2, next_sep = packed_keys(codes, k)
    iota = torch.arange(n, dtype=torch.int32, device=codes.device)
    cover = 32
    rows = (iota + cover <= next_sep).nonzero().squeeze(1)
    rank = dense_ranks(pack_sort_key(key1[rows], key2[rows]), rows, n)
    del key1, key2
    for shift in doubling_shifts(k):
        cover += shift
        # a row valid at the new cover has row + shift valid at the old
        # one and inside the array, so the gather needs no clamp
        rows = (iota + cover <= next_sep).nonzero().squeeze(1)
        key = (rank[rows].to(torch.int64) << 32) | rank[rows + shift]
        del rank
        rank = dense_ranks(key, rows, n)
        del key, rows
    return rank
