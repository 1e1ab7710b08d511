"""Host lexicographic ranking of k-mers (copy of the host half of
``sibelia_tpu/index/ranking.py``; the device formulation is
``ranking_device.py``).

This replaces the reference's suffix array + LCP construction
(reference: src/vertexenumeration.cpp:103,292 divsufsort; :44-65 Kasai).
Only k-mer *grouping* and lexicographic *group order* are needed (that is
all the reference derives from the suffix array), so instead of a suffix
array we compute dense lexicographic ranks of the k-prefixes:

  1. base-4 pack: p_{2L}[i] = (p_L[i] << 2L) | p_L[i+L] builds 2^j-char
     packed words with log2(32) elementwise passes (memory-bound)
  2. k <= 32: ONE device sort of the overlapped packed pair
     (p16[i], p16[i+k-16]) yields the dense rank directly
  3. k > 32: dense 32-ranks from the packed sort, then chunked prefix
     doubling r_{L+off}(i) = dense_rank(r_L(i), r_L(i+off)), off = min(L,
     k-L) — ceil(log2(k/32))+1 more sorts (vs log2(k) char-level rounds)

Positions whose window crosses a separator get sentinel keys (they sort
to the end and are filtered by the enumeration); packing is over ACGT
codes only, so the 2-bit alphabet stays dense.

Equal final ranks == identical k-mers, and rank order == suffix-array
group order, which the reference uses to assign bifurcation ids — so ids
derived from these ranks match the reference's bit-for-bit.

This module keeps the pack plan and the sentinel that the device code
shares, the numpy ranking (the host enumeration under
``SIBELIA_TPU_NATIVE=0``) and the stable argsort they share (the native
radix sort of ``native/engine.cpp`` for large inputs).
"""
from __future__ import annotations

import numpy as np

# Character codes: order must match ASCII order of '#','A','C','G','T'
# so that rank order == the reference's suffix array order.
SEP_CODE = 0
CODE_OF = {"#": 0, "A": 1, "C": 2, "G": 3, "T": 4}

_SENT32 = np.uint32(0xFFFFFFFF)


def _stable_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort for uint64 keys: native radix sort for large inputs
    when the library is on (numpy's 'stable' for 64-bit ints is a
    comparison sort)."""
    if keys.size >= (1 << 18):
        from ..native import radix_argsort
        order = radix_argsort(keys)
        if order is not None:
            return order
    return np.argsort(keys, kind="stable").astype(np.int64)


def _pack_plan(k: int) -> tuple[int, int]:
    """(b, m): packed word width b (power of two) and covered length
    m = min(k, 32); key pair = (p_b[i], p_b[i + m - b])."""
    m = min(k, 32)
    b = 1
    while b * 2 <= m and b < 16:
        b *= 2
    # b is the largest power of two <= min(m, 16); the overlapped pair
    # covers m because b >= m - b (i.e. 2b >= m) by construction
    return b, m


# ---------------------------------------------------------------------------
# numpy path (the host enumeration under SIBELIA_TPU_NATIVE=0, tests)
# ---------------------------------------------------------------------------

def kmer_ranks_numpy(codes: np.ndarray, k: int):
    """Host twin of the device ranking with active-set refinement for
    k > 32: singleton groups can never gain members, so each doubling
    round re-sorts only positions whose 32-mer (then 64-mer, ...) is
    still ambiguous — i.e. true repeats, a small fraction of a genome.
    Ranks are group *bucket starts* (global sorted index of the group's
    first member), so refined subgroup ranks slot between frozen
    neighbors without renumbering the world.
    """
    n = int(codes.shape[0])
    b, m = _pack_plan(k)
    pad = 40
    c = np.concatenate([codes.astype(np.uint64), np.zeros(pad, np.uint64)])
    idx = np.arange(n + pad, dtype=np.int64)
    sep_idx = np.where(c == SEP_CODE, idx, n + pad)
    next_sep = np.minimum.accumulate(sep_idx[::-1])[::-1]
    p = (c - 1) & 3
    width = 1
    while width < b:
        shifted = np.concatenate([p[width:], np.zeros(width, np.uint64)])
        p = (p << np.uint64(2 * width)) | shifted
        width *= 2
    off = m - b
    valid = (np.arange(n, dtype=np.int64) + m) <= next_sep[:n]
    big = (p[:n] << np.uint64(32)) | p[off:off + n]
    big = np.where(valid, big, np.uint64(0xFFFFFFFFFFFFFFFF))
    order = _stable_argsort_u64(big)
    sb = big[order]
    new_grp = np.concatenate([[True], sb[1:] != sb[:-1]])
    # rank = index of the group's first member in sorted order (bucket
    # start), so refined subgroup ranks slot between frozen neighbors
    bucket_start = np.maximum.accumulate(
        np.where(new_grp, np.arange(n, dtype=np.int64), -1))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = bucket_start
    if k <= 32:
        return rank, order

    r = np.concatenate([rank, -(np.arange(k + 1, dtype=np.int64) + 2)])
    length = 32
    # active = sorted positions whose group may still split
    active_sorted = order.copy()
    grp_flag = new_grp.copy()
    while length < k:
        step = min(length, k - length)
        # drop singleton groups (they can never split further)
        if active_sorted.size:
            starts = np.flatnonzero(grp_flag)
            sizes = np.diff(np.append(starts, active_sorted.size))
            keep_group = sizes >= 2
            keep_mask = np.repeat(keep_group, sizes)
            active_sorted = active_sorted[keep_mask]
            grp_flag = grp_flag[keep_mask]
        if active_sorted.size == 0:
            break
        k1 = r[active_sorted]
        k2 = r[active_sorted + step]
        # pack (k1, k2) into one uint64 key: single radix sort instead of
        # lexsort's two passes (k2 may be a negative sentinel; bias it)
        key = ((k1.astype(np.uint64) << np.uint64(32))
               | ((k2 + (1 << 16)).astype(np.uint64) & np.uint64(0xFFFFFFFF)))
        sub = _stable_argsort_u64(key)
        active_sorted = active_sorted[sub]
        sk1 = k1[sub]
        sk2 = k2[sub]
        grp_flag = np.concatenate(
            [[True], (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])])
        # new bucket-start ranks: position of the group's first member in
        # the GLOBAL order = parent bucket start + offset within parent
        parent_start = sk1  # rank == parent bucket start (global index)
        within = np.arange(active_sorted.size, dtype=np.int64)
        parent_first = np.maximum.accumulate(
            np.where(np.concatenate([[True], sk1[1:] != sk1[:-1]]),
                     within, -1))
        sub_start = np.maximum.accumulate(np.where(grp_flag, within, -1))
        new_rank = parent_start + (sub_start - parent_first)
        r[active_sorted] = new_rank
        length += step

    final_rank = r[:n].copy()
    key = ((final_rank.astype(np.uint64) << np.uint64(32))
           | np.arange(n, dtype=np.uint64))
    order = _stable_argsort_u64(key)
    return final_rank, order

