"""Fused bifurcation enumeration and the bulge-candidate prefilter on the
device (twins of ``sibelia_tpu/index/enum_device.py`` for k <= 32, and of
the single-device ``sibelia_tpu/parallel/sharded_enum.py`` for k > 32).

For k <= 32 one sort of the packed key pair puts every valid position in
k-mer order as a prefix of ``nv`` rows.  For k > 32 prefix doubling
(``ranking_device.kmer_ranks``) gives each valid position the dense rank of
its k-mer, and one sort of the ranks does the same.  Either way the
segment scan kernel (``kernels/enum_scan.py``) then applies the bifurcation
and counting rule (reference: src/vertexenumeration.cpp:67-70,227-245),
assigns dense ids and selects instances, and a last sort packs the
selected positions ascending.  See ``_enum_device_impl`` there for the
algebra; ``sharded_enum.py``'s final scan computes the same.
"""
from __future__ import annotations

import torch

from ..core.convert import pack_sort_key, unpack_sort_key
from ..core.platform import card_free_bytes, sync_wait
from ..kernels.enum_scan import enum_segment_scan
from .ranking import _pack_plan
from .ranking_device import kmer_ranks, next_separator, packed_keys

# banded self-join width of the candidate prefilter, as in the JAX twin
# (whose module imports jax, so the value is restated here)
_CAND_BAND = 48
# device bytes of one band pair at the prefilter's sort: its owner and
# member rows, key and end char, and the sort's keys, indices and scratch
PAIR_BYTES = 80
# the prefilter's pairs get at least this many bytes a supergenome row,
# and on a card half of what it can give, before they are sorted by ranges
# of owner ids (their count grows with the strains: 16 related strains own
# about 1.9 pairs a row, 150 B)
PAIR_ROW_BUDGET = 64


def sorted_columns(codes: torch.Tensor, k: int):
    """(sk1, sk2, saux, order, nv): the int32 columns the segment scan
    reads, sorted by k-mer with the nv valid rows first, and nv as a 0-d
    int32 tensor.  For k > 32 sk1 is the k-mer's rank and sk2 is zero."""
    n = codes.shape[0]
    dev = codes.device
    i32 = torch.int32
    c = codes.to(i32)
    prev_all = torch.cat([c[:1], c[:-1]])  # row 0 keeps its own code
    next_all = torch.zeros_like(c)
    next_all[:max(n - k, 0)] = c[k:]
    aux = (prev_all << 3) | next_all  # 6 bits; only valid rows matter
    del c, prev_all, next_all
    if k > 32:
        # invalid rows rank n, after every valid one
        rank = kmer_ranks(codes, k)
        sk1, order = torch.sort(rank)
        nv = (rank < n).sum(dtype=i32)
        del rank
        order = order.to(i32)
        return sk1, torch.zeros_like(sk1), aux[order], order, nv
    key1, key2, next_sep = packed_keys(codes, k)
    b, m = _pack_plan(k)
    iota = torch.arange(n, dtype=i32, device=dev)
    valid = iota + k <= next_sep
    if m <= 31:
        # spare low bit: the invalid sentinel sorts after every valid key
        sk2v = (key2 & ((1 << (2 * (m - b))) - 1)) << 1
        sk2v = torch.where(valid, sk2v, 0xFFFFFFFF)
        skey, order = torch.sort(pack_sort_key(key1, sk2v))
        sk1, sk2 = unpack_sort_key(skey)
    else:
        # k == 32 fills all 64 key bits, and a real all-T window has the
        # sentinel's keys: sort the valid rows only and append the rest
        vidx = valid.nonzero().squeeze(1)
        skey, perm = torch.sort(pack_sort_key(key1[vidx], key2[vidx]))
        order = torch.cat([vidx[perm], (~valid).nonzero().squeeze(1)])
        hi, lo = unpack_sort_key(skey)
        tail = torch.full((n - vidx.shape[0],), -1, dtype=i32, device=dev)
        sk1, sk2 = torch.cat([hi, tail]), torch.cat([lo, tail])
    order = order.to(i32)
    return sk1, sk2, aux[order], order, valid.sum(dtype=i32)


def fused_enumeration(codes: torch.Tensor, k: int):
    """(pos_sorted, id_sorted, n_sel, n_groups) for uint8 '#ACGT' codes and
    any k: the first n_sel rows are the selected supergenome positions,
    ascending, with their dense bifurcation ids; n_sel and n_groups are
    0-d tensors."""
    sk1, sk2, saux, order, nv = sorted_columns(codes, k)
    ids, poskey, n_groups, n_sel = enum_segment_scan(
        sk1, sk2, saux, order, nv, codes.shape[0])
    del sk1, sk2, saux, order
    pos_sorted, perm = torch.sort(poskey)
    return pos_sorted, ids[perm], n_sel, n_groups


def candidate_scan(codes: torch.Tensor, pos: torch.Tensor, ids: torch.Tensor,
                   k: int, min_branch: int, n_sel: int) -> torch.Tensor:
    """Bulge-candidate prefilter over the position-sorted instance table
    (reference: src/bulgeremoval.cpp:158-218): bool[B], True for an id
    whose instances reach a common member with two distinct end chars
    within min_branch steps.  Rows >= n_sel of pos/ids (int32 or int64
    [B]) are
    padding; the result is indexed by id.  Owners whose band of
    _CAND_BAND rows overflows are flagged conservatively.  Same bitmap as
    ``sibelia_tpu/index/enum_device.py::_candidate_scan``.

    Positions ascend, so row i's members are one run of rows, found by
    three searches, and the (owner id, member id) pairs are laid out from
    the runs with no pass a band offset.  They are sorted together, at
    PAIR_BYTES each, when they fit the budget: PAIR_ROW_BUDGET bytes a
    supergenome row, or on a card half of what ``card_free_bytes`` gives
    if that is more.  Else the owner ids are cut into ranges of at most
    the budget's pairs each (plus one owner's band), sorted one after
    another: a pair's group lies in its owner's range, so the bitmap is
    the same, and the peak stays within the budget.  Blocking copies: one
    for the edge owners, one counting the pairs, one for the hits of each
    range; when cut, two for each cut (``_owner_ranges``) and one for each
    range's owners, with a pass over the B rows."""
    n = codes.shape[0]
    B = pos.shape[0]
    dev = codes.device
    i64 = torch.int64
    next_sep = next_separator(codes)
    row_ok = torch.arange(B, device=dev) < n_sel
    p = torch.where(row_ok, pos.to(i64), n)
    ns = torch.where(row_ok, next_sep[p.clamp(max=n - 1)], 0)
    del next_sep
    # the end char exists iff the (k+1)-window stays inside its block
    # (reference ProperKMer, src/dnasequence.h:154-165)
    ec = torch.where(row_ok & (p + k < ns),
                     codes[(p + k).clamp(max=n - 1)].to(i64), -1)
    v = torch.where(row_ok, ids.to(i64), B)
    band = max(min(_CAND_BAND, B - 1), 0)
    # row i's members: after its position (gap >= 1), less than min_branch
    # past it, before its next separator, among the real rows, within the
    # band: the rows first[i] .. end[i] - 1
    rows_at = torch.arange(B, device=dev)
    first = torch.maximum(torch.searchsorted(p, p + 1), rows_at + 1)
    end = torch.minimum(torch.searchsorted(p, p + min_branch),
                        torch.searchsorted(p, ns)).clamp(max=n_sel)
    # the band's last member is in reach: owners(_CAND_BAND) of the JAX twin
    edge = (ec >= 0) & (first <= rows_at + _CAND_BAND) & (
        rows_at + _CAND_BAND < end)
    end = torch.minimum(end, rows_at + 1 + band)
    reach = torch.where(ec >= 0, (end - first).clamp(min=0), 0)
    del p, ns, row_ok, end, rows_at
    cand = torch.zeros(B, dtype=torch.bool, device=dev)
    if _CAND_BAND < B:
        # an in-window member at the band edge is the only way unseen
        # pairs can exist beyond it
        cand[v[edge]] = True
    del edge
    pair_budget = max(PAIR_ROW_BUDGET * n, (card_free_bytes(dev) or 0) // 2)
    with sync_wait("candidate_pairs"):
        total = int(reach.sum())
    ranges = [(0, B + 1, total)]
    if PAIR_BYTES * total > pair_budget:
        ranges = _owner_ranges(v, reach, B, max(pair_budget // PAIR_BYTES, 1))
    for lo, hi, pairs in ranges:
        if not pairs:
            continue
        mine = reach > 0
        if len(ranges) > 1:
            mine &= (v >= lo) & (v < hi)
        rows = torch.nonzero(mine).squeeze(1)
        r = reach[rows]
        # owner and member row of each pair: owner i, members first[i]..
        owner = torch.repeat_interleave(rows, r, output_size=pairs)
        member = torch.arange(pairs, device=dev).add_(torch.repeat_interleave(
            first[rows] - (torch.cumsum(r, 0) - r), r, output_size=pairs))
        del rows, r
        key = (v[owner] << 32).bitwise_or_(v[member])
        del member
        kec = ec[owner]
        del owner
        key, perm = torch.sort(key)
        kec = kec[perm]
        del perm
        hit = (key[1:] == key[:-1]) & (kec[1:] != kec[:-1])
        cand[key[1:][hit] >> 32] = True
    return cand


def _owner_ranges(v: torch.Tensor, reach: torch.Tensor, B: int,
                  per_range: int) -> list[tuple[int, int, int]]:
    """Cut the owner ids [0, B] into ranges (lo, hi, pairs) of at most
    `per_range` band pairs each (an id with more is a range of its own),
    `reach` pairs owned by each row: one blocking copy for the total, two
    for each cut."""
    cum = torch.cumsum(torch.zeros(B + 1, dtype=torch.int64, device=v.device)
                       .index_add_(0, v, reach), 0)  # pairs up to each id
    cuts, before, total = [0], 0, int(cum[-1])
    counts = []
    while total - before > per_range:
        # the range ends before the first id that passes the budget
        with sync_wait("candidate_ranges"):
            hi = max(int(torch.searchsorted(cum, before + per_range,
                                            right=True)), cuts[-1] + 1)
        if hi > B:
            break
        cuts.append(hi)
        with sync_wait("candidate_ranges"):
            counts.append(int(cum[hi - 1]) - before)
        before += counts[-1]
    cuts.append(B + 1)
    counts.append(total - before)
    return list(zip(cuts[:-1], cuts[1:], counts))
