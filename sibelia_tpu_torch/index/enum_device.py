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
from ..kernels.enum_scan import enum_segment_scan
from .ranking import _pack_plan
from .ranking_device import kmer_ranks, next_separator, packed_keys

# banded self-join width of the candidate prefilter, as in the JAX twin
# (whose module imports jax, so the value is restated here)
_CAND_BAND = 48


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
    ``sibelia_tpu/index/enum_device.py::_candidate_scan``."""
    n = codes.shape[0]
    B = pos.shape[0]
    dev = codes.device
    i64 = torch.int64
    next_sep = next_separator(codes)
    row_ok = torch.arange(B, device=dev) < n_sel
    p = torch.where(row_ok, pos.to(i64), n)
    ns = torch.where(row_ok, next_sep[p.clamp(max=n - 1)], 0)
    # the end char exists iff the (k+1)-window stays inside its block
    # (reference ProperKMer, src/dnasequence.h:154-165)
    ec = torch.where(row_ok & (p + k < ns),
                     codes[(p + k).clamp(max=n - 1)].to(i64), -1)
    v = torch.where(row_ok, ids.to(i64), B)
    pairs, pair_ec = [], []
    overflow = None
    for o in range(1, _CAND_BAND + 1):
        if o >= B:
            break
        mp = p[o:]
        gap = mp - p[:-o]
        ok = (row_ok[o:] & (ec[:-o] >= 0) & (gap >= 1) & (gap < min_branch)
              & (mp < ns[:-o]))
        if o == _CAND_BAND:
            # positions ascend, so an in-window member at the band edge
            # is the only way unseen pairs can exist beyond it
            overflow = ok
        owner = torch.nonzero(ok).squeeze(1)
        pairs.append((v[owner] << 32) | v[owner + o])
        pair_ec.append(ec[owner])
    cand = torch.zeros(B, dtype=torch.bool, device=dev)
    if pairs:
        key, perm = torch.sort(torch.cat(pairs))
        kec = torch.cat(pair_ec)[perm]
        hit = (key[1:] == key[:-1]) & (kec[1:] != kec[:-1])
        cand[key[1:][hit] >> 32] = True
    if overflow is not None:
        cand[v[:B - _CAND_BAND][overflow]] = True
    return cand
