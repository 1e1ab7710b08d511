"""Bifurcation enumeration over a mesh of shards (twin of
``sibelia_tpu/parallel/sharded_enum.py``).

The supergenome is cut into position shards of L rows.  Each shard
extends its codes by a halo of the next shard's first k + 8 (ppermute),
builds its packed keys (``ranking_device.packed_keys``), and ranks them by
a distributed sample sort: a local sort, splitters from 64 gathered
order statistics a shard, an exchange of the rows into contiguous key
ranges, a local dense ranking offset by the lower shards' group counts,
and the ranks routed back to their positions.  k > 32 refines by prefix
doubling: each round pairs ``(rank[i], rank[i + shift])``, where the
ranks past the shard's end come from the next shard's first ``shift``
(a halo, in place of the JAX package's all_gather of the whole rank
vector), and ranks the pairs with the same exchange.  The scan phase
routes (rank, prev << 3 | next, position) to rank-range owners (an
even share of the groups each), so a k-mer group lives whole on one
shard, and each non-empty shard runs the
segment scan kernel (``kernels/enum_scan.py::enum_segment_scan``) on its
rows sorted by rank: ``sk1`` the rank, ``sk2`` zero, ``saux`` the
neighbour codes, ``order`` the position, every row real.  Its ids are
offset by the lower shards' group counts; the selected (position, id)
rows are gathered, sorted by position and mapped to the strands.

Owners are monotone in the key order (int64 sort keys whose signed order
is the unsigned order of the JAX package's uint32 pairs), so the ids are
the single-device ids, for any mesh size (tests/test_torch_sharded_enum.py).
Validity travels out of band: a real all-T window packs to the invalid
sentinel, so invalid rows never enter an exchange.

Exchanges use exact split sizes (``parallel/sharded.py``): the counts go
first, then the rows, so there is no capacity and no overflow retry.  A
k <= 32 enumeration makes three exchanges (16 B a valid row out and back,
then 12 B a valid row to the scan's owners), each round of k > 32 two
more; each costs one blocking copy of the counts (``enum_scalar``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import timings
from ..core.convert import download, pack_sort_key, to_tensor
from ..core.platform import sync_wait
from ..index.enumeration import (BifEnumeration, _empty_enumeration,
                                 _map_selected, build_supergenome)
from ..index.ranking import _pack_plan
from ..index.ranking_device import doubling_shifts, packed_keys
from ..kernels.enum_scan import enum_segment_scan
from .sharded import Mesh

_SAMPLES = 64  # per-shard order-statistic samples for splitter selection
_KEY_MAX = (1 << 63) - 1  # a sample past a shard's valid rows


def _owner_of(key: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """Contiguous range owner of each int64 sort key: the count of
    splitters strictly below it.  A function of the key alone, so equal
    keys share an owner and key groups never straddle shards."""
    return torch.searchsorted(splitters, key)


def _exchange(mesh: Mesh, rows: list[torch.Tensor],
              owner: list[torch.Tensor]) -> list[torch.Tensor]:
    """Send each shard's rows (sorted by owner) to their owners; each
    shard receives its rows ordered by source shard."""
    counts = [torch.bincount(o, minlength=mesh.size) for o in owner]
    return mesh.all_to_all(rows, counts)


def _splitters(mesh: Mesh, skeys: list[torch.Tensor], L: int
               ) -> list[torch.Tensor]:
    """n - 1 splitters on each shard: order statistics of the gathered
    samples at L * i / 64 of each shard's sorted valid keys (the key
    maximum past them)."""
    samp = (torch.arange(_SAMPLES) * L) // _SAMPLES
    picks = []
    for skey in skeys:
        nv = skey.shape[0]
        at = samp.to(skey.device)
        vals = skey[at.clamp(max=max(nv - 1, 0))] if nv else \
            torch.full((_SAMPLES,), _KEY_MAX, device=skey.device)
        picks.append(torch.where(at < nv, vals, _KEY_MAX))
    n = mesh.size
    idx = (torch.arange(1, n) * (n * _SAMPLES)) // n
    return [torch.sort(g).values[idx.to(g.device)]
            for g in mesh.all_gather(picks)]


def _offsets(mesh: Mesh, counts: list[torch.Tensor]):
    """Each local shard's exclusive sum of the lower shards' counts, and
    the sum of all (0-d tensors on its device)."""
    every = mesh.all_gather([c.reshape(1) for c in counts])
    return ([g[:d].sum() for g, d in zip(every, mesh.local_shards())],
            [g.sum() for g in every])


def _rank_round(mesh: Mesh, keys: list[torch.Tensor],
                vflags: list[torch.Tensor], L: int, N: int):
    """One distributed ranking round: the dense global rank of each int64
    key among the keys with vflag set, back in position order (int32[L]
    a shard), and N at every other position; and the number of distinct
    keys (a 0-d tensor a shard)."""
    skeys, sgpos = [], []
    for key, vflag, d in zip(keys, vflags, mesh.local_shards()):
        rows = vflag.nonzero().squeeze(1)
        skey, perm = torch.sort(key[rows])
        skeys.append(skey)
        sgpos.append(rows[perm] + d * L)
    splitters = _splitters(mesh, skeys, L)
    owners = [_owner_of(s, spl) for s, spl in zip(skeys, splitters)]
    recv = _exchange(mesh, [torch.stack([s, g], 1)
                            for s, g in zip(skeys, sgpos)], owners)
    del skeys, sgpos, owners
    # dense ranks of the owned key range, offset by the lower ranges
    granks, ggpos, n_groups = [], [], []
    for r in recv:
        okey, perm = torch.sort(r[:, 0])
        newgrp = torch.ones(okey.shape, dtype=torch.int64, device=r.device)
        newgrp[1:] = okey[1:] != okey[:-1]
        del okey
        granks.append(torch.cumsum(newgrp, 0) - 1)
        ggpos.append(r[perm, 1])
        n_groups.append(newgrp.sum())
    del recv
    base, groups = _offsets(mesh, n_groups)
    # route (position, rank) back to the position's shard
    sends, owners = [], []
    for grank, gp, b in zip(granks, ggpos, base):
        order = torch.argsort(gp)
        gp = gp[order]
        sends.append(torch.stack([gp, grank[order] + b], 1))
        owners.append(gp // L)
    back = _exchange(mesh, sends, owners)
    out = []
    for r, d in zip(back, mesh.local_shards()):
        rank = torch.full((L,), N, dtype=torch.int32, device=r.device)
        rank[r[:, 0] - d * L] = r[:, 1].to(torch.int32)
        out.append(rank)
    return out, groups


def _scan_phase(mesh: Mesh, ranks, groups, auxs, gposs, valids, N: int):
    """Route the valid (rank, aux, position) rows to rank-range owners,
    run the segment scan on every non-empty shard, and return each local
    shard's selected int64 (position, id) rows and the group total.

    A shard owns a contiguous range of ``ceil(groups / n)`` ranks.  The
    JAX package's range is ``ceil(N / n)``, which sends every group to the
    lowest shards when the k-mers are fewer than the rows (related
    strains: all of them to shard 0); the ranges only decide where a
    group is scanned, not its id."""
    sends, owners = [], []
    for rank, g, aux, gpos, valid in zip(ranks, groups, auxs, gposs,
                                         valids):
        chunk = ((g + mesh.size - 1) // mesh.size).clamp(min=1)
        rows = valid.nonzero().squeeze(1)
        srank, perm = torch.sort(rank[rows])
        rows = rows[perm]
        sends.append(torch.stack([srank, aux[rows], gpos[rows]], 1))
        owners.append(srank.to(torch.int64) // chunk)
    recv = _exchange(mesh, sends, owners)
    del sends, owners
    scanned, n_groups = [], []
    for r in recv:
        if r.shape[0] == 0:
            # the scan refuses 0 rows: an empty shard counts no group
            none = r.new_zeros(0)
            scanned.append((none, none))
            n_groups.append(none.sum(dtype=torch.int64))
            continue
        sk1, perm = torch.sort(r[:, 0])
        ids, poskey, n_grp, _ = enum_segment_scan(
            sk1, torch.zeros_like(sk1), r[perm, 1].contiguous(),
            r[perm, 2].contiguous(), r.shape[0], N)
        scanned.append((ids, poskey))
        n_groups.append(n_grp.to(torch.int64))
    base, total = _offsets(mesh, n_groups)
    selected = []
    for (ids, poskey), b in zip(scanned, base):
        sel = poskey < N
        selected.append(torch.stack([poskey[sel].to(torch.int64),
                                     ids[sel].to(torch.int64) + b], 1))
    return selected, total[0]


def _build_step(k: int, L: int, mesh: Mesh, codes: list[torch.Tensor]):
    """The whole sharded enumeration of the local shards' codes (uint8[L]
    each): their selected (position, id) rows and the group total."""
    N = mesh.size * L
    HK = k + 8
    m = _pack_plan(k)[1]
    i32 = torch.int32
    # ---- halo, keys, validity, neighbour codes
    nxt = mesh.ppermute([c[:HK] for c in codes], 1)
    prv = mesh.ppermute([c[-1:] for c in codes], -1)
    keys, next_seps, auxs, gposs = [], [], [], []
    for c, h, p, d in zip(codes, nxt, prv, mesh.local_shards()):
        ext = torch.cat([c, h])
        key1, key2, next_sep = packed_keys(ext, k)
        keys.append(pack_sort_key(key1[:L], key2[:L]))
        del key1, key2
        next_seps.append(next_sep[:L])
        # the wrapped halos at the mesh's ends are separators: the text
        # begins and ends with one
        prev_c = torch.cat([p, c[:-1]]).to(i32)
        auxs.append((prev_c << 3) | ext[k:k + L].to(i32))
        gposs.append(torch.arange(d * L, d * L + L, dtype=i32,
                                  device=c.device))
    iota = [torch.arange(L, dtype=i32, device=c.device) for c in codes]

    def valid_at(cover: int) -> list[torch.Tensor]:
        return [i + cover <= ns for i, ns in zip(iota, next_seps)]

    # ---- ranking rounds: rank each position whose current cover window
    # is separator-free (a k-valid position's sub-windows all are)
    cover = m
    ranks, groups = _rank_round(mesh, keys, valid_at(cover), L, N)
    del keys
    last = mesh.size - 1
    for shift in doubling_shifts(k):
        cover += shift
        heads = mesh.ppermute([r[:shift] for r in ranks], 1)
        keys = []
        for r, h, d in zip(ranks, heads, mesh.local_shards()):
            if d == last:
                h = torch.full_like(h, N)
            shifted = torch.cat([r[shift:], h])
            keys.append((r.to(torch.int64) << 32) | shifted.to(torch.int64))
        del heads
        ranks, groups = _rank_round(mesh, keys, valid_at(cover), L, N)
        del keys
    # ---- scan phase on the rank-range owners
    return _scan_phase(mesh, ranks, groups, auxs, gposs, valid_at(k), N)


def shard_rows(n: int, n_dev: int, k: int) -> int:
    """Rows of one shard: the JAX package's L (a multiple of 1024, at
    least 2048 and k + 16)."""
    L = -(-n // n_dev)
    L = max(-(-L // 1024) * 1024, 2048)
    while L < k + 16:
        L *= 2
    return L


def enumerate_bifurcations_sharded(chromosomes: list, k: int,
                                   mesh: Mesh) -> BifEnumeration:
    """Sharded twin of ``index.enumeration.enumerate_bifurcations``: the
    same BifEnumeration (chr and pos int64, as from the device paths) for
    any mesh, on every process of a process-group mesh."""
    if not chromosomes:
        return _empty_enumeration()
    # int32 position space, checked from the lengths before any buffer is
    # built (the supergenome is about twice the input, so an input under
    # the reference's 1 GB cap can exceed it; callers take the host path)
    total = 1 + 2 * sum(len(c) + 1 for c in chromosomes)
    if total >= (1 << 31):
        raise ValueError("sharded enumeration: supergenome exceeds int32 "
                         "position space")
    timings.add("sharded_enum_calls", 1)
    with timings.phase("enum_host"):
        codes, block_starts = build_supergenome(chromosomes)
    n0 = codes.shape[0]
    L = shard_rows(n0, mesh.size, k)
    padded = np.zeros(mesh.size * L, dtype=np.uint8)
    padded[:n0] = codes
    with sync_wait("enum_upload"):
        shards = [to_tensor(padded[d * L:(d + 1) * L], mesh.devices[d])
                  for d in mesh.local_shards()]
    selected, total_d = _build_step(k, L, mesh, shards)
    del shards
    rows = mesh.gather_first(selected)
    rows = rows[torch.argsort(rows[:, 0])]
    with sync_wait("enum_fetch"):
        flat = download(torch.cat([total_d.reshape(1),
                                   rows.t().reshape(-1)]), "enum_sharded")
    count = int(flat[0])
    if count == 0:
        return _empty_enumeration()
    ns = rows.shape[0]
    sel = flat[1:1 + ns].copy()
    sel_ids = flat[1 + ns:1 + 2 * ns].astype(np.uint32)
    with timings.phase("enum_host"):
        return _map_selected(sel, sel_ids, count, block_starts,
                             len(chromosomes))
