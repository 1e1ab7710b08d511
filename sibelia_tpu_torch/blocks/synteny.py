"""Synteny block generation: edge grouping, overlap resolution, trimming
(port of ``sibelia_tpu/blocks/synteny.py``).

Reference: src/synteny.cpp. Order-sensitive steps use the libstdc++
std::sort emulation (core/stdsort.py) because the reference's output
depends on the exact permutation unstable sorts leave equal elements in.

The whole-genome index is built on the device
(``graph/indexed.py::build_index``); ``trim_blocks``'s per-block
mini-index enumerations stay on the host.  The calls are made in the JAX
package's order, so the GlibcRand stream that randomizes ambiguous bases is
consumed as there.  The three parts are the ``timings`` phases
``block_index``, ``block_edges`` and ``block_trim``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import timings
from ..core.glibc_rand import GlibcRand
from ..core.stdsort import group_by, std_sort
from ..graph.indexed import build_index, randomize_ambiguous
from ..graph.sequence import MutableSequence
from ..index.enumeration import enumerate_bifurcations_host
from ..io.fasta import FASTARecord
from .edges import Edge, list_edges
from .instance import BlockInstance

POS_FREE = 0
POS_OCCUPIED = 1
_OO = (1 << 32) - 1  # reference: const size_t oo = UINT_MAX (synteny.cpp:42)


def _cmp_edges_naturally(a: Edge, b: Edge) -> bool:
    return a.group_key() < b.group_key()


def _cmp_edges_by_direction(a: Edge, b: Edge) -> bool:
    return a.direction < b.direction


def resolve_overlap(group: list[Edge], min_size: int,
                    overlap: list[np.ndarray]) -> list[Edge]:
    """Greedy per-edge claim of the longest free original-coordinate run
    (reference: synteny.cpp:124-166). `overlap` is the global occupancy;
    claims within this group are tracked locally and only committed by the
    caller after trimming succeeds."""
    now_block: list[Edge] = []
    local: dict[int, np.ndarray] = {}
    for e in group:
        chr_n = e.chr
        start = e.original_position
        end = start + e.original_length
        glob = overlap[chr_n][start:end]
        loc = local.get(chr_n)
        if loc is None:
            free = glob == POS_FREE
        else:
            free = (glob == POS_FREE) & (~loc[start:end])
        # first maximal run of maximum length (strictly-greater updates)
        padded = np.concatenate([[False], free, [False]])
        d = np.diff(padded.astype(np.int8))
        run_starts = np.flatnonzero(d == 1)
        run_ends = np.flatnonzero(d == -1)
        best_start = best_end = 0
        for rs, re_ in zip(run_starts.tolist(), run_ends.tolist()):
            if re_ - rs > best_end - best_start:
                best_start, best_end = rs, re_
        if best_end - best_start >= min_size:
            if loc is None:
                loc = np.zeros(len(overlap[chr_n]), dtype=bool)
                local[chr_n] = loc
            loc[start + best_start:start + best_end] = True
            now_block.append(Edge(e.chr, e.direction, e.start_vertex, e.end_vertex,
                                  e.actual_position, e.actual_length,
                                  start + best_start, best_end - best_start,
                                  e.first_char))
    return now_block


def trim_blocks(chr_list: list[FASTARecord], block: list[Edge], trim_k: int,
                min_size: int, rand: GlibcRand | None) -> bool:
    """Trim each copy to the outermost trim_k-mer shared with another copy
    (reference: synteny.cpp:31-122). Mutates `block` in place; returns True
    if some copy had no shared k-mer at all (caller loops to fixpoint).

    The reference walks every element of every copy with a per-position
    store probe; the serial update rule — strictly smaller sum, or equal
    sum with a smaller bifurcation id — is exactly a lexicographic argmin
    over (sum, bifId, walk index), so the whole walk vectorizes as one
    expand-and-argmin over (own mark) x (other-copy instance) pairs."""
    block_seq = []
    for e in block:
        s = chr_list[e.chr].sequence[e.original_position:
                                     e.original_position + e.original_length]
        block_seq.append(s.encode())
    seq = MutableSequence(block_seq)
    if rand is not None:
        randomize_ambiguous(seq, rand)
    enum = enumerate_bifurcations_host(seq.chars, trim_k)

    # flat node table (both strands, positive-frame coordinates)
    lens = np.asarray([seq.chr_len(c) for c in range(seq.n_chr)],
                      dtype=np.int64)
    parts_s, parts_c, parts_p, parts_b = [], [], [], []
    for strand in (0, 1):
        chrs = enum.chr[strand].astype(np.int64)
        poss = enum.pos[strand].astype(np.int64)
        coords = poss if strand == 0 else lens[chrs] - 1 - poss
        parts_s.append(np.full(chrs.size, strand, dtype=np.int8))
        parts_c.append(chrs)
        parts_p.append(coords)
        parts_b.append(enum.bif_id[strand].astype(np.int64))
    n_s = np.concatenate(parts_s) if parts_s else np.zeros(0, np.int8)
    n_c = np.concatenate(parts_c) if parts_c else np.zeros(0, np.int64)
    n_p = np.concatenate(parts_p) if parts_p else np.zeros(0, np.int64)
    n_b = np.concatenate(parts_b) if parts_b else np.zeros(0, np.int64)

    # group instances by bif id for partner expansion (searchsorted over
    # the sorted unique ids — bif ids are dense, but the mini-index can
    # hold millions of them, so no per-call dict)
    grp_order = np.argsort(n_b, kind="stable")
    gb = n_b[grp_order]
    grp_starts = np.concatenate([[0], np.flatnonzero(np.diff(gb)) + 1]) \
        if gb.size else np.zeros(1, np.int64)
    grp_ids = gb[grp_starts] if gb.size else np.zeros(0, np.int64)
    bounds = np.append(grp_starts, gb.size)

    n_chr_blk = len(block)
    dirs = np.asarray([e.direction for e in block], dtype=np.int64)
    k_begin_of = np.where(dirs == 0, 0, lens - 1)
    k_end_of = np.where(dirs == 0, lens - 1, 0)

    drop = False
    ret: list[Edge] = []
    for chr_i, e in enumerate(block):
        d = e.direction
        L = seq.chr_len(chr_i)
        begin_coord = 0 if d == 0 else L - 1
        end_coord = L - 1 if d == 0 else 0
        # own marks on strand d (the reference walks bif_at[d][chr_i])
        own = np.flatnonzero((n_s == d) & (n_c == chr_i))
        min_start_sum = min_end_sum = _OO
        trim_start = trim_end = None
        if own.size:
            oc = n_p[own]
            ob = n_b[own]
            walk_idx = oc if d == 0 else (L - 1 - oc)
            # expand each own mark by its bif group's members: flat
            # range-concat via cumsum offsets (no Python per-group loop)
            gi = np.searchsorted(grp_ids, ob)
            g_lo = bounds[gi]
            g_hi = bounds[gi + 1]
            cnt = g_hi - g_lo
            owner_rep = np.repeat(np.arange(own.size), cnt)
            total = int(cnt.sum())
            if total:
                # concatenated aranges [g_lo[j], g_hi[j]) via one cumsum
                steps = np.ones(total, dtype=np.int64)
                steps[0] = g_lo[0]
                head = np.cumsum(cnt)[:-1]
                steps[head] = g_lo[1:] - (g_hi[:-1] - 1)
                partner = grp_order[np.cumsum(steps)]
            else:
                partner = np.zeros(0, np.int64)
            k_chr = n_c[partner]
            keep = k_chr != chr_i
            if np.any(keep):
                owner_rep = owner_rep[keep]
                k_chr = k_chr[keep]
                kc = n_p[partner[keep]]
                coord = oc[owner_rep]
                bif = ob[owner_rep]
                widx = walk_idx[owner_rep]
                it_start = np.abs(coord - begin_coord)
                it_end = np.abs(coord - end_coord)
                now_start = np.abs(kc - k_begin_of[k_chr]) + it_start
                now_end = np.abs(kc - k_end_of[k_chr]) + it_end

                def lex_argmin(now):
                    # staged argmin of (sum, bifId, walk index) — no
                    # packing, so no width limits on any component
                    c1 = now == now.min()
                    b = bif[c1].min()
                    c2 = c1 & (bif == b)
                    sub = np.flatnonzero(c2)
                    return int(sub[np.argmin(widx[sub])])

                si = lex_argmin(now_start)
                ei = lex_argmin(now_end)
                min_start_sum = int(now_start[si])
                min_end_sum = int(now_end[ei])
                trim_start = int(coord[si])
                trim_end = int(coord[ei])
        if min_start_sum < _OO and min_end_sum < _OO:
            size = abs(trim_start - trim_end) + trim_k
            if size >= min_size:
                te = trim_end + (trim_k - 1) if d == 0 else trim_end - (trim_k - 1)
                start = e.original_position + min(trim_start, te)
                end = e.original_position + max(trim_start, te) + 1
                ret.append(Edge(e.chr, e.direction, e.start_vertex, e.end_vertex,
                                e.actual_position, e.actual_length,
                                start, end - start, e.first_char))
        else:
            drop = True
    block[:] = ret
    return drop


def generate_synteny_blocks(chr_list: list[FASTARecord],
                            raw_seq: list[bytes],
                            original_pos: list[np.ndarray],
                            original_size: list[int],
                            k: int, trim_k: int, min_size: int,
                            shared_only: bool,
                            rand: GlibcRand | None,
                            device: torch.device,
                            progress=None) -> list[BlockInstance]:
    """Reference: BlockFinder::GenerateSyntenyBlocks (synteny.cpp:229-287);
    progress = PutProgressChr-style callable (50-dot bar over the edge
    groups, util.cpp:89-111)."""
    overlap = [np.zeros(sz, dtype=np.int8) for sz in original_size]

    with timings.phase("block_index"):
        seq = MutableSequence(raw_seq, original_pos)
        store = build_index(seq, k, rand, device)
    with timings.phase("block_edges"):
        edges = list_edges(seq, store, k)
        edges = [e for e in edges if e.original_length >= min_size]
        groups = group_by(edges, _cmp_edges_naturally)
        std_sort(groups, lambda a, b: (a[1] - a[0]) > (b[1] - b[0]))

    block: list[BlockInstance] = []
    block_count = 1
    if progress is not None:
        progress(0, 0)
    p_thresh = max(1, len(groups) // 50)
    p_count = 0
    p_prog = 0
    with timings.phase("block_trim"):
        for g0, g1 in groups:
            p_count += 1
            if p_count >= p_thresh and progress is not None:
                p_count = 0
                p_prog = min(p_prog + 1, 50)
                progress(p_prog, 1)
            seg = edges[g0:g1]
            std_sort(seg, _cmp_edges_by_direction)
            edges[g0:g1] = seg
            if g1 - g0 < 2 or not any(e.direction == 0 for e in seg):
                continue
            now_block = resolve_overlap(seg, min_size, overlap)
            while trim_blocks(chr_list, now_block, trim_k, min_size, rand):
                pass
            occur = [0] * len(raw_seq)
            for e in now_block:
                occur[e.chr] += 1
            if len(now_block) > 1 and (not shared_only
                                       or occur.count(1) == len(raw_seq)):
                for e in now_block:
                    strand = +1 if e.direction == 0 else -1
                    start = e.original_position
                    end = start + e.original_length
                    overlap[e.chr][start:end] = POS_OCCUPIED
                    block.append(BlockInstance(block_count * strand,
                                               chr_list[e.chr], start, end))
                block_count += 1

    if progress is not None:
        progress(50, 2)
    std_sort(block, lambda a, b: (a.chr_id, a.start) < (b.chr_id, b.start))
    return block
