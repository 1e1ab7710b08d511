"""Synteny block generation: edge grouping, overlap resolution, trimming
(port of ``sibelia_tpu/blocks/synteny.py``).

Reference: src/synteny.cpp. Order-sensitive steps use the libstdc++
std::sort emulation (core/stdsort.py) because the reference's output
depends on the exact permutation unstable sorts leave equal elements in.

The whole-genome index is built on the device
(``graph/indexed.py::build_index``), and so are the per-block mini-indexes
of ``trim_blocks``'s large rounds (``trim_enumeration``); a small round is
one native call (``native/trim.cpp``).  The calls are made in the JAX
package's order, so the GlibcRand stream that randomizes ambiguous bases
is consumed as there.  The edge table is one native call
(``native/blocks.cpp``: listed, grouped and ordered by libstdc++'s
std::sort, as core/stdsort.py orders it), and so is each group's overlap
claim.  The three parts are the ``timings`` phases ``block_index``,
``block_edges`` and ``block_trim``; inside the last,
``trim_resolve`` (``resolve_overlap``), ``trim_native`` (the native
rounds), ``trim_enum`` (the other rounds' enumerations) and ``trim_walk``
(the rest of ``trim_blocks`` and the commit of each block), with the
counts ``trim_calls``, ``trim_rows`` (supergenome rows),
``trim_card_calls``, ``trim_host_calls`` and ``trim_native_calls``; the
native table's rows and claims are counted ``edge_table_rows`` and
``overlap_native_calls``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import timings
from ..core.glibc_rand import GlibcRand
from ..core.stdsort import group_by, std_sort
from ..graph.indexed import build_index, randomize_ambiguous
from ..graph.sequence import MutableSequence
from ..index.enumeration import (BifEnumeration, enumerate_bifurcations,
                                 enumerate_bifurcations_host,
                                 supergenome_rows)
from ..io.fasta import FASTARecord
from ..parallel.sharded import Mesh
from .edges import Edge, list_edges
from .instance import BlockInstance

POS_FREE = 0
POS_OCCUPIED = 1
_OO = (1 << 32) - 1  # reference: const size_t oo = UINT_MAX (synteny.cpp:42)
# supergenome rows from which a block's copies are enumerated on the
# device: where the card's fixed cost a call (some 60-85 launches) met the
# host's numpy enumeration (chip_smoke.py phase trim; PERF.md, which also
# times the native round below it against both)
TRIM_CARD_MIN_ROWS = 12_289


def _cmp_edges_naturally(a: Edge, b: Edge) -> bool:
    return a.group_key() < b.group_key()


def _cmp_edges_by_direction(a: Edge, b: Edge) -> bool:
    return a.direction < b.direction


def resolve_overlap(group: list[Edge], min_size: int,
                    overlap: list[np.ndarray]) -> list[Edge]:
    """Greedy per-edge claim of the longest free original-coordinate run
    (reference: synteny.cpp:124-166). `overlap` is the global occupancy;
    claims within this group are tracked locally and only committed by the
    caller after trimming succeeds.  One native call
    (``native.overlap_claims``, counted ``overlap_native_calls``);
    ``_resolve_overlap`` without the library."""
    out = native.overlap_claims(
        [(e.chr, e.original_position, e.original_length) for e in group],
        overlap, min_size)
    if out is None:
        return _resolve_overlap(group, min_size, overlap)
    timings.add("overlap_native_calls", 1)
    return [Edge(e.chr, e.direction, e.start_vertex, e.end_vertex,
                 e.actual_position, e.actual_length, start, length,
                 e.first_char)
            for e, (claimed, start, length) in zip(group, out) if claimed]


def _resolve_overlap(group: list[Edge], min_size: int,
                     overlap: list[np.ndarray]) -> list[Edge]:
    """``resolve_overlap``'s rule in numpy (SIBELIA_TPU_NATIVE=0): each
    claim of the group in a whole-chromosome mask."""
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


def _on_card(rows: int) -> bool:
    """The route of a trim round of `rows` supergenome rows: the card from
    TRIM_CARD_MIN_ROWS rows on, the host below (an empty block has none)."""
    return bool(rows) and rows >= TRIM_CARD_MIN_ROWS


def _count_round(rows: int, card: bool) -> None:
    timings.add("trim_calls", 1)
    timings.add("trim_rows", rows)
    timings.add("trim_card_calls" if card else "trim_host_calls", 1)


def trim_enumeration(chromosomes: list, k: int,
                     device: torch.device | None,
                     mesh: Mesh | None = None) -> BifEnumeration:
    """A block's mini-index: the device enumeration on `device` (or
    `mesh`) on the card route (``_on_card``), the host enumeration below.
    Counts
    ``trim_calls``, ``trim_rows`` and the route, ``trim_card_calls`` or
    ``trim_host_calls``."""
    rows = supergenome_rows(sum(len(c) for c in chromosomes),
                            len(chromosomes)) if chromosomes else 0
    card = _on_card(rows)
    _count_round(rows, card)
    if card:
        return enumerate_bifurcations(chromosomes, k, None, device, mesh)
    return enumerate_bifurcations_host(chromosomes, k)


def trim_blocks(chr_list: list[FASTARecord], block: list[Edge], trim_k: int,
                min_size: int, rand: GlibcRand | None,
                device: torch.device | None = None,
                mesh: Mesh | None = None) -> bool:
    """Trim each copy to the outermost trim_k-mer shared with another copy
    (reference: synteny.cpp:31-122). Mutates `block` in place; returns True
    if some copy had no shared k-mer at all (caller loops to fixpoint).

    On the host route the enumeration and the walk are one native call
    (``native.trim_round``, counted ``trim_native_calls``, the phase
    ``trim_native``).  On the card route, and on the host under
    SIBELIA_TPU_NATIVE=0, ``trim_enumeration`` enumerates the copies on
    `device` (None: the run's device) or the run's `mesh` (phase
    ``trim_enum``) and the walk is
    ``native.trim_walk``, or ``_trim_walk`` without the library; the phase
    ``trim_walk`` holds the rest of the call."""
    with timings.phase("trim_walk"):
        copies = [chr_list[e.chr].sequence[e.original_position:
                                           e.original_position
                                           + e.original_length].encode()
                  for e in block]
        lens = np.fromiter(map(len, copies), np.int64, len(copies))
        dirs = np.fromiter((e.direction for e in block), np.int8,
                           len(block))
        # one buffer for every copy: the draws run in (copy, position)
        # order, as over the copies one by one
        chars = np.frombuffer(b"".join(copies), dtype=np.uint8).copy()
        if rand is not None:
            randomize_ambiguous(MutableSequence([chars]), rand)
    rows = supergenome_rows(chars.size, len(block)) if block else 0
    res = None
    if not _on_card(rows) and native.load() is not None:
        with timings.phase("trim_native"):
            res = native.trim_round(chars, lens, dirs, trim_k, min_size)
        _count_round(rows, False)
        timings.add("trim_native_calls", 1)
    else:
        views = np.split(chars, np.cumsum(lens)[:-1]) if block else []
        with timings.phase("trim_enum"):
            enum = trim_enumeration(views, trim_k, device, mesh)
        with timings.phase("trim_walk"):
            res = native.trim_walk(enum, lens, dirs, trim_k, min_size)
            if res is None:
                res = _trim_walk(lens, dirs, enum, trim_k, min_size)
    with timings.phase("trim_walk"):
        drop, out = res
        kept = []
        for e, (keep, lo, length) in zip(block, out.tolist()):
            if keep:
                kept.append(Edge(e.chr, e.direction, e.start_vertex,
                                 e.end_vertex, e.actual_position,
                                 e.actual_length, e.original_position + lo,
                                 length, e.first_char))
        block[:] = kept
    return drop


def _trim_walk(lens: np.ndarray, dirs: np.ndarray, enum: BifEnumeration,
               trim_k: int, min_size: int) -> tuple[bool, np.ndarray]:
    """The walk of ``trim_blocks`` over the block's enumeration in numpy
    (SIBELIA_TPU_NATIVE=0), with ``native.trim_walk``'s (drop, out).

    The reference walks every element of every copy with a per-position
    store probe; the serial update rule — strictly smaller sum, or equal
    sum with a smaller bifurcation id — is exactly a lexicographic argmin
    over (sum, bifId, walk index), so the whole walk vectorizes as one
    expand-and-argmin over (own mark) x (other-copy instance) pairs."""
    # flat node table (both strands, positive-frame coordinates)
    parts_s, parts_c, parts_p, parts_b = [], [], [], []
    for strand in (0, 1):
        chrs = enum.chr[strand].astype(np.int64)
        poss = enum.pos[strand].astype(np.int64)
        coords = poss if strand == 0 else lens[chrs] - 1 - poss
        parts_s.append(np.full(chrs.size, strand, dtype=np.int8))
        parts_c.append(chrs)
        parts_p.append(coords)
        parts_b.append(enum.bif_id[strand].astype(np.int64))
    n_s = np.concatenate(parts_s)
    n_c = np.concatenate(parts_c)
    n_p = np.concatenate(parts_p)
    n_b = np.concatenate(parts_b)

    # group instances by bif id for partner expansion (searchsorted over
    # the sorted unique ids — bif ids are dense, but the mini-index can
    # hold millions of them, so no per-call dict)
    grp_order = np.argsort(n_b, kind="stable")
    gb = n_b[grp_order]
    grp_starts = np.concatenate([[0], np.flatnonzero(np.diff(gb)) + 1]) \
        if gb.size else np.zeros(1, np.int64)
    grp_ids = gb[grp_starts] if gb.size else np.zeros(0, np.int64)
    bounds = np.append(grp_starts, gb.size)

    k_begin_of = np.where(dirs == 0, 0, lens - 1)
    k_end_of = np.where(dirs == 0, lens - 1, 0)

    drop = False
    out = np.zeros((len(lens), 3), dtype=np.int64)
    for chr_i in range(len(lens)):
        d = int(dirs[chr_i])
        L = int(lens[chr_i])
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
                lo = min(trim_start, te)
                out[chr_i] = (1, lo, max(trim_start, te) + 1 - lo)
        else:
            drop = True
    return drop, out


def _dots(progress, p_thresh: int, done: int, upto: int) -> None:
    """The progress bar's dots for groups done + 1 .. upto: one a
    `p_thresh` groups, the bar's position capped at 50 (the reference
    counts every group, util.cpp:89-111)."""
    for i in range((done // p_thresh + 1) * p_thresh, upto + 1, p_thresh):
        progress(min(i // p_thresh, 50), 1)


def edge_groups(seq: MutableSequence, store, k: int, min_size: int
                ) -> tuple[int, list[tuple[int, list[Edge]]]]:
    """Block generation's edge groups (reference: synteny.cpp:229-260):
    the edges of original length at least `min_size`, grouped by
    (startVertex, endVertex, firstChar), the groups sorted by size,
    greater first, and each group's edges by direction.  Returns the
    number of groups and, in that order, (index, edges) of each group that
    can make a block: two edges or more, one of them positive.

    One native call (``native.edge_table``, its rows counted
    ``edge_table_rows``) lists and orders the whole table; only the edges
    of those groups become ``Edge`` objects.  Without the library,
    ``list_edges`` and ``core/stdsort.py``, which order equal elements as
    the native std::sort does."""
    table = native.edge_table(seq.chars, seq.origpos, store.bif_at,
                              store.node_bif, k, min_size)
    if table is None:
        edges = [e for e in list_edges(seq, store, k)
                 if e.original_length >= min_size]
        groups = group_by(edges, _cmp_edges_naturally)
        std_sort(groups, lambda a, b: (a[1] - a[0]) > (b[1] - b[0]))
        out = []
        for j, (g0, g1) in enumerate(groups):
            seg = edges[g0:g1]
            std_sort(seg, _cmp_edges_by_direction)
            if len(seg) > 1 and seg[0].direction == 0:
                out.append((j, seg))
        return len(groups), out
    cols, bounds = table
    timings.add("edge_table_rows", len(cols[0]))
    g0, g1 = bounds[:, 0], bounds[:, 1]
    # a group's first edge is its least direction
    can = np.flatnonzero((g1 - g0 > 1) & (cols[1][g0] == 0))
    sizes = (g1 - g0)[can]
    ends = np.cumsum(sizes)
    rows = (np.repeat(g0[can] - (ends - sizes), sizes)
            + np.arange(ends[-1] if sizes.size else 0))
    edges = list(map(Edge, *(c[rows].tolist() for c in cols)))
    return len(bounds), [(j, edges[e - n:e]) for j, n, e
                         in zip(can.tolist(), sizes.tolist(), ends.tolist())]


def generate_synteny_blocks(chr_list: list[FASTARecord],
                            raw_seq: list[bytes],
                            original_pos: list[np.ndarray],
                            original_size: list[int],
                            k: int, trim_k: int, min_size: int,
                            shared_only: bool,
                            rand: GlibcRand | None,
                            device: torch.device,
                            progress=None,
                            mesh: Mesh | None = None) -> list[BlockInstance]:
    """Reference: BlockFinder::GenerateSyntenyBlocks (synteny.cpp:229-287);
    progress = PutProgressChr-style callable (50-dot bar over the edge
    groups, util.cpp:89-111); the enumerations run on `device`, or over
    the run's `mesh`."""
    overlap = [np.zeros(sz, dtype=np.int8) for sz in original_size]

    with timings.phase("block_index"):
        seq = MutableSequence(raw_seq, original_pos)
        store = build_index(seq, k, rand, device, mesh)
    with timings.phase("block_edges"):
        n_groups, trimmable = edge_groups(seq, store, k, min_size)

    block: list[BlockInstance] = []
    block_count = 1
    if progress is not None:
        progress(0, 0)
    p_thresh = max(1, n_groups // 50)
    done = 0
    with timings.phase("block_trim"):
        for j, seg in trimmable:
            if progress is not None:
                _dots(progress, p_thresh, done, j + 1)
            done = j + 1
            with timings.phase("trim_resolve"):
                now_block = resolve_overlap(seg, min_size, overlap)
            while trim_blocks(chr_list, now_block, trim_k, min_size, rand,
                              device, mesh):
                pass
            with timings.phase("trim_walk"):
                occur = [0] * len(raw_seq)
                for e in now_block:
                    occur[e.chr] += 1
                if len(now_block) > 1 and (
                        not shared_only or occur.count(1) == len(raw_seq)):
                    for e in now_block:
                        strand = +1 if e.direction == 0 else -1
                        start = e.original_position
                        end = start + e.original_length
                        overlap[e.chr][start:end] = POS_OCCUPIED
                        block.append(BlockInstance(block_count * strand,
                                                   chr_list[e.chr], start,
                                                   end))
                    block_count += 1
    if progress is not None:
        _dots(progress, p_thresh, done, n_groups)
        progress(50, 2)
    std_sort(block, lambda a, b: (a.chr_id, a.start) < (b.chr_id, b.start))
    return block
