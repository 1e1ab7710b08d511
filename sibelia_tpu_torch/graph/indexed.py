"""IndexedSequence equivalent: ambiguous-base randomization, device
bifurcation enumeration, and bulk construction of the bifurcation store
(port of ``sibelia_tpu/graph/indexed.py``; the enumeration runs on the
port's device).

Reference: src/indexedsequence.cpp:28-72 (Init). The reference randomizes
non-ACGT chars with unseeded C rand() — we thread a GlibcRand stream for
bit parity (see core/glibc_rand.py) — then enumerates bifurcations and
walks both strands adding points in (strand, chr, pos) order, which with
front-inserting lists leaves each list in descending scan order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.glibc_rand import GlibcRand
from ..index.enumeration import enumerate_bifurcations
from .bifstore import BifStore
from .sequence import MutableSequence

DEFINITE = b"ACGT"
_IS_DEFINITE = np.zeros(256, dtype=bool)
for _b in DEFINITE:
    _IS_DEFINITE[_b] = True


def randomize_ambiguous(seq: MutableSequence, rand: GlibcRand) -> None:
    """Replace non-ACGT chars in chr-ascending, pos-ascending order using
    DEFINITE_BASE[rand() % 4] (reference: indexedsequence.cpp:33-37)."""
    for c in range(seq.n_chr):
        arr = seq.chars[c]
        bad = np.flatnonzero(~_IS_DEFINITE[arr])
        for i in bad.tolist():
            arr[i] = DEFINITE[rand.rand() % 4]


def randomize_and_enumerate(seq: MutableSequence, k: int,
                            rand: GlibcRand | None = None,
                            min_branch: int | None = None,
                            device: torch.device | None = None):
    """Randomize ambiguity codes in place and enumerate bifurcations;
    min_branch requests the bulge-candidate bitmap too."""
    if rand is not None:
        randomize_ambiguous(seq, rand)
    return enumerate_bifurcations(seq.chars, k, min_branch, device)


def build_index(seq: MutableSequence, k: int, rand: GlibcRand | None = None,
                device: torch.device | None = None) -> BifStore:
    """Randomize ambiguity codes in place, enumerate bifurcations at k on
    the device, and construct the point store with reference list order."""
    return store_from_enum(seq, randomize_and_enumerate(seq, k, rand, None,
                                                        device))


def store_from_enum(seq: MutableSequence, enum) -> BifStore:
    store = BifStore(seq, enum.count)

    total = int(enum.chr[0].size + enum.chr[1].size)
    store._grow(total)
    node_base = 0
    for strand in (0, 1):
        chrs = enum.chr[strand].astype(np.int64)
        poss = enum.pos[strand].astype(np.int64)
        bids = enum.bif_id[strand].astype(np.int64)
        m = chrs.size
        if strand == 1 and m:
            # negative-strand local offset -> positive-frame coordinate
            lens = np.asarray([seq.chr_len(c) for c in range(seq.n_chr)], dtype=np.int64)
            coords = lens[chrs] - 1 - poss
        else:
            coords = poss
        idxs = np.arange(node_base, node_base + m, dtype=np.int64)
        store.node_strand[node_base:node_base + m] = strand
        store.node_chr[node_base:node_base + m] = chrs
        store.node_pos[node_base:node_base + m] = coords
        store.node_bif[node_base:node_base + m] = bids
        for c in range(seq.n_chr):
            sel = chrs == c
            store.bif_at[strand][c][coords[sel]] = idxs[sel]
        # per-bif lists: scan order ascending, list order = reversed
        order = np.argsort(bids, kind="stable")
        sorted_bids = bids[order]
        sorted_idxs = idxs[order]
        bounds = np.flatnonzero(np.diff(sorted_bids)) + 1
        starts = np.concatenate([[0], bounds])
        stops = np.concatenate([bounds, [m]])
        lists = store.lists[strand]
        for s, e in zip(starts.tolist(), stops.tolist()):
            if s == e:
                continue
            lists[int(sorted_bids[s])] = sorted_idxs[s:e][::-1].tolist()
        node_base += m
    store.n_nodes = total
    return store
