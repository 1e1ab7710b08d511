"""Bifurcation point store over flat arrays.

Functional equivalent of the reference's BifurcationStorage
(reference: src/bifurcationstorage.{h,cpp}) with the pointer machinery
replaced by arrays:

  * bif_at[strand][chr]: per-position node index (-1 = none) — replaces the
    hash map keyed by element address (bifurcationstorage.h:110-112)
  * per-(strand, bifId) python lists with FRONT insertion and lazy deletion
    — replaces the slists (AddPoint inserts at begin(),
    bifurcationstorage.cpp:122; ErasePoint marks NO_BIFURCATION and defers
    removal to Cleanup(), bifurcationstorage.cpp:144-155).
    The list order and the dead entries are parity-relevant: ListPositions
    exposes the order, and CountBifurcations counts dead entries too
    (bifurcationstorage.cpp:71-75).

Node positions are kept current across sequence splices by a vectorized
shift (the reference gets this for free from iterator identity).
"""
from __future__ import annotations

import numpy as np

from .sequence import MutableSequence

NO_BIFURCATION = (1 << 32) - 1


class BifStore:
    def __init__(self, seq: MutableSequence, max_id: int):
        self.seq = seq
        self.max_id = max_id
        self.bif_at = [
            [np.full(seq.chr_len(c), -1, dtype=np.int64) for c in range(seq.n_chr)]
            for _ in range(2)
        ]
        cap = 1024
        self.node_strand = np.zeros(cap, dtype=np.int8)
        self.node_chr = np.zeros(cap, dtype=np.int32)
        self.node_pos = np.zeros(cap, dtype=np.int64)
        self.node_bif = np.full(cap, NO_BIFURCATION, dtype=np.int64)
        self.n_nodes = 0
        self.lists: list[dict[int, list[int]]] = [{}, {}]
        self.to_clear: list[tuple[int, int, int]] = []

    # -- node management ---------------------------------------------------
    def _grow(self, need: int):
        cap = len(self.node_bif)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in ("node_strand", "node_chr", "node_pos", "node_bif"):
            old = getattr(self, name)
            new = np.zeros(new_cap, dtype=old.dtype)
            new[: self.n_nodes] = old[: self.n_nodes]
            setattr(self, name, new)

    def _new_node(self, strand: int, c: int, pos: int, bif_id: int) -> int:
        self._grow(self.n_nodes + 1)
        i = self.n_nodes
        self.node_strand[i] = strand
        self.node_chr[i] = c
        self.node_pos[i] = pos
        self.node_bif[i] = bif_id
        self.n_nodes += 1
        return i

    # -- queries -----------------------------------------------------------
    def get_bif(self, strand: int, c: int, pos: int) -> int:
        idx = self.bif_at[strand][c][pos]
        return NO_BIFURCATION if idx < 0 else int(self.node_bif[idx])

    def node_valid(self, idx: int) -> bool:
        return self.node_bif[idx] != NO_BIFURCATION

    def count_bifurcations(self, bif_id: int) -> int:
        """Includes lazily-deleted entries (parity with reference)."""
        return len(self.lists[0].get(bif_id, ())) + len(self.lists[1].get(bif_id, ()))

    def list_positions(self, bif_id: int) -> list[int]:
        """Node indices: positive-strand list order then negative
        (reference: bifurcationstorage.h:59-72)."""
        out = list(self.lists[0].get(bif_id, ()))
        out.extend(self.lists[1].get(bif_id, ()))
        return out

    # -- mutation ----------------------------------------------------------
    def add_point(self, strand: int, c: int, pos: int, bif_id: int) -> None:
        if bif_id == NO_BIFURCATION:
            return
        if self.bif_at[strand][c][pos] >= 0:
            return
        idx = self._new_node(strand, c, pos, bif_id)
        self.bif_at[strand][c][pos] = idx
        self.lists[strand].setdefault(bif_id, []).insert(0, idx)

    def erase_point(self, strand: int, c: int, pos: int) -> None:
        idx = self.bif_at[strand][c][pos]
        if idx < 0:
            return
        bif_id = int(self.node_bif[idx])
        self.bif_at[strand][c][pos] = -1
        self.node_bif[idx] = NO_BIFURCATION
        self.to_clear.append((strand, bif_id, idx))

    def cleanup(self) -> None:
        for strand, bif_id, idx in self.to_clear:
            lst = self.lists[strand].get(bif_id)
            if lst is not None:
                try:
                    lst.remove(idx)
                except ValueError:
                    pass
        self.to_clear.clear()

    # -- splice bookkeeping ------------------------------------------------
    def apply_splice(self, c: int, start: int, stop: int, new_len: int) -> None:
        """Update bif_at arrays and node positions for a splice replacing
        chars[c][start:stop] with new_len elements. Live nodes inside the
        span must already have been erased by the collapse protocol."""
        delta = new_len - (stop - start)
        for strand in (0, 1):
            arr = self.bif_at[strand][c]
            self.bif_at[strand][c] = np.concatenate(
                [arr[:start], np.full(new_len, -1, dtype=np.int64), arr[stop:]])
        if delta != 0:
            n = self.n_nodes
            mask = (self.node_chr[:n] == c) & (self.node_pos[:n] >= stop)
            self.node_pos[:n][mask] += delta

    # -- walk helper -------------------------------------------------------
    def scan_forward(self, strand: int, c: int, pos: int, max_steps: int):
        """Bifurcation marks at steps 1..max_steps-1 walking forward on
        `strand` from (c, pos), stopping at chromosome bounds. Returns
        (steps ascending, node indices)."""
        arr = self.bif_at[strand][c]
        if strand == 0:
            lo = pos + 1
            hi = min(pos + max_steps, len(arr))
            if lo >= hi:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            window = arr[lo:hi]
            nz = np.flatnonzero(window >= 0)
            return nz + 1, window[nz]
        else:
            hi = pos  # exclusive
            lo = max(pos - max_steps + 1, 0)
            if lo >= hi:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            window = arr[lo:hi]
            nz = np.flatnonzero(window >= 0)[::-1]
            return pos - (nz + lo), window[nz]
