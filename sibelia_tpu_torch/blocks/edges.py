"""Condensed de Bruijn graph edge listing over the bifurcation-mark arrays.

Reference: BlockFinder::ListEdges (src/serialization.cpp:56-86). An edge is
a maximal bifurcation-free run between two consecutive bifurcation marks on
one strand of one chromosome; the first edge of a chromosome starts at the
chromosome begin (whose vertex may be NO_BIFURCATION).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.bifstore import NO_BIFURCATION, BifStore
from ..graph.sequence import MutableSequence


@dataclass
class Edge:
    chr: int
    direction: int  # 0 positive, 1 negative
    start_vertex: int
    end_vertex: int
    actual_position: int
    actual_length: int
    original_position: int
    original_length: int
    first_char: int

    def group_key(self):
        """Edges are grouped by (startVertex, endVertex, firstChar)
        (reference: src/edge.cpp:24-38)."""
        return (self.start_vertex, self.end_vertex, self.first_char)


def list_edges(seq: MutableSequence, store: BifStore, k: int) -> list[Edge]:
    edges: list[Edge] = []
    for strand in (0, 1):
        for c in range(seq.n_chr):
            arr = store.bif_at[strand][c]
            L = len(arr)
            coords = np.flatnonzero(arr >= 0)
            if strand == 1:
                coords = coords[::-1]
            # walk distance of each mark from the chromosome begin
            ts = coords if strand == 0 else (L - 1) - coords
            marks = ts.tolist()
            if not marks:
                continue
            prev_t = 0
            prev_vertex = store.get_bif(strand, c, 0 if strand == 0 else L - 1) \
                if L > 0 else NO_BIFURCATION
            for t, coord in zip(marks, coords.tolist()):
                if t == 0:
                    prev_t = 0
                    continue
                a, b = prev_t, t
                step = b - a
                origin_coord = a if strand == 0 else L - 1 - a
                now_vertex = int(store.node_bif[arr[coord]])
                first_char = seq.char_at(strand, c, origin_coord + k if strand == 0
                                         else origin_coord - k)
                last_coord = (b + k - 1) if strand == 0 else L - 1 - (b + k - 1)
                o1 = int(seq.origpos[c][origin_coord])
                o2 = int(seq.origpos[c][last_coord])
                ostart, oend = (o1, o2) if o1 <= o2 else (o2, o1)
                actual_pos = a if strand == 0 else L - (a + step + k)
                edges.append(Edge(c, strand, prev_vertex, now_vertex,
                                  actual_pos, step + k, ostart, oend + 1 - ostart,
                                  first_char))
                prev_vertex = now_vertex
                prev_t = t
    return edges
