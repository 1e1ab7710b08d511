"""BlockFinder: pipeline state across simplification stages (port of
``sibelia_tpu/blocks/finder.py``).

Reference: src/blockfinder.{h,cpp}. Holds the working sequence (raw_seq)
and per-element original positions; each stage rebuilds the index at that
stage's k, simplifies, and writes the shrunken sequence back.

Every whole-genome enumeration runs on the finder's device; the sweep runs
in the native engine with the port's device re-prefilter
(``native/engine_runner.py``).  ``serialize_condensed_graph`` (``-g``)
builds its index on the host.  The Python engine with its runtime invariant
check (``SIBELIA_TPU_CHECK=1``) and checkpoints are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import timings
from ..core.glibc_rand import GlibcRand
from ..graph.indexed import (randomize_ambiguous, randomize_and_enumerate,
                             store_from_enum)
from ..graph.sequence import MutableSequence
from ..index.enumeration import enumerate_bifurcations_host
from ..io.fasta import FASTARecord
from ..native.engine_runner import simplify
from .edges import list_edges
from .instance import BlockInstance
from .synteny import generate_synteny_blocks


class BlockFinder:
    def __init__(self, chr_list: list[FASTARecord], device: torch.device,
                 rand: GlibcRand | None = None):
        self.chr_list = chr_list
        self.device = device
        self.rand = rand if rand is not None else GlibcRand(1)
        # working sequence as uint8 arrays (adopted by MutableSequence
        # each stage without copying; rebound from it afterwards)
        self.raw_seq: list[np.ndarray] = [
            np.frombuffer(r.sequence.encode(), dtype=np.uint8).copy()
            for r in chr_list]
        self.original_size = [len(s) for s in self.raw_seq]
        self.original_pos = [np.arange(len(s), dtype=np.int32)
                             for s in self.raw_seq]

    def perform_graph_simplifications(self, k: int, min_branch: int,
                                      max_iterations: int,
                                      progress=None) -> int:
        """Reference: blockfinder.cpp:78-98."""
        seq = MutableSequence(self.raw_seq, self.original_pos)
        # seq adopts the arrays; drop the aliases so the engine's buffer
        # release frees them (rebound from seq below)
        self.raw_seq = self.original_pos = None
        with timings.phase("enumeration"):
            enum = randomize_and_enumerate(seq, k, self.rand, min_branch,
                                           self.device)
        with timings.phase("simplification"):
            ret = simplify(seq, enum, k, min_branch, max_iterations,
                           self.device, candidates=enum.candidates,
                           release_enum=True, progress=progress)
        self.raw_seq = seq.chars
        self.original_pos = seq.origpos
        return ret

    def generate_synteny_blocks(self, k: int, trim_k: int, min_size: int,
                                shared_only: bool = False,
                                progress=None) -> list[BlockInstance]:
        with timings.phase("block_generation"):
            return generate_synteny_blocks(
                self.chr_list, self.raw_seq, self.original_pos,
                self.original_size, k, trim_k, min_size, shared_only,
                self.rand, self.device, progress=progress)

    def serialize_condensed_graph(self, k: int, out, progress=None) -> None:
        """Reference: serialization.cpp:88-110 (dot format); progress =
        PutProgressChr-style bar over the edge list (sibelia.cpp:261)."""
        seq = MutableSequence(self.raw_seq, self.original_pos)
        # on the host: the -g flows rebuild the index at a k they just
        # enumerated, which the native ranking's cache serves
        randomize_ambiguous(seq, self.rand)
        store = store_from_enum(seq, enumerate_bifurcations_host(seq.chars,
                                                                 k))
        edges = list_edges(seq, store, k)
        if progress is not None:
            progress(0, 0)
        out.write("digraph G\n{\n")
        out.write("rankdir=LR\n")
        # pace the 50-dot bar over the edge list, as the reference's
        # PutProgressChr does over its serialization work
        n_edges = len(edges)
        for i, e in enumerate(edges):
            if progress is not None and n_edges:
                progress((i + 1) * 50 // n_edges, 1)
            color = "blue" if e.direction == 0 else "red"
            out.write(
                f"{e.start_vertex} -> {e.end_vertex} "
                f"[color=\"{color}\", label=\"chr={e.chr} pos={e.actual_position} "
                f"len={e.actual_length} orpos={e.original_position} "
                f"orlen={e.original_length}  ch='{chr(e.first_char)}'\"];\n")
        out.write("}\n")
        if progress is not None:
            progress(50, 2)
