"""Boundary correction for unique synteny block pairs (--correctboundaries).

Exact port of Postprocessor::ImproveBlockBoundaries (reference:
src/postprocessor.cpp:158-348): for each block with exactly one copy in
the reference genome and one in the assembly, locally align the
+/-correction-range flanks (SeqAn semantics, score 25/-75/-75; see
align/seqan_local.py) and move both boundaries.
"""
from __future__ import annotations

from ..align.seqan_local import seqan_local_alignment
from ..core.stdsort import group_by
from ..io.fasta import reverse_complement
from .instance import BlockInstance

MAX_CORRECTION_RANGE = 1 << 10


def _previous_block(block: BlockInstance, block_list):
    ret = None
    start = block.start
    for b in block_list:
        if b != block and b.chr_id == block.chr_id and b.end <= start:
            if ret is None or start - b.end < start - ret.end:
                ret = b
    return ret


def _next_block(block: BlockInstance, block_list):
    ret = None
    end = block.end
    for b in block_list:
        if b != block and b.chr_id == block.chr_id and b.start >= end:
            if ret is None or b.start - end < ret.start - end:
                ret = b
    return ret


def _left_boundaries(block_list, i, rng):
    block = block_list[i]
    hi = block.start + rng
    prev = _previous_block(block, block_list)
    if prev is not None:
        lo = max(prev.end, block.start - rng) + 1
    else:
        lo = block.start - rng + 1 if block.start >= rng else 0
    return lo, hi


def _right_boundaries(block_list, i, rng):
    block = block_list[i]
    lo = block.end - rng + 1
    nxt = _next_block(block, block_list)
    if nxt is not None:
        hi = min(nxt.start, block.end + rng)
    else:
        chr_size = len(block.chr.sequence)
        hi = block.end + rng if block.end + rng < chr_size else chr_size
    return lo, hi


def _boundaries_sequence(block, left, right):
    chrs = block.chr.sequence
    if block.signed_id > 0:
        start = chrs[left[0]:left[1]]
        end = chrs[right[0]:right[1]]
    else:
        start = reverse_complement(chrs[right[0]:right[1]])
        end = reverse_complement(chrs[left[0]:left[1]])
    return start, end


def _update_boundaries(block_list, i, left, right, start_coord, end_coord):
    b = block_list[i]
    if b.signed_id > 0:
        new_start = left[0] + start_coord[0]
        new_end = right[0] + end_coord[1]
    else:
        new_start = left[1] - end_coord[1]
        new_end = right[1] - start_coord[0]
    block_list[i] = BlockInstance(b.signed_id, b.chr, new_start, new_end)


def _correct_pair(block_list, ref_i, asm_i, rng):
    ref_left = _left_boundaries(block_list, ref_i, rng)
    ref_right = _right_boundaries(block_list, ref_i, rng)
    asm_left = _left_boundaries(block_list, asm_i, rng)
    asm_right = _right_boundaries(block_list, asm_i, rng)
    ref_start, ref_end = _boundaries_sequence(block_list[ref_i], ref_left, ref_right)
    asm_start, asm_end = _boundaries_sequence(block_list[asm_i], asm_left, asm_right)
    rs0, rs1, as0, as1, _ = seqan_local_alignment(ref_start.encode(), asm_start.encode())
    re0, re1, ae0, ae1, _ = seqan_local_alignment(ref_end.encode(), asm_end.encode())
    _update_boundaries(block_list, ref_i, ref_left, ref_right, (rs0, rs1), (re0, re1))
    _update_boundaries(block_list, asm_i, asm_left, asm_right, (as0, as1), (ae0, ae1))


def improve_block_boundaries(block_list: list[BlockInstance],
                             reference_chr_id: set[int],
                             min_block_size: int = 5000) -> None:
    """Mutates block_list in place (reference: postprocessor.cpp:317-348)."""
    rng = min(min_block_size, MAX_CORRECTION_RANGE)
    groups = group_by(block_list, lambda a, b: a.block_id < b.block_id)
    for g0, g1 in groups:
        in_reference = sum(1 for i in range(g0, g1)
                           if block_list[i].chr_id in reference_chr_id)
        in_assembly = (g1 - g0) - in_reference
        if in_reference == 1 and in_assembly == 1:
            if block_list[g0].chr_id not in reference_chr_id:
                block_list[g0], block_list[g0 + 1] = block_list[g0 + 1], block_list[g0]
            if block_list[g0].signed_id < 0:
                for i in (g0, g0 + 1):
                    b = block_list[i]
                    block_list[i] = BlockInstance(-b.signed_id, b.chr, b.start, b.end)
            _correct_pair(block_list, g0, g0 + 1, rng)
