"""Judge a ``blocks_coords`` file by what it says, against the provenance
of the bases the benchmark made.

Plain numpy; it reads the program's output file and the benchmark's own
genomes, nothing of the program.  Each number is an error measure: 0, or
a share, that a sound run keeps under the configuration's limit.
"""
from __future__ import annotations

import os

import numpy as np

from ..genomes import Inputs


def parse_coords(path: str) -> tuple[list[tuple[int, int, str]],
                                     list[list[tuple[int, str, int, int, int]]]]:
    """(sequence table rows (id, size, description), blocks as lists of
    instance rows (seq id, strand, start, end, length))."""
    with open(path) as f:
        lines = f.read().split("\n")
    table, blocks = [], []
    in_table = True
    for line in lines:
        if not line:
            continue
        if line.startswith("-"):
            in_table = False
            continue
        if line.startswith("Seq_id"):
            continue
        if line.startswith("Block #"):
            blocks.append([])
            continue
        fields = line.split("\t")
        if in_table:
            table.append((int(fields[0]), int(fields[1]), fields[2]))
        else:
            blocks[-1].append((int(fields[0]), fields[1], int(fields[2]),
                               int(fields[3]), int(fields[4])))
    return table, blocks


def judge_blocks(path: str, inputs: Inputs, min_size: int) -> dict[str, float]:
    """The numbers of one blocks_coords file:

    table_errors        rows of the sequence table that differ from the
                        input (id, length, name), and rows missing
    instance_errors     instances out of their sequence, with a Length
                        that is not their span, a strand that disagrees
                        with Start/End, shorter than min_size, or alone in
                        their block
    overlap_bases       bases that two instances claim
    orientation_errors  blocks whose instances disagree on the ancestor's
                        orientation once their strands are applied
    nonhomologous_share the worst instance's share of ancestor bases that
                        no other instance of its block holds
    uncovered_share     the least covered sequence's share of bases in no
                        block
    """
    table, blocks = parse_coords(path)
    want = [(i + 1, len(s.seq), name)
            for i, (name, s) in enumerate(zip(inputs.names, inputs.seqs))]
    table_errors = sum(a != b for a, b in zip(table, want)) + abs(
        len(table) - len(want))
    cover = [np.zeros(len(s.seq), np.int32) for s in inputs.seqs]
    instance_errors = orientation_errors = 0
    worst = 0.0
    for block in blocks:
        if len(block) < 2:
            instance_errors += 1
        ancestors, signs = [], set()
        for sid, strand, start, end, length in block:
            lo, hi = min(start, end), max(start, end)
            if (not 1 <= sid <= len(inputs.seqs) or strand not in "+-"
                    or lo < 1 or hi > len(inputs.seqs[sid - 1].seq)
                    or length != hi - lo + 1 or length < min_size
                    or (strand == "+") != (start <= end)):
                instance_errors += 1
                continue
            s = inputs.seqs[sid - 1]
            cover[sid - 1][lo - 1:hi] += 1
            src = s.src[lo - 1:hi]
            kept = src >= 0
            ancestors.append(src[kept])
            ori = int(np.sign(s.ori[lo - 1:hi][kept].astype(np.int64).sum()))
            signs.add(ori * (1 if strand == "+" else -1))
        if len(signs) > 1:
            orientation_errors += 1
        for i, own in enumerate(ancestors):
            if own.size == 0:
                continue
            others = [a for j, a in enumerate(ancestors) if j != i]
            held = np.isin(own, np.concatenate(others)) if others else \
                np.zeros(own.size, bool)
            worst = max(worst, 1.0 - float(held.mean()))
    overlap = int(sum(int(np.maximum(c - 1, 0).sum()) for c in cover))
    uncovered = max(float((c == 0).mean()) for c in cover)
    return {"table_errors": table_errors, "instance_errors": instance_errors,
            "overlap_bases": overlap, "orientation_errors": orientation_errors,
            "nonhomologous_share": worst, "uncovered_share": uncovered}


def judge(out: str, inputs: Inputs, config: dict) -> dict[str, float]:
    """Sibelia's judge: ``judge_blocks`` of the job's blocks_coords.txt."""
    return judge_blocks(os.path.join(out, "blocks_coords.txt"), inputs,
                        config["min_block_size"])
