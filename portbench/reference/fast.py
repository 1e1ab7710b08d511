"""The judge of C-Sibelia under the port's fast aligner: every number of
``variants.judge_variants``, and the unique pairs' rows held exactly to
the aligner's plain reference (``anchored.py``).

``anchored_row_errors`` counts the unique pairs of the final blocks
whose two MAF rows differ in any column from the rows ``anchored`` gives
for the same two instances' bases (reference first, each read along its
strand), and those with no MAF group.  Ties count: a gap run placed at
another place of equal score, another chain of anchors or an entry of
the scoring off by one reads here, where the score windows cannot see
it.
"""
from __future__ import annotations

import os

from ..genomes import Inputs
from .anchored import anchored
from .variants import (group_key, instance_key, judge_variants, parse_maf,
                       revcomp, stage_blocks, unique_pairs)


def pair_rows(out: str, inputs: Inputs, min_size: int):
    """(reference row, assembly row, reference bases, assembly bases) of
    every unique pair of the final blocks, the rows None where the MAF has
    no group of the pair."""
    text = {n: s.seq.tobytes().decode() for n, s in zip(inputs.names, inputs.seqs)}
    groups = {group_key(g): g
              for g in parse_maf(os.path.join(out, "alignment.maf"))}
    final = stage_blocks(out)[-1]
    for r, a in unique_pairs(final, {inputs.names[0]}, min_size).values():
        g = groups.get(instance_key((r, a)))
        rows = {row[0]: row[5] for row in g} if g else {}
        bases = []
        for c, st, s, e in (r, a):
            seq = text[c][min(s, e) - 1:max(s, e)]
            bases.append(seq if st == "+" else revcomp(seq))
        yield rows.get(r[0]), rows.get(a[0]), bases[0], bases[1]


def anchored_row_errors(out: str, inputs: Inputs, min_size: int) -> int:
    return sum((r0, r1) != anchored(a.encode(), b.encode())
               for r0, r1, a, b in pair_rows(out, inputs, min_size))


def judge(out: str, inputs: Inputs, config: dict) -> dict[str, float]:
    nums = judge_variants(out, inputs, config["min_block_size"],
                          config["scoring"])
    nums["anchored_row_errors"] = anchored_row_errors(
        out, inputs, config["min_block_size"])
    return nums
