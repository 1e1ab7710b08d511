"""Judge C-Sibelia's ``alignment.maf`` and ``variant.vcf`` by what they
say, against the benchmark's own genomes and their provenance.

Plain numpy.  The MAF is held to the sequences (every row, gaps removed,
is its instance's bases) and to the ancestry (aligned bases descend from
one ancestor base).  The VCF is held exactly to the variants that
C-Sibelia's published rules derive from those alignments and from the
stages' blocks (C-Sibelia.py in bioinf/Sibelia: the diff of each unique
pair's rows with its 30-column context rule, the long indels of spans no
block covers, the breakends of unplaced insertions), worked out here
again from the files.
"""
from __future__ import annotations

import os
import re
from collections import Counter

import numpy as np

from ..genomes import Inputs
from .alignscore import subst_table, tie_errors, worst_deficit
from .blocks import judge_blocks, parse_coords

CONTEXT = 30
COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def strip_id(chr_id: str) -> str:
    fields = chr_id.split("|")
    return fields[3].split(".")[0] if len(fields) == 5 else chr_id


def stage_files(out: str) -> list[str]:
    names = [f for f in os.listdir(out)
             if re.fullmatch(r"blocks_coords[0-9]+\.txt", f)]
    names.sort(key=lambda f: int(f[13:-4]))
    return [os.path.join(out, f) for f in names]


def parse_maf(path: str) -> list[list[tuple[str, int, int, str, int, str]]]:
    """Alignment groups of (src, start, size, strand, src size, text)."""
    groups = []
    with open(path) as f:
        for line in f:
            if line.startswith("a"):
                groups.append([])
            elif line.startswith("s "):
                fields = line.split()
                text = fields[6] if len(fields) > 6 else ""
                groups[-1].append((fields[1], int(fields[2]), int(fields[3]),
                                   fields[4], int(fields[5]), text))
    return groups


def segments(match: np.ndarray) -> list[tuple[int, int, bool]]:
    """Column runs of the match mask, a match run shorter than CONTEXT
    between two mismatches fused into them (C-Sibelia's rule: not one at
    column 0, and never the last run)."""
    n = match.size
    if n == 0:
        return []
    edges = np.flatnonzero(match[1:] != match[:-1]) + 1
    starts = [0] + edges.tolist()
    ends = edges.tolist() + [n]
    out: list[tuple[int, int, bool]] = []
    seg = 0
    for r, (s, e) in enumerate(zip(starts, ends)):
        m = bool(match[s])
        if r == len(starts) - 1:
            out.append((seg, e, m))
        elif not m:
            out.append((seg, e, False))
            seg = e
        elif e - seg >= CONTEXT or seg == 0:
            out.append((seg, e, True))
            seg = e
        elif out:
            seg = out.pop()[0]
    return out


def pair_variants(row0: str, row1: str, chrom: str, start: int,
                  direction: int) -> list[tuple[str, str, str, str]]:
    """(CHROM, POS, REF, ALT) of one unique pair's rows: row0 the
    reference instance's, starting at `start` (1-based, strand-wise)."""
    a0 = np.frombuffer(row0.encode(), np.uint8)
    a1 = np.frombuffer(row1.encode(), np.uint8)
    base0 = a0 != ord("-")
    before = np.cumsum(base0) - base0
    out = []
    for s, e, m in segments(a0 == a1):
        if m:
            continue
        snp = e - s == 1 and base0[s] and a1[s] != ord("-")
        shift = 0 if (s == 0 or snp) else 1
        ref = row0[s - shift:e].replace("-", "")
        alt = row1[s - shift:e].replace("-", "")
        if direction < 0:
            ref, alt = revcomp(ref), revcomp(alt)
        pos = start + direction * int(before[s]) - shift
        out.append((chrom, str(pos), ref.upper(), alt.upper()))
    return out


def _forward(row) -> tuple[str, int, int]:
    src, start, size, strand, total, _ = row
    lo = start if strand == "+" else total - start - size
    return src, lo, lo + size


def group_key(group) -> frozenset:
    """A MAF group's instances as (sequence, forward start, end, strand)."""
    return frozenset((r[0],) + _forward(r)[1:] + (r[3],) for r in group)


def instance_key(instances) -> frozenset:
    """The same of a block's (sequence, strand, start, end) instances."""
    return frozenset((c, min(s, e) - 1, max(s, e), st)
                     for c, st, s, e in instances)


def unique_pairs(final, ref_names, min_size: int) -> dict[int, tuple]:
    """{block id: (reference instance, assembly instance)} of the final
    blocks that are one reference and one assembly instance, each of at
    least min_size bases: the pairs C-Sibelia aligns alone."""
    unique = {}
    for bid, inst in enumerate(final, 1):
        refs = [x for x in inst if x[0] in ref_names]
        asms = [x for x in inst if x[0] not in ref_names]
        if (len(inst) == 2 and len(refs) == 1 and len(asms) == 1
                and min(abs(x[3] - x[2]) + 1 for x in inst) >= min_size):
            unique[bid] = (refs[0], asms[0])
    return unique


def stage_blocks(out: str) -> list[list[tuple[str, str, int, int]]]:
    """The blocks of every stage's blocks_coords file, in stage order, as
    (sequence name, strand, start, end) instances."""
    stages = []
    for path in stage_files(out):
        table, blocks = parse_coords(path)
        name = {sid: desc for sid, _, desc in table}
        stages.append([[(name.get(sid, "?"), strand, start, end)
                        for sid, strand, start, end, _ in b] for b in blocks])
    return stages


def judge_variants(out: str, inputs: Inputs, min_size: int,
                   scoring: dict, vcf: str = "variant.vcf",
                   maf: str = "alignment.maf") -> dict[str, float]:
    """The final stage's blocks judged as ``judge_blocks`` does, and:

    maf_errors        MAF rows that are not their instance's bases, and
                      groups that are not one final block's instances
                      (or blocks with no group)
    misaligned_share  the worst alignment's share of columns, among those
                      where both rows hold a base that descends from the
                      ancestor, whose two bases descend from different
                      ancestor bases
    score_deficit     over the unique pairs' alignments, the largest score
                      by which a window around a gap run could be
                      aligned better under the aligner's own `scoring`
                      (``alignscore.worst_deficit``)
    tie_errors        gap runs of those alignments that could move one
                      column on at an equal score: the aligner's traceback
                      places each as far on as its score allows
    vcf_errors        header lines and records by which the VCF differs
                      from the variants derived again here, and records
                      out of order
    """
    nums = judge_blocks(stage_files(out)[-1], inputs, min_size)
    seq_of = dict(zip(inputs.names, inputs.seqs))
    text_of = {n: s.seq.tobytes().decode() for n, s in seq_of.items()}
    ref_names = {inputs.names[0]}
    stages = stage_blocks(out)
    final = stages[-1]

    # the MAF against the sequences, the final blocks and the ancestry
    groups = parse_maf(os.path.join(out, maf))
    maf_errors = abs(len(groups) - len(final))
    by_region = {}
    for g in groups:
        by_region[group_key(g)] = g
    worst = 0.0
    for inst in final:
        if instance_key(inst) not in by_region:
            maf_errors += 1
    for g in groups:
        cols = []
        for row in g:
            src, lo, hi = _forward(row)
            text = row[5]
            if src not in seq_of or row[4] != len(seq_of[src].seq):
                maf_errors += 1
                cols.append(None)
                continue
            bases = text_of[src][lo:hi]
            if row[3] == "-":
                bases = revcomp(bases)
            if text.replace("-", "").upper() != bases.upper():
                maf_errors += 1
                cols.append(None)
                continue
            t = np.frombuffer(text.encode(), np.uint8)
            has = t != ord("-")
            k = np.cumsum(has) - 1
            fwd = lo + k if row[3] == "+" else hi - 1 - k
            anc = np.where(has, seq_of[src].src[np.clip(fwd, lo, hi - 1)], -1)
            cols.append(anc)
        if cols and cols[0] is not None:
            for anc in cols[1:]:
                if anc is None or anc.size != cols[0].size:
                    continue
                both = (cols[0] >= 0) & (anc >= 0)
                if both.any():
                    worst = max(worst, float((cols[0][both] != anc[both]).mean()))

    # the variants derived again
    want_var: list[tuple[str, str, str, str]] = []
    unique = unique_pairs(final, ref_names, min_size)
    table = subst_table(scoring)
    deficit = 0.0
    ties = 0
    for bid, (r, a) in unique.items():
        g = by_region.get(instance_key((r, a)))
        if g is None:
            continue
        rows = {row[0]: row[5] for row in g}
        direction = 1 if r[1] == "+" else -1
        want_var += pair_variants(rows[r[0]], rows[a[0]], strip_id(r[0]),
                                  r[2], direction)
        deficit = max(deficit, worst_deficit(rows[r[0]], rows[a[0]], scoring,
                                             table=table))
        ties += tie_errors(rows[r[0]], rows[a[0]])
    cover_all = {n: np.zeros(len(s.seq), np.int64) for n, s in seq_of.items()}
    cover_main = {n: np.zeros(len(s.seq), np.int64) for n, s in seq_of.items()}
    for i, blocks in enumerate(stages):
        for bid, inst in enumerate(blocks, 1):
            n_ref = sum(x[0] in ref_names for x in inst)
            if not 0 < n_ref < len(inst):
                continue
            for c, _, s, e in inst:
                if c in cover_all:
                    cover_all[c][min(s, e) - 1:max(s, e)] = bid
                    if i == len(stages) - 1:
                        cover_main[c][min(s, e) - 1:max(s, e)] = bid
    bnds = []
    ref0 = inputs.names[0]
    for name, cov in cover_all.items():
        bare = np.concatenate([[0], (cov == 0).astype(np.int8), [0]])
        step = np.diff(bare)
        for s, e in zip(np.flatnonzero(step == 1), np.flatnonzero(step == -1)):
            s, e = int(s), int(e)
            if e - s <= min_size:
                continue
            text = text_of[name]
            if name in ref_names:
                anchor = text[s - 1] if s > 0 else ""
                want_var.append((strip_id(name), str(s),
                                 (anchor + text[s:e]).upper(),
                                 anchor.upper() if anchor else "."))
                continue
            placed = False
            left = int(cover_main[name][s - 1]) if s > 0 else 0
            if left and left in unique:
                r, a = unique[left]
                pos = (max(r[2], r[3]) if r[1] == a[1]
                       else min(r[2], r[3]) - 1)
                if pos > 0:
                    anchor = text_of[r[0]][pos - 1].upper()
                    want_var.append((strip_id(r[0]), str(pos), anchor,
                                     anchor + text[s:e].upper()))
                    placed = True
            if not placed:
                bnds.append((name, s, e - s))
    ref_text = text_of[ref0]
    info = f"IMPRECISE;SVTYPE=BND;CIPOS=0,{len(ref_text)}"
    base = ref_text[0]
    want_bnd = Counter()
    for contig, s, n in bnds:
        want_bnd[(strip_id(ref0), "1", base, f"{base}[{contig}:{s + 1}[", info)] += 1
        want_bnd[(strip_id(ref0), "1", base, f"]{contig}:{s + 1 + n}]{base}", info)] += 1

    header = ["##fileformat=VCFv4.1", "##source=C-Sibelia 3.0.5",
              f"##reference={strip_id(ref0)}",
              '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
              '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">',
              '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS for imprecise variants">',
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    with open(os.path.join(out, vcf)) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    vcf_errors = sum(a != b for a, b in zip(lines, header)) + max(
        0, len(header) - len(lines))
    got_bnd, got_var, last_pos = Counter(), Counter(), -1
    for line in lines[len(header):]:
        f = line.split("\t")
        if len(f) == 8 and f[2].startswith("bnd_"):
            got_bnd[(f[0], f[1], f[3], f[4], f[7])] += 1
        elif len(f) == 8 and f[2] == "." and f[5:] == [".", ".", "."]:
            got_var[(f[0], f[1], f[3], f[4])] += 1
            pos = int(f[1])
            vcf_errors += pos < last_pos
            last_pos = pos
        else:
            vcf_errors += 1
    vcf_errors += sum(((got_bnd - want_bnd) + (want_bnd - got_bnd)).values())
    want = Counter(want_var)
    vcf_errors += sum(((got_var - want) + (want - got_var)).values())
    nums.update({"maf_errors": maf_errors, "misaligned_share": worst,
                 "score_deficit": deficit, "tie_errors": ties,
                 "vcf_errors": vcf_errors})
    return nums


def judge(out: str, inputs: Inputs, config: dict) -> dict[str, float]:
    """C-Sibelia's judge: ``judge_variants`` under the configuration's
    ``scoring``."""
    return judge_variants(out, inputs, config["min_block_size"],
                          config["scoring"])
