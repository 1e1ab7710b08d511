"""The benchmark's genomes: related bacterial strains made from a seed.

A frozen copy of ``chip_smoke.py::make_strains`` and
``write_csibelia_pair`` (the mutation mix of ``scripts/gen_strains.py``,
vectorised with numpy): the same seed gives the same bases as there.  The
copy also carries each base's provenance, which the reference reads to
judge the program's answers: ``src`` is the position in the common
ancestor a base descends from (-1 for an inserted base) and ``ori`` is +1
where the strain reads the ancestor forward, -1 inside an inversion.
SNPs keep a base's provenance.

A traffic file may change the mutation mix (``snp_rate``, ``indels``,
``indel_length``) and ask for repeat families (``repeats``); without
those keys the draws, their order and every base are chip_smoke's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")


@dataclass
class Strain:
    seq: np.ndarray   # uint8 ASCII bases
    src: np.ndarray   # int64 ancestor position, -1 where inserted
    ori: np.ndarray   # int8 +1 forward, -1 inverted


# chip_smoke's mutation mix: a strain's SNP rate, its count of indels and
# their lengths, each drawn from [lo, hi] (the counts inclusive)
MIX = {"snp_rate": (0.005, 0.0075), "indels": (20, 60), "indel_length": (1, 30)}


def plant_repeats(seq: np.ndarray, src: np.ndarray, ori: np.ndarray,
                  spec: dict, rng, lay) -> list[tuple[int, int]]:
    """Repeat families written over the ancestor (`seq`, `src`, `ori`, in
    place); returns each family's (start, length) in the ancestor.

    `spec` gives [lo, hi] ranges (counts inclusive): ``families``, their
    ``length`` and ``copies`` (the first copy included), and ``copy_snp``,
    each further copy's SNP rate.  The copies lie apart from each other,
    in an order and at places drawn from `lay`; a further copy reads its
    family forward or reverse-complemented (even odds), and every base of
    it has as its provenance the matching base of the family's first copy,
    so two copies of one family descend from the same ancestor bases.  The
    SNPs' bases come from `rng`."""
    size = len(seq)
    if spec["copies"][0] < 1:
        raise ValueError("a repeat family has one copy or more")
    n = int(lay.integers(spec["families"][0], spec["families"][1] + 1))
    length = lay.integers(spec["length"][0], spec["length"][1] + 1, n)
    copies = lay.integers(spec["copies"][0], spec["copies"][1] + 1, n)
    family = np.repeat(np.arange(n), copies)   # one entry a copy
    free = size - int(length[family].sum())
    if free < 0:
        raise ValueError(f"repeats of {size - free} bases exceed {size}")
    order = lay.permutation(family.size)       # the copies along the ancestor
    gaps = np.sort(lay.integers(0, free + 1, family.size))
    lens = length[family[order]]
    at = np.empty(family.size, np.int64)
    at[order] = gaps + np.concatenate([[0], np.cumsum(lens)[:-1]])
    first = np.searchsorted(family, np.arange(n))  # each family's first copy
    origins = [(int(at[c]), int(length[f])) for f, c in enumerate(first)]
    for c in sorted(set(range(family.size)) - set(first.tolist())):
        p0, ln = origins[family[c]]
        cut = slice(at[c], at[c] + ln)
        seq[cut], src[cut], ori[cut] = copy_of(seq, p0, ln, spec, rng, lay)
    return origins


def copy_of(seq: np.ndarray, p0: int, ln: int, spec: dict, rng, lay
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bases, provenance, orientation) of a further copy of the family at
    seq[p0:p0 + ln]: forward or reverse-complemented at even odds, with
    SNPs at a rate drawn from ``spec["copy_snp"]``."""
    bases, own = seq[p0:p0 + ln].copy(), np.arange(p0, p0 + ln)
    sign = np.ones(ln, np.int8)
    if lay.random() < 0.5:
        bases, own, sign = COMP[bases][::-1], own[::-1], -sign
    hit = np.flatnonzero(lay.random(ln) < lay.uniform(*spec["copy_snp"]))
    bases[hit] = ACGT[rng.integers(0, 4, hit.size)]
    return bases, own, sign


def make_strains(n_strains: int, size: int, seed: int,
                 layout_seed: int | None = None,
                 mix: dict | None = None) -> list[Strain]:
    """n_strains mutated copies of one random ancestor of `size` bases:
    0.5-0.75 % SNPs, 20-60 indels of 1-30 bp, and above 200 kbp 1-4
    inversions of 10-50 kbp and, in 70 % of strains, a translocation of
    20-60 kbp.  The draws are chip_smoke's, in its order.

    With `layout_seed`, every draw of a position, a length, a count or a
    rate comes from it, and `seed` draws the bases alone (the ancestor's,
    the SNPs' and the insertions'): seeds then give other sequences with
    the same mutations at the same places, so the work a job does is the
    same from seed to seed.  Without it, one stream draws all, as
    chip_smoke does.

    `mix` (a traffic file's keys) may set ``snp_rate``, ``indels`` and
    ``indel_length`` as [lo, hi] in place of ``MIX``'s, and ``repeats``:
    families planted in the ancestor before any strain is drawn
    (``plant_repeats``), with optionally ``strain_copies`` [lo, hi],
    further copies of random families inserted into each strain alone
    after its indels (a transposition), drawn as the ancestor's copies."""
    mix = {**MIX, **(mix or {})}
    rng = np.random.default_rng(seed)
    lay = rng if layout_seed is None else np.random.default_rng(layout_seed)
    base = ACGT[rng.integers(0, 4, size)]
    base_src = np.arange(size, dtype=np.int64)
    base_ori = np.ones(size, dtype=np.int8)
    repeats = mix.get("repeats")
    origins = (plant_repeats(base, base_src, base_ori, repeats, rng, lay)
               if repeats else [])
    (snp_lo, snp_hi), (n_lo, n_hi), (len_lo, len_hi) = (
        mix["snp_rate"], mix["indels"], mix["indel_length"])
    strains = []
    for _ in range(n_strains):
        s = base.copy()
        src = base_src.copy()
        ori = base_ori.copy()
        hit = np.flatnonzero(lay.random(size) < lay.uniform(snp_lo, snp_hi))
        s[hit] = ACGT[rng.integers(0, 4, hit.size)]
        for _ in range(int(lay.integers(n_lo, n_hi + 1))):
            pos = int(lay.integers(len(s)))
            ln = int(lay.integers(len_lo, len_hi + 1))
            if lay.random() < 0.5:
                s = np.concatenate([s[:pos], s[pos + ln:]])
                src = np.concatenate([src[:pos], src[pos + ln:]])
                ori = np.concatenate([ori[:pos], ori[pos + ln:]])
            else:
                s = np.concatenate([s[:pos], ACGT[rng.integers(0, 4, ln)],
                                    s[pos:]])
                src = np.concatenate([src[:pos], np.full(ln, -1, np.int64),
                                      src[pos:]])
                ori = np.concatenate([ori[:pos], np.ones(ln, np.int8),
                                      ori[pos:]])
        if repeats and "strain_copies" in repeats:
            lo, hi = repeats["strain_copies"]
            for _ in range(int(lay.integers(lo, hi + 1))):
                p0, ln = origins[int(lay.integers(len(origins)))]
                pos = int(lay.integers(len(s) + 1))
                bases, own, sign = copy_of(base, p0, ln, repeats, rng, lay)
                s = np.concatenate([s[:pos], bases, s[pos:]])
                src = np.concatenate([src[:pos], own, src[pos:]])
                ori = np.concatenate([ori[:pos], sign, ori[pos:]])
        if len(s) > 200_000:
            for _ in range(int(lay.integers(1, 5))):
                a = int(lay.integers(len(s) - 50_000))
                b = a + int(lay.integers(10_000, 50_001))
                s[a:b] = COMP[s[a:b]][::-1]
                src[a:b] = src[a:b][::-1].copy()
                ori[a:b] = -ori[a:b][::-1]
            if lay.random() < 0.7:
                a = int(lay.integers(len(s) - 80_000))
                b = a + int(lay.integers(20_000, 60_001))
                at = int(lay.integers(len(s) - (b - a)))

                def move(x):
                    chunk, rest = x[a:b], np.concatenate([x[:a], x[b:]])
                    return np.concatenate([rest[:at], chunk, rest[at:]])
                s, src, ori = move(s), move(src), move(ori)
        strains.append(Strain(s, src, ori))
    return strains


def contig_cuts(length: int, seed: int, lo: int = 20_000,
                hi: int = 200_000) -> list[int]:
    """Cut points of an assembly into contigs of lo-hi bases."""
    rng = np.random.default_rng(seed + 1)
    cuts = [0]
    while length - cuts[-1] > hi:
        cuts.append(cuts[-1] + int(rng.integers(lo, hi + 1)))
    cuts.append(length)
    return cuts


def write_fasta(path: str, seqs: list[np.ndarray], names: list[str]) -> None:
    with open(path, "w") as h:
        for name, s in zip(names, seqs):
            h.write(f">{name}\n")
            text = s.tobytes().decode()
            for j in range(0, len(text), 80):
                h.write(text[j:j + 80] + "\n")


@dataclass
class Inputs:
    """A job's input: its FASTA files and, in their order, each sequence's
    name and the provenance of its bases."""
    fastas: list[str]
    names: list[str]
    seqs: list[Strain]

    @property
    def bases(self) -> int:
        return sum(len(s.seq) for s in self.seqs)


def make_inputs(traffic: dict, seed: int, directory: str) -> Inputs:
    """The genomes a traffic file describes, made from `seed` and written as
    FASTA into `directory`: ``strains`` (one file of n strains) or ``pair``
    (a reference strain, and a second strain cut into contigs).  The
    traffic's ``layout_seed``, where it has one, fixes where the mutations
    and the contig cuts fall; its mutation keys go to ``make_strains``."""
    seed %= 2 ** 64
    layout = traffic.get("layout_seed")
    if traffic["genomes"] == "strains":
        strains = make_strains(traffic["strains"], traffic["length"], seed,
                               layout, traffic)
        names = [f"strain_{i:02d}" for i in range(len(strains))]
        path = os.path.join(directory, "genomes.fasta")
        write_fasta(path, [s.seq for s in strains], names)
        return Inputs([path], names, strains)
    if traffic["genomes"] == "pair":
        ref, asm = make_strains(2, traffic["length"], seed, layout, traffic)
        cuts = contig_cuts(len(asm.seq), seed if layout is None else layout,
                           traffic["contig_min"], traffic["contig_max"])
        contigs = [Strain(asm.seq[lo:hi], asm.src[lo:hi], asm.ori[lo:hi])
                   for lo, hi in zip(cuts, cuts[1:])]
        names = [f"contig_{i:03d}" for i in range(len(contigs))]
        paths = [os.path.join(directory, "reference.fasta"),
                 os.path.join(directory, "assembly.fasta")]
        write_fasta(paths[0], [ref.seq], ["reference"])
        write_fasta(paths[1], [c.seq for c in contigs], names)
        return Inputs(paths, ["reference"] + names, [ref] + contigs)
    raise ValueError(f"unknown genomes kind {traffic['genomes']!r}")
