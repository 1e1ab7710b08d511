"""The generator: the same seed gives the same genomes, the bases are
chip_smoke's, and the provenance follows every mutation."""
import hashlib
import json
import os

import numpy as np
import pytest

from portbench.genomes import COMP, contig_cuts, make_inputs, make_strains
from portbench.reference.blocks import judge_blocks
from portbench.run import ROOT

# sha256 of the FASTA files (in their order) that each traffic file of the
# benchmark gave before a traffic could change the mutation mix: the same
# traffic and seed must still give the same bases
FASTA_SHA256 = {
    ("hpylori2", 1):
        "5e91dd2133dff209828f054d0170582975cce76f27555f33f99c9bcd9b80facd",
    ("hpylori2", 2**40 + 3):
        "be5afe9a4ae432ccc29e57391b6cf5bf3b093cae58707702817e4f947139fa8c",
    ("saureus4", 1):
        "746ec65aca1ffc2281970fd61a89e0b63573eaef8038f52683977ba477e569e3",
    ("saureus4", 2**40 + 3):
        "4497455716fe3f398b335a958c8378c9d2fb02a1b0175323575e2895a06406ba",
    ("saureus_half_pair", 1):
        "0af1b97dfc5be53ca20f6cd92ba29dbb1c0202b54b2d43fb931ad6d72d3aee14",
    ("saureus_half_pair", 2**40 + 3):
        "f8b0a49765da76d2e1b423097c78ee0cf20ae3d45db19fb631264eda554ae736",
}


def test_same_seed_same_strains_other_seed_other_strains():
    a, b = make_strains(3, 250_000, 2**31 + 7), make_strains(3, 250_000, 2**31 + 7)
    c = make_strains(3, 250_000, 2**31 + 8)
    for x, y in zip(a, b):
        assert np.array_equal(x.seq, y.seq)
        assert np.array_equal(x.src, y.src) and np.array_equal(x.ori, y.ori)
    assert not np.array_equal(a[0].seq, c[0].seq)


def test_bases_are_chip_smokes():
    import chip_smoke
    for seed in (3, 2**33 + 1):
        want = chip_smoke.make_strains(2, 250_000, seed)
        got = make_strains(2, 250_000, seed)
        assert all(np.array_equal(w, g.seq) for w, g in zip(want, got))


def test_provenance_points_at_the_ancestor():
    """A base that descends from the ancestor is the ancestor's base (its
    complement where inverted) but for the SNPs, which are under 1 %."""
    seed = 11
    rng = np.random.default_rng(seed)
    ancestor = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 250_000)]
    for s in make_strains(3, 250_000, seed):
        kept = s.src >= 0
        want = ancestor[s.src[kept]]
        want = np.where(s.ori[kept] > 0, want, COMP[want])
        assert (s.seq[kept] != want).mean() < 0.01
        assert np.unique(s.src[kept]).size == kept.sum()


def test_pair_is_a_reference_and_contigs_of_the_second_strain(tmp_path):
    traffic = {"genomes": "pair", "length": 250_000, "contig_min": 20_000,
               "contig_max": 60_000}
    inputs = make_inputs(traffic, 2**40 + 1, str(tmp_path))
    ref, asm = make_strains(2, 250_000, (2**40 + 1) % 2**64)
    assert np.array_equal(inputs.seqs[0].seq, ref.seq)
    assert np.array_equal(np.concatenate([s.seq for s in inputs.seqs[1:]]), asm.seq)
    sizes = np.diff(contig_cuts(len(asm.seq), 2**40 + 1, 20_000, 60_000))
    assert (sizes[:-1] >= 20_000).all() and (sizes <= 60_000).all()
    assert inputs.bases == len(ref.seq) + len(asm.seq)
    text = open(inputs.fastas[1]).read()
    assert text.count(">") == len(inputs.seqs) - 1


def test_a_layout_seed_fixes_the_mutations_and_the_seed_the_bases():
    a = make_strains(2, 250_000, 1, layout_seed=99)
    b = make_strains(2, 250_000, 2**35 + 2, layout_seed=99)
    for x, y in zip(a, b):
        assert np.array_equal(x.src, y.src) and np.array_equal(x.ori, y.ori)
        assert (x.seq != y.seq).mean() > 0.5


@pytest.mark.parametrize("traffic,seed", sorted(FASTA_SHA256))
def test_the_benchmarks_traffic_gives_the_same_fasta(traffic, seed, tmp_path):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{traffic}.json")) as f:
        inputs = make_inputs(json.load(f), seed, str(tmp_path))
    h = hashlib.sha256()
    for path in inputs.fastas:
        with open(path, "rb") as f:
            h.update(f.read())
    assert h.hexdigest() == FASTA_SHA256[(traffic, seed)]


REPEATS = {"families": [3, 3], "length": [1000, 2000], "copies": [3, 3],
           "copy_snp": [0, 0.01]}


def _copies(strain, families):
    """(family, start, end) of each run of bases that descend from one
    family, the run at least 500 bases."""
    fam = np.full(strain.src.size, -1)
    for f, (p0, ln) in enumerate(families):
        fam[(strain.src >= p0) & (strain.src < p0 + ln)] = f
    edges = np.flatnonzero(np.diff(fam)) + 1
    starts, ends = np.r_[0, edges], np.r_[edges, fam.size]
    return [(int(fam[a]), int(a), int(b)) for a, b in zip(starts, ends)
            if fam[a] >= 0 and b - a >= 500]


def _coords(path, inputs, blocks):
    """A blocks_coords file of `blocks`, lists of (sequence index, start,
    end) 0-based half-open, each instance on the strand its orientation
    gives."""
    with open(path, "w") as f:
        f.write("Seq_id\tSize\tDescription\n")
        for i, (name, s) in enumerate(zip(inputs.names, inputs.seqs), 1):
            f.write(f"{i}\t{len(s.seq)}\t{name}\n")
        f.write("-" * 80 + "\n")
        for b, block in enumerate(blocks, 1):
            f.write(f"Block #{b}\nSeq_id\tStrand\tStart\tEnd\tLength\n")
            for sid, lo, hi in block:
                fwd = inputs.seqs[sid].ori[lo:hi].sum() > 0
                start, end = (lo + 1, hi) if fwd else (hi, lo + 1)
                f.write(f"{sid + 1}\t{'+' if fwd else '-'}\t{start}\t{end}\t"
                        f"{hi - lo}\n")
            f.write("-" * 80 + "\n")


def test_repeat_copies_descend_from_their_familys_bases(tmp_path):
    """Three families of 1-2 kbp, three copies each, in 250 kbp strains
    with no other SNP or indel: every family base is held by three bases
    of each strain, each its family's ancestor base (complemented where
    read reverse) but for the copies' SNPs; a block of two copies of one
    family is homologous, and one that joins two families is not."""
    traffic = {"genomes": "strains", "strains": 2, "length": 250_000,
               "layout_seed": 5, "snp_rate": [0, 0], "indels": [0, 0],
               "repeats": REPEATS}
    seed = 2**33 + 9
    inputs = make_inputs(traffic, seed, str(tmp_path))
    ancestor = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(seed).integers(0, 4, 250_000)]
    held = [np.bincount(s.src, minlength=250_000) for s in inputs.seqs]
    assert all(np.array_equal(h, held[0]) for h in held)
    values = np.flatnonzero(held[0] == 3)
    assert held[0].max() == 3 and 3 * 1000 <= values.size <= 3 * 2000
    breaks = np.flatnonzero(np.diff(values) > 1) + 1
    families = [(int(r[0]), r.size) for r in np.split(values, breaks)]
    assert len(families) == 3 and all(1000 <= ln <= 2000 for _, ln in families)
    for s in inputs.seqs:
        want = np.where(s.ori > 0, ancestor[s.src], COMP[ancestor[s.src]])
        in_family = held[0][s.src] == 3
        assert (s.seq[~in_family] == want[~in_family]).all()
        assert (s.seq[in_family] != want[in_family]).mean() < 0.01
    copies = _copies(inputs.seqs[0], families)
    one = [c for c in copies if c[0] == 0][:2]
    other = next(c for c in copies if c[0] == 1)
    assert len(one) == 2
    path = str(tmp_path / "blocks_coords.txt")
    _coords(path, inputs, [[(0, a, b) for _, a, b in one]])
    assert judge_blocks(path, inputs, 1)["nonhomologous_share"] == 0
    _coords(path, inputs, [[(0, a, b) for _, a, b in (one[0], other)]])
    assert judge_blocks(path, inputs, 1)["nonhomologous_share"] == 1.0


def test_a_strain_copy_is_its_familys_in_one_strain_alone():
    """One more copy a strain: one family's bases held four times there."""
    quiet = {"snp_rate": [0, 0], "indels": [0, 0]}
    plain = make_strains(2, 250_000, 17, 3, {**quiet, "repeats": REPEATS})
    three = np.bincount(plain[0].src, minlength=250_000) == 3
    moved = make_strains(2, 250_000, 17, 3, {
        **quiet, "repeats": {**REPEATS, "strain_copies": [1, 1]}})
    for m in moved:
        held = np.bincount(m.src, minlength=250_000)
        four = np.flatnonzero(held == 4)
        assert 1000 <= four.size <= 2000 and np.all(np.diff(four) == 1)
        assert three[four].all() and (held[~three] <= 1).all()


def test_the_mix_keys_set_the_snps_and_indels():
    """``MIX``'s values given as keys change nothing; a set SNP rate and
    indel length are what the strains hold (150 kbp: no inversion)."""
    given = make_strains(2, 250_000, 5, 8, {"snp_rate": [0.005, 0.0075],
                                            "indels": [20, 60],
                                            "indel_length": [1, 30]})
    for a, b in zip(make_strains(2, 250_000, 5, 8), given):
        assert np.array_equal(a.seq, b.seq) and np.array_equal(a.src, b.src)
    seed = 23
    ancestor = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(seed).integers(0, 4, 150_000)]
    for s in make_strains(2, 150_000, seed, 4, {"snp_rate": [0.02, 0.05],
                                                "indels": [0, 0]}):
        # a SNP draws the base it replaces one time in four
        assert 0.75 * 0.02 * 0.9 < (s.seq != ancestor).mean() < 0.75 * 0.05 * 1.1
    for s in make_strains(2, 150_000, seed, 4, {"snp_rate": [0, 0],
                                                "indels": [6, 6],
                                                "indel_length": [100, 120]}):
        inserted = np.flatnonzero(s.src < 0)
        runs = np.split(inserted, np.flatnonzero(np.diff(inserted) > 1) + 1)
        lost = 150_000 - (s.src >= 0).sum()
        assert all(100 <= r.size <= 120 for r in runs if r.size)
        assert sum(r.size for r in runs) + lost > 0
        assert lost % 1 == 0 and lost <= 6 * 120
