"""The generator: the same seed gives the same genomes, the bases are
chip_smoke's, and the provenance follows every mutation."""
import numpy as np

from portbench.genomes import COMP, contig_cuts, make_inputs, make_strains


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
