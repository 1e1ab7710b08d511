"""The port's own copies of the host modules against the originals.

``sibelia_tpu_torch`` imports nothing of ``sibelia_tpu``: it carries its
own copy of every host module and native source it runs.  Each case feeds
the same seeded numpy input to a copy and to its original and asks for
equal output; the native cases hold the port's libraries (built from
``sibelia_tpu_torch/native/*.cpp`` into ``sibelia_tpu_torch/native/build/``)
to the JAX package's.  Exact equality throughout."""
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import sibelia_tpu as J
import sibelia_tpu.align.anchors_device
import sibelia_tpu.align.glocal
import sibelia_tpu.align.lagan_exact
import sibelia_tpu.align.mlagan_exact
import sibelia_tpu.align.seqan_local
import sibelia_tpu.align.supermap
import sibelia_tpu.align.toolkit
import sibelia_tpu.blocks.boundaries
import sibelia_tpu.blocks.edges
import sibelia_tpu.blocks.postprocess
import sibelia_tpu.cli.annotate
import sibelia_tpu.cli.circos_tools
import sibelia_tpu.core.boost_unordered
import sibelia_tpu.core.config
import sibelia_tpu.core.glibc_rand
import sibelia_tpu.core.progress
import sibelia_tpu.core.py2_dict
import sibelia_tpu.core.stdsort
import sibelia_tpu.core.timings
import sibelia_tpu.graph.indexed
import sibelia_tpu.io.writers
import sibelia_tpu.kernels.order_device
import sibelia_tpu.native
import sibelia_tpu.variants.aligner
import sibelia_tpu.variants.caller
import sibelia_tpu_torch as P
import sibelia_tpu_torch.align.anchors_device
import sibelia_tpu_torch.align.glocal
import sibelia_tpu_torch.align.lagan_exact
import sibelia_tpu_torch.align.mlagan_exact
import sibelia_tpu_torch.align.seqan_local
import sibelia_tpu_torch.align.supermap
import sibelia_tpu_torch.align.toolkit
import sibelia_tpu_torch.blocks.boundaries
import sibelia_tpu_torch.blocks.edges
import sibelia_tpu_torch.blocks.postprocess
import sibelia_tpu_torch.cli.annotate
import sibelia_tpu_torch.cli.circos_tools
import sibelia_tpu_torch.core.boost_unordered
import sibelia_tpu_torch.core.config
import sibelia_tpu_torch.core.glibc_rand
import sibelia_tpu_torch.core.progress
import sibelia_tpu_torch.core.py2_dict
import sibelia_tpu_torch.core.stdsort
import sibelia_tpu_torch.core.timings
import sibelia_tpu_torch.graph.indexed
import sibelia_tpu_torch.io.writers
import sibelia_tpu_torch.kernels.order_device
import sibelia_tpu_torch.native.engine_runner
import sibelia_tpu_torch.variants.aligner
import sibelia_tpu_torch.variants.caller

SEED = 4


def _dna(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]


def _strains(rng, size=6000, n_strains=3, n_mut=40):
    base = _dna(rng, size)
    out = [base]
    for _ in range(n_strains - 1):
        s = base.copy()
        hit = rng.integers(0, size, n_mut)
        s[hit] = _dna(rng, n_mut)
        at = int(rng.integers(size // 4, size // 2))
        out.append(np.concatenate([s[:at], _dna(rng, 9), s[at:]]))
    return out


def glibc_rand(pkg, rng, tmp_path):
    r = pkg.core.glibc_rand.GlibcRand(int(rng.integers(1, 1 << 30)))
    return [r.rand() for _ in range(2000)]


def stdsort(pkg, rng, tmp_path):
    # many ties under the comparison: introsort's order of equals shows
    items = [(int(a), i) for i, a in enumerate(rng.integers(0, 40, 700))]
    less = lambda a, b: a[0] < b[0]
    groups = pkg.core.stdsort.group_by(items, less)
    return items, groups


def boost_unordered(pkg, rng, tmp_path):
    m = pkg.core.boost_unordered.Boost154Map()
    fresh = [m.insert(int(key), i)
             for i, key in enumerate(rng.integers(0, 5000, 3000))]
    return fresh, list(m.items()), m.find(int(rng.integers(0, 5000)))


def py2_dict(pkg, rng, tmp_path):
    keys = ["".join(chr(c) for c in rng.integers(97, 123, rng.integers(1, 12)))
            for _ in range(500)]
    return (pkg.core.py2_dict.py2_dict_key_order(keys),
            [pkg.core.py2_dict.py2_str_hash(k) for k in keys[:50]])


def config(pkg, rng, tmp_path):
    path = tmp_path / "stages.txt"
    path.write_text("3\n10 60\n20 200\n100 1000\n")
    cfg = pkg.core.config
    return (cfg.PRESETS, cfg.MAX_INPUT_SIZE, cfg.read_stage_file(str(path)))


def progress(pkg, rng, tmp_path):
    out = io.StringIO()
    bar = pkg.core.progress.make_progress_bar(out)
    for state, steps in ((0, [0]), (1, [3, 10, 10, 37, 50]), (2, [50])):
        for step in steps:
            bar(step, state)
    return out.getvalue()


def timings(pkg, rng, tmp_path):
    t = pkg.core.timings
    t.reset()
    t.add("a", 1.5)
    t.add("a", 0.25)
    t.add("b", 2.0)
    snap = t.snapshot()
    t.reset()
    return snap, t.snapshot()


def fasta(pkg, rng, tmp_path):
    fa = pkg.io.fasta
    path = str(tmp_path / "round.fasta")
    seqs = [bytes(_dna(rng, n)).decode() for n in (150, 81, 1)]
    seqs[0] = seqs[0][:70] + "nNryk" + seqs[0][70:].lower()
    with open(path, "w") as h:
        for i, s in enumerate(seqs):
            h.write(f">gi|{i}|ref|X{i}.1| strain {i}\n")
            h.write("\n".join(s[j:j + 60] for j in range(0, len(s), 60)) + "\n")
    records = fa.read_fasta(path)
    again = str(tmp_path / "again.fasta")
    fa.write_fasta(again, records[0].description, records[0].sequence)
    with open(again) as h:
        written = h.read()
    return ([(r.id, r.description, r.sequence, r.conventional_id,
              r.striped_id()) for r in records], written,
            fa.reverse_complement(seqs[0]))


def _index(pkg, chroms, k):
    """(seq, store) at k, through the package's host enumeration."""
    seq = pkg.graph.sequence.MutableSequence([c.copy() for c in chroms])
    if pkg is P:
        enum = P.index.enumeration.enumerate_bifurcations_host(seq.chars, k)
    else:
        enum = J.index.enumeration.enumerate_bifurcations(seq.chars, k)
    return seq, pkg.graph.indexed.store_from_enum(seq, enum), enum


def bifstore(pkg, rng, tmp_path):
    seq, store, enum = _index(pkg, _strains(rng), 12)
    at = [[a.tolist() for a in strand] for strand in store.bif_at]
    positions = [store.list_positions(b) for b in range(enum.count)]
    counts = [store.count_bifurcations(b) for b in range(enum.count)]
    store.apply_splice(0, 100, 140, 7)
    seq.splice(0, 100, 140, _dna(np.random.default_rng(1), 7))
    store.cleanup()
    after = [[a.tolist() for a in strand] for strand in store.bif_at]
    return (enum.count, at, positions, counts, after, store.n_nodes,
            seq.to_strings(), seq.spell(1, 0, 5, 30),
            [seq.origpos_at(0, p) for p in (0, 99, 100, 120)])


def list_edges(pkg, rng, tmp_path):
    seq, store, _ = _index(pkg, _strains(rng), 12)
    edges = pkg.blocks.edges.list_edges(seq, store, 12)
    return [dataclasses.astuple(e) for e in edges]


def native_engine_sweep(pkg, rng, tmp_path):
    """One simplification stage in each package's own engine library (the
    port's with its re-prefilter on the CPU, the JAX package's with its host
    prefilter): bulge count and the simplified chromosomes."""
    chroms = _strains(rng, size=20000, n_mut=150)
    seq, _, enum = _index(pkg, chroms, 11)
    if pkg is P:
        bulges = P.native.engine_runner.simplify(seq, enum, 11, 80, 4,
                                                 torch.device("cpu"))
    else:
        bulges = J.native.simplify_native(seq, enum, 11, 80, 4)
    assert bulges is not None and bulges > 0
    return bulges, seq.to_strings()


def native_ranking_enumeration(pkg, rng, tmp_path):
    """ranking.cpp's enumeration of one supergenome of more than 2^16 rows,
    at a k that packs into one key and at one that does not."""
    chroms = _strains(rng, size=12000, n_mut=100)
    codes, starts = pkg.index.enumeration.build_supergenome(chroms)
    assert codes.size >= 1 << 16
    out = []
    for k in (15, 100):
        count, strands = pkg.native.enumerate_native(codes, starts,
                                                     len(chroms), k)
        assert count > 0
        out.append((count, [[a.tolist() for a in s] for s in strands]))
    rank, order = pkg.native.kmer_ranks_native(codes, 40)
    return out, codes.tolist(), starts.tolist(), rank.tolist(), order.tolist()


def _pair(rng, n=900):
    a = _dna(rng, n)
    b = a.copy()
    hit = rng.integers(0, n, 25)
    b[hit] = _dna(rng, 25)
    b = np.concatenate([b[:300], _dna(rng, 14), b[300:600], b[640:]])
    return a.tobytes(), b.tobytes()


def lagan_exact(pkg, rng, tmp_path):
    a, b = _pair(rng)
    return pkg.align.lagan_exact.align_pair_exact(a, b)


def mlagan_exact(pkg, rng, tmp_path):
    a, b = _pair(rng, 600)
    c = a[:200] + a[230:]
    return pkg.align.mlagan_exact.align_multiple_exact(
        [a, b, c], ["s1", "s2", "s3"])


def seqan_local(pkg, rng, tmp_path):
    a, b = _pair(rng, 160)
    return pkg.align.seqan_local.seqan_local_alignment(a[20:140], b[:150])


def _blocks(pkg, rng):
    """Three chromosomes and a block list with neighbours to glue."""
    records = [pkg.io.fasta.FASTARecord(
        bytes(_dna(rng, 3000)).decode(), f"chr{i}", i) for i in range(3)]
    blocks = []
    for c, rec in enumerate(records):
        for b, (lo, hi) in enumerate(((100, 400), (430, 800), (900, 1500),
                                      (1600, 2100))):
            sign = -1 if (c == 1 and b >= 2) else 1
            blocks.append(pkg.blocks.instance.BlockInstance(
                sign * (b + 1), rec, lo + 3 * c, hi + 3 * c))
    return records, blocks


def _plain(blocks):
    return [(b.signed_id, b.chr.id, b.start, b.end) for b in blocks]


def postprocess(pkg, rng, tmp_path):
    records, blocks = _blocks(pkg, rng)
    return _plain(pkg.blocks.postprocess.glue_stripes(blocks, records))


def boundaries(pkg, rng, tmp_path):
    records, blocks = _blocks(pkg, rng)
    blocks = [b for b in blocks if b.chr.id < 2]
    pkg.blocks.boundaries.improve_block_boundaries(blocks, {0}, 50)
    return _plain(blocks)


def writers(pkg, rng, tmp_path):
    records, blocks = _blocks(pkg, rng)
    w = pkg.io.writers
    out = []
    for fn in (w.list_blocks_indices, w.generate_report,
               w.list_chromosomes_as_permutations, w.list_blocks_indices_gff,
               w.list_blocks_sequences):
        path = str(tmp_path / fn.__name__)
        fn(blocks, records, path)
        with open(path) as h:
            out.append(h.read())
    return out


def aligner(pkg, rng, tmp_path):
    """The host Gotoh, and the anchored aligner on a pair large enough to
    anchor (fast mode, gaps closed on the host)."""
    al = pkg.variants.aligner
    a, b = _pair(rng, 1500)
    return (al._gotoh(a[:90], b[:95]), al.align_pair(a, b),
            al.align_multiple([a[:300], b[:310], a[5:280]]),
            (al.GAP_OPEN, al.GAP_EXTEND, al.DEVICE_BATCH_T, al._MAX_DP_AREA))


def caller(pkg, rng, tmp_path):
    """Variants read off two aligned rows, on either strand, and their VCF
    and MAF text."""
    ca = pkg.variants.caller
    a, b = _pair(rng, 500)
    rows = pkg.variants.aligner.align_pair(a, b)
    out = io.StringIO()
    variants = []
    for direction, start in ((1, 1000), (-1, 4000)):
        variants += ca.parse_alignment(rows, "gi|1|ref|NC_1.1|", 7, "ctg1",
                                       start, direction)
    ca.write_variants_vcf(sorted(variants, key=ca.variant_key), out)
    # the XMFA writer has no CLI flag in either package: one alignment of
    # two groups, a block on each strand, bodies over the 80-column wrap
    groups = []
    for sbid, strand, body in ((7, "+", rows), (8, "-", rows[::-1])):
        groups.append([ca.AlignmentRecord(row, ca.SyntenyBlock(
            row.replace("-", ""), f"chr{n}", strand, sbid, 100 + n,
            99 + n + len(row.replace("-", "")), n + 1, 9000))
            for n, row in enumerate(body)])
    xmfa = io.StringIO()
    ca.write_alignments_xmfa(groups, xmfa)
    assert xmfa.getvalue().count("=\n") == 2 and len(rows[0]) > 80
    return [str(v) for v in variants], out.getvalue(), xmfa.getvalue()


def anchors_host_half(pkg, rng, tmp_path):
    """The parsers of align/anchors_device.py, and the order of the events
    its sweep is handed (tie-heavy hits: runs of equal end events)."""
    mod = pkg.align.anchors_device
    lines = ["seq1 %d %d; seq2 %d %d; score = %.1f (+)"
             % (a, a + 20, b, b + 20, 10.0 * sc)
             for a, b, sc in zip(rng.integers(0, 20, 60) * 25,
                                 rng.integers(0, 20, 60) * 25,
                                 rng.integers(1, 4, 60))]
    lines += ["10 12 20 55", " 7 8 9", "x 1 2; 3 4; score=1e2", "",
              "a 5 9 ; b 1 2 3 ; score = -.5 (-)", "1 2; 3 4; scor=1"]
    scan = mod._Scan(" -12 +7x 3.5e1 .e")
    scanned = [scan.int_(), scan.int_(), scan.lit("x"), scan.float_(),
               scan.float_(), scan.i]
    events = []

    def record(*args):
        ev_h, ev_st = ((args[0][0][3], args[0][0][4]) if pkg is P
                       else (args[3], args[4]))
        events.append((ev_h.tolist(), ev_st.tolist()))
        n = len(ev_h) // 2
        out = (np.zeros(n, np.float32), np.full(n, -1, np.int32), 0, -2.0)
        return [out] if pkg is P else out

    name = "sweep" if pkg is P else "_sweep_device"
    real = getattr(mod, name)
    setattr(mod, name, record)
    try:
        text = mod.anchors_text_device("\n".join(lines))
    finally:
        setattr(mod, name, real)
    return ([mod._rolltonum(ln) for ln in lines],
            [mod._parse_hit(ln) for ln in lines],
            [mod._parse_chunk(ln) for ln in lines], scanned, events, text)


def order_prepare_job(pkg, rng, tmp_path):
    """kernels/order_device.py::_prepare_job: the per-diagonal params, the
    init rows and the codes of a pair with an indel and a contig break."""
    mod = pkg.kernels.order_device
    a, b = _pair(rng, 700)
    a = a[:200] + b"." + a[200:500] + b"N" * 9 + a[500:]
    anchors = pkg.align.lagan_exact.rechaos(a, "x", b, "y")
    lib = pkg.native.load_lagan()
    job = mod._prepare_job(lib, a, b, anchors, 8192)
    lib.le_order_release(job.handle)
    rows = job.nd - 1
    return (job.nd, job.wmax, np.asarray(job.params)[:rows].tolist(),
            [np.asarray(r).tolist() for r in job.init],
            np.asarray(job.s1c).tolist(), np.asarray(job.s2c).tolist(),
            mod._SM.tolist(), mod._CODE.tolist(),
            (mod.GAP_START, mod.GAP_CONT, int(mod.DUMMY),
             mod._ROWS_BUDGET_BYTES, mod._bucket(5000, 4096)))


def _aligned_rows(rng, n):
    a = _dna(rng, n)
    b = a.copy()
    b[rng.integers(0, n, n // 10)] = _dna(rng, n // 10)
    gaps = rng.random(n) < 0.05
    return (bytes(np.where(gaps, ord("-"), a)).decode(),
            bytes(np.where(rng.random(n) < 0.05, ord("-"), b)).decode())


def toolkit(pkg, rng, tmp_path):
    """Every LAGAN util twin once (tests/test_torch_toolkit.py holds each
    on more inputs)."""
    tk = pkg.align.toolkit
    r0, r1 = _aligned_rows(rng, 700)
    mfa = ">one\n%s\n>two\n%s\n" % (r0, r1)
    fa = ">s\n%s\n" % bytes(_dna(rng, 300)).decode()
    anchors = "(10 200)=(15 205) 33.5\n(300 420)=(310 430) 12.0\n"
    table, used = tk.score_contigs([(r0, r1)], [0], 700)
    return (tk.reverse_complement_fasta(fa), tk.get_length(fa),
            tk.get_bounds(anchors, 700, 700), tk.score_alignment([r0, r1]),
            table, used, tk.contig_order(table), tk.seq_merge([fa, fa]),
            tk.get_overlap(anchors), tk.get_contig_pos(mfa, 100),
            tk.cextract(mfa, 20, 400, 0, 1), tk.cstat(mfa, 70, 50),
            tk.glue(">0:1-700 + (a)\n%s\n>1:1-600 + (b)\n%s\n=\n"
                    % (r0, r1)))


def _chaos_hits(rng, names=("sA", "cX"), n=40):
    lines = []
    for _ in range(n):
        s1, s2 = (int(x) for x in rng.integers(1, 90_000, 2))
        ln = int(rng.integers(100, 2000))
        strand = "+" if rng.random() < 0.7 else "-"
        b2, e2 = (s2, s2 + ln) if strand == "+" else (s2 + ln, s2)
        lines.append(f"{names[0]} {s1} {s1 + ln}; {names[1]} {b2} {e2}; "
                     f"score = {float(rng.integers(2000, 60000)):.1f} "
                     f"({strand})")
    return "\n".join(lines) + "\n"


def glocal_chain(pkg, rng, tmp_path):
    return pkg.align.glocal.glocal_chain(_chaos_hits(rng))


def supermap(pkg, rng, tmp_path):
    return pkg.align.supermap.supermap(_chaos_hits(rng), {"sA": 100_000},
                                       {"cX": 100_000})


def annotate(pkg, rng, tmp_path):
    vcf, genomes = tmp_path / "variant.vcf", tmp_path / "genomes.txt"
    genomes.write_text("data/CP000046/genes.gbk\n"
                       "data/Staphylococcus_aureus_COL/NC_002951.val\n")
    out = []
    for ref in ("gi|57865352|ref|NC_002951.2|", "gi|1|ref|NC_999999.1|"):
        vcf.write_text(f"##fileformat=VCFv4.1\n##reference={ref}\n")
        out.append(pkg.cli.annotate.derive_db_name(str(vcf), str(genomes)))
    return out


def circos_tools(pkg, rng, tmp_path):
    """hide_mapped_contigs and sort_sequences (no Perl) on
    tests/test_aux.py's circos inputs."""
    (tmp_path / "genomes_permutations.txt").write_text(
        ">ref_chr\n1 2 3 $\n>contig_mapped\n2 3 $\n>contig_novel\n-3 1 $\n")
    circos = tmp_path / "circos"
    circos.mkdir()
    (circos / "circos.conf").write_text("karyotype = circos.sequences.txt\n")
    (circos / "circos.segdup.txt").write_text("")
    (circos / "circos.sequences.txt").write_text(
        "chr - seq1 ref_chr 0 20 chr1\nchr - seq2 contig_mapped 0 10 chr2\n"
        "chr - seq3 contig_novel 0 10 chr3\n")
    (tmp_path / "ref.fasta").write_text(">ref_chr\nACGT\n")
    ct = pkg.cli.circos_tools
    rcs = [ct.hide_mapped_contigs([str(tmp_path),
                                   str(tmp_path / "ref.fasta")]),
           ct.sort_sequences([str(tmp_path), str(tmp_path / "missing")])]
    return rcs, {f: (circos / f).read_text()
                 for f in sorted(os.listdir(circos))}


CASES = [glibc_rand, stdsort, boost_unordered, py2_dict, config, progress,
         timings, fasta, bifstore, list_edges, native_engine_sweep,
         native_ranking_enumeration, lagan_exact, mlagan_exact, seqan_local,
         postprocess, boundaries, writers, aligner, caller,
         anchors_host_half, order_prepare_job, toolkit, glocal_chain,
         supermap, annotate, circos_tools]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_copy_equals_original(case, tmp_path, monkeypatch):
    # the JAX package on its host paths, whatever the caller's environment
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "0")
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
    for pkg in (J, P):
        (tmp_path / pkg.__name__).mkdir()
    want = case(J, np.random.default_rng(SEED), tmp_path / J.__name__)
    got = case(P, np.random.default_rng(SEED), tmp_path / P.__name__)
    assert repr(got) == repr(want)


def test_the_port_builds_its_own_native_libraries():
    port_dir = os.path.join(os.path.dirname(P.__file__), "native")
    for lib in (P.native.load(), P.native.load_ranking(),
                P.native.load_lagan()):
        assert os.path.dirname(lib._name) == os.path.join(port_dir, "build")
    # every source the JAX package's three libraries are built from
    for name in ("engine.cpp", "ranking.cpp", "lagan_api.cpp",
                 "lagan_chaos.cpp", "lagan_anchors.cpp", "lagan_order.cpp",
                 "lagan_multial.cpp", "lagan_common.h", "lagan_stages.h"):
        assert os.path.getsize(os.path.join(port_dir, name)) > 0, name


@pytest.mark.parametrize("gfc", [False, True])
@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chaos_translated_equals_jax(seed, both, gfc):
    """native.lagan_chaos_translated (the reference's `chaos -t`, with -b
    and -gfc) on tests/test_lagan_exact.py's codon-structured pairs (seed
    1's pair gives no hit in either package)."""
    from tests.test_lagan_exact import _translated_pair
    sa, sb = _translated_pair(seed)
    want = J.native.lagan_chaos_translated(sa, "seqA", sb, "seqB",
                                           both=both, gfc=gfc)
    got = P.native.lagan_chaos_translated(sa, "seqA", sb, "seqB",
                                          both=both, gfc=gfc)
    assert want is not None and got == want
    assert bool(want) == (seed != 1)
