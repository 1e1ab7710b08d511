"""Variant calling between two genomes (C-Sibelia capability; port of
``sibelia_tpu/variants/caller.py`` on the port's device).

Against the JAX module one branch differs: a unique pair aligned by the fast
aligner (``SIBELIA_TPU_ALIGNER=fast``) with ``SIBELIA_TPU_DEVICE_ALIGN=1``
closes its small gaps through the port's ``GapBatcher`` on the run's device.
The exact LAGAN and mlagan engines (``align/lagan_exact.py``,
``align/mlagan_exact.py``) take the run's device where the JAX package asks
``device_dispatch()``: on a card ``_batch_align_unique`` sends every unique
pair through ``align_pairs_exact_batch`` (anchors by the device sweep, all
band DPs in one batched device call), on the CPU it fans the native aligner
over a thread pool for ``-p > 1``.  When the native LAGAN library is off
(``SIBELIA_TPU_NATIVE=0``), exact mode takes the anchored aligner, as the
JAX package's does.

Capability twin of the reference script (reference:
src/csibelia/C-Sibelia.py), built as array programs: the alignment
column diff is a vectorized run-length scan with the 30-bp context
hysteresis applied over runs (not per-column Python), coverage masks are
numpy arrays with run extraction by flat-index diffs, and the LAGAN
subprocess fan-out (C-Sibelia.py:279-292,349-361) is replaced by the
in-process anchored alignment engine (variants/aligner.py).

Behavioral contracts preserved for byte parity with the reference VCF
(semantics cited per function): unique-block classification
(C-Sibelia.py:314-323), the mismatch-segment hysteresis and VCF
anchor-base shift (:206-252), coverage-gap long indels / anchored
insertions / breakends (:374-427), and the py2 dict iteration order
where it decides output order.
"""
from __future__ import annotations

import collections
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..align import lagan_exact, mlagan_exact
from ..core.py2_dict import py2_dict_key_order
from ..io.fasta import reverse_complement
from .aligner import GapBatcher, align_multiple, align_pair

COVER = 1
UNCOVER = 0
LINE_LENGTH = 60
MINIMUM_CONTEXT_SIZE = 30
_GAP = ord("-")

FastaRecord = collections.namedtuple("FastaRecord", ["seq", "description", "id"])
SyntenyBlock = collections.namedtuple(
    "SyntenyBlock", ["seq", "chr_id", "strand", "id", "start", "end", "chr_num", "chr_size"])
AlignmentRecord = collections.namedtuple("AlignmentRecord", ["body", "block_instance"])


def parse_fasta_file(file_name: str) -> list[FastaRecord]:
    """Whole-header FASTA reader; id = first header token (the reference
    script keeps the full description, unlike the Sibelia binary's
    reader — C-Sibelia.py:98-116)."""
    records: list[FastaRecord] = []
    header: str | None = None
    chunks: list[str] = []

    def flush():
        if header is not None:
            records.append(FastaRecord(seq="".join(chunks), description=header,
                                       id=header.split()[0]))

    with open(file_name) as handle:
        for raw in handle:
            ln = raw.strip()
            if not ln:
                continue
            if ln.startswith(">"):
                flush()
                header, chunks = ln[1:].strip(), []
            elif header is not None:
                chunks.append(ln)
    flush()
    return records


def strip_chr_id(chr_id: str) -> str:
    """NCBI `gi|…|ref|ACC.V|` ids reduce to the bare accession."""
    fields = chr_id.split("|")
    if len(fields) == 5:
        return fields[3].split(".")[0]
    return chr_id


def _split_sections(path: str) -> list[list[str]]:
    """Split a blocks_coords file into dash-separated sections of
    non-empty stripped lines."""
    sections: list[list[str]] = [[]]
    with open(path) as handle:
        for raw in handle:
            ln = raw.strip()
            if not ln:
                continue
            if ln.startswith("-"):
                sections.append([])
            else:
                sections[-1].append(ln)
    return sections


def parse_blocks_coords(blocks_file: str, genome: list[FastaRecord]):
    """Parse one blocks_coords*.txt into {block_id: [SyntenyBlock]}.

    Layout (as written by io/writers.py and the reference alike): a
    chromosome table (Seq_id / Size / Description), then one section per
    block with a "Block #N" caption, a column-header row, and one row per
    instance. Instance coordinates are 1-based and strand-conventional:
    a '-' row has start > end, and its sequence is the reverse complement
    of genome[chr][end-1:start] (reference: C-Sibelia.py:43-82)."""
    sections = _split_sections(blocks_file)
    chr_desc: dict[int, str] = {}
    chr_size: dict[int, int] = {}
    for row in sections[0][1:]:
        num_s, size_s, desc = row.split()[:3]
        chr_desc[int(num_s)] = desc
        chr_size[int(num_s)] = int(size_s)

    blocks: dict[int, list[SyntenyBlock]] = {}
    for sec in sections[1:]:
        if not sec:
            continue
        block_id = int(sec[0].split("#")[1])
        instances: list[SyntenyBlock] = []
        for row in sec[2:]:
            num_s, strand, start_s, end_s = row.split()[:4]
            num, start, end = int(num_s), int(start_s), int(end_s)
            lo, hi = (start - 1, end) if strand == "+" else (end - 1, start)
            body = genome[num - 1].seq[lo:hi]
            if strand == "-":
                body = reverse_complement(body)
            instances.append(SyntenyBlock(
                seq=body, chr_id=chr_desc[num], strand=strand, id=block_id,
                start=start, end=end, chr_num=num, chr_size=chr_size[num]))
        blocks[block_id] = instances
    return blocks


def _dot(value, upper: bool = False):
    if value is None:
        return "."
    return value.upper() if upper else value


@dataclass
class Variant:
    """One called variant; '.'-normalized fields ready for VCF emission.

    Field meanings follow VCF 4.1 (reference_pos is the anchored POS;
    alleles are upper-cased; context fields carry the ±30bp flanks used
    by the debug dump)."""

    reference_chr_id: object
    reference_pos: object
    contig_id: object
    assembly_pos: object
    reference_allele: object
    assembly_allele: object
    reference_context: object
    assembly_context: object
    synteny_block_id: object

    def __post_init__(self):
        self.reference_chr_id = _dot(self.reference_chr_id)
        self.reference_pos = _dot(self.reference_pos)
        self.contig_id = str(self.contig_id)
        self.reference_allele = _dot(self.reference_allele, upper=True)
        self.assembly_allele = _dot(self.assembly_allele, upper=True)
        self.reference_context = _dot(self.reference_context, upper=True)
        self.assembly_context = _dot(self.assembly_context, upper=True)
        self.synteny_block_id = _dot(self.synteny_block_id)

    def __str__(self):
        return "\t".join([str(self.reference_pos), self.reference_allele,
                          self.assembly_allele, str(self.synteny_block_id),
                          self.contig_id, self.reference_context,
                          self.assembly_context])

    def get_vcf_record(self):
        return "\t".join([strip_chr_id(self.reference_chr_id),
                          str(self.reference_pos), ".", self.reference_allele,
                          self.assembly_allele, ".", ".", "."])


def no_gaps(sequence: str) -> str:
    return sequence.replace("-", "")


def _hysteresis_segments(match: np.ndarray) -> list[tuple[int, int, bool]]:
    """Run-length segments of the match mask with the reference's 30-bp
    hysteresis: an interior match run shorter than MINIMUM_CONTEXT_SIZE
    (and not anchored at column 0) is absorbed, fusing its two flanking
    mismatch runs into one segment; the final run is kept as-is
    (reference semantics: C-Sibelia.py:206-233).

    Returns (start, end, is_match) with half-open column ranges."""
    n = int(match.size)
    if n == 0:
        return []
    flips = np.flatnonzero(match[1:] != match[:-1]) + 1
    run_starts = np.concatenate([np.zeros(1, np.int64), flips])
    run_ends = np.concatenate([flips, np.full(1, n, np.int64)])

    segments: list[tuple[int, int, bool]] = []
    seg_start = 0
    n_runs = run_starts.size
    for r in range(n_runs):
        end = int(run_ends[r])
        is_match = bool(match[run_starts[r]])
        if r == n_runs - 1:
            segments.append((seg_start, end, is_match))
        elif not is_match:
            segments.append((seg_start, end, is_match))
            seg_start = end
        elif end - seg_start >= MINIMUM_CONTEXT_SIZE or seg_start == 0:
            segments.append((seg_start, end, is_match))
            seg_start = end
        elif segments:
            # absorb: resume accumulating from the previous (mismatch)
            # segment's start; the fused region lands in the next append
            seg_start = segments.pop()[0]
    return segments


def _flank(row: str, segment: tuple[int, int, bool], left: bool) -> str:
    """Context flank from a neighboring segment: its trailing (left=True)
    or leading columns, at most MINIMUM_CONTEXT_SIZE, raw (gaps kept)."""
    start, end, _ = segment
    span = min(end - start, MINIMUM_CONTEXT_SIZE)
    return row[end - span:end] if left else row[start:start + span]


def get_context(alignment, alignment_segment, segment_index):
    """±30-column context around a segment: raw flank columns from the
    neighboring segments plus the de-gapped segment body, per row."""
    segs = alignment_segment
    seg = segs[segment_index]
    left = _flank(alignment[0], segs[segment_index - 1], True) \
        if segment_index > 0 else ""
    right = _flank(alignment[0], segs[segment_index + 1], False) \
        if segment_index + 1 < len(segs) else ""
    start, end = seg[0], seg[1]
    return (left + no_gaps(alignment[0][start:end]) + right,
            left + no_gaps(alignment[1][start:end]) + right)


def parse_alignment(alignment, reference_chr_id, synteny_block_id, contig_id,
                    reference_start, reference_direction):
    """Diff two alignment rows into Variants (vectorized column scan).

    Per mismatch segment: POS anchors one reference base to the left
    (VCF convention) except for pure SNPs and segments starting at
    column 0; alleles are de-gapped segment bodies, reverse-complemented
    when the reference instance is on the '-' strand
    (semantics: C-Sibelia.py:206-252)."""
    row0, row1 = alignment[0], alignment[1]
    a0 = np.frombuffer(row0.encode(), np.uint8)
    a1 = np.frombuffer(row1.encode(), np.uint8)
    segments = _hysteresis_segments(a0 == a1)

    # reference coordinate entering each column: reference_start advanced
    # by one per preceding non-gap reference column (signed by direction)
    consumed = np.cumsum(a0 != _GAP) - (a0 != _GAP)
    ref_at = reference_start + reference_direction * consumed

    variants: list[Variant] = []
    for index, (start, end, is_match) in enumerate(segments):
        if is_match:
            continue
        is_snp = (end - start == 1
                  and a0[start] != _GAP and a1[start] != _GAP)
        shift = 0 if (start == 0 or is_snp) else 1
        ref_allele = no_gaps(row0[start - shift:end])
        asm_allele = no_gaps(row1[start - shift:end])
        if reference_direction == -1:
            ref_allele = reverse_complement(ref_allele)
            asm_allele = reverse_complement(asm_allele)
        ref_ctx, asm_ctx = get_context(alignment, segments, index)
        variants.append(Variant(reference_chr_id, int(ref_at[start]) - shift,
                                contig_id, None, ref_allele, asm_allele,
                                ref_ctx, asm_ctx, synteny_block_id))
    return variants


def get_size(record) -> int:
    return abs(record.end - record.start) + 1


def determine_unique_block(instance_list, reference_seq, min_block_size):
    """A block is a unique pair iff it has exactly two instances, one per
    genome, both at least min_block_size long; returns them ordered
    (reference instance, assembly instance) or (None, None)
    (semantics: C-Sibelia.py:314-323)."""
    if len(instance_list) != 2:
        return None, None
    ref_ids = reference_seq.keys()
    ref_inst = next((x for x in instance_list if x.chr_id in ref_ids), None)
    asm_inst = next((x for x in instance_list if x.chr_id not in ref_ids), None)
    if ref_inst is None or asm_inst is None:
        return None, None
    if min(get_size(ref_inst), get_size(asm_inst)) < min_block_size:
        return None, None
    return ref_inst, asm_inst


def process_block(block, prealigned, device: torch.device):
    """Align one block's instances and, for unique pairs, diff the rows
    into variants (reference: C-Sibelia.py:274-309, in-process aligners).

    Unique pairs default to the exact LAGAN engine (byte-identical to
    ``lagan.pl -mfa``; align/lagan_exact.py); `prealigned` carries rows
    from ``_batch_align_unique``.  SIBELIA_TPU_ALIGNER=fast selects the
    anchored-Gotoh engine instead, and with it SIBELIA_TPU_DEVICE_ALIGN=1
    closes the small gaps in batches on `device` (identical to the fast
    host path)."""
    unique, synteny_block_id, instance_list = block
    mode = os.environ.get("SIBELIA_TPU_ALIGNER", "exact")
    if unique:
        ref_inst, asm_inst = instance_list
        if prealigned is not None and synteny_block_id in prealigned:
            rows = list(prealigned[synteny_block_id])
        elif mode == "exact" and lagan_exact.available():
            # reference: C-Sibelia.py:283 builds these description headers
            name0 = ref_inst.chr_id + str(ref_inst.start) + "_" + str(ref_inst.end)
            name1 = asm_inst.chr_id + str(asm_inst.start) + "_" + str(asm_inst.end)
            rows = list(lagan_exact.align_pair_exact(
                ref_inst.seq, asm_inst.seq, name0, name1, device))
        elif os.environ.get("SIBELIA_TPU_DEVICE_ALIGN") == "1":
            rows = list(align_pair(ref_inst.seq, asm_inst.seq,
                                   batcher=GapBatcher(device)))
        else:
            rows = list(align_pair(ref_inst.seq, asm_inst.seq))
        alignment = [AlignmentRecord(body=body, block_instance=inst)
                     for body, inst in zip(rows, instance_list)]
        direction = +1 if ref_inst.strand == "+" else -1
        return parse_alignment(rows, ref_inst.chr_id, synteny_block_id,
                               asm_inst.chr_id, ref_inst.start,
                               direction), alignment
    if mode == "exact" and mlagan_exact.available():
        # exact mlagan port; alignment records keep the reference's
        # output order (the merge-tree order, C-Sibelia.py:295)
        names = [inst.chr_id + str(inst.start) + "_" + str(inst.end)
                 for inst in instance_list]
        by_name = dict(zip(names, instance_list))
        fasta = mlagan_exact.mlagan_fasta(
            [inst.seq.encode() if isinstance(inst.seq, str) else inst.seq
             for inst in instance_list], names, device)
        records = []
        cur_name, cur = None, []
        for line in fasta.split("\n"):
            if line.startswith(">"):
                if cur_name is not None:
                    records.append((cur_name, "".join(cur)))
                cur_name, cur = line[1:], []
            elif line:
                cur.append(line)
        if cur_name is not None:
            records.append((cur_name, "".join(cur)))
        return [], [AlignmentRecord(body=body, block_instance=by_name[nm])
                    for nm, body in records]
    rows = align_multiple([inst.seq for inst in instance_list])
    return [], [AlignmentRecord(body=body, block_instance=inst)
                for body, inst in zip(rows, instance_list)]


def _batch_align_unique(annotated_block, processes=1,
                        device: torch.device | None = None):
    """Pre-align unique pairs out of the sequential block loop: anchors
    (and, without a card, the whole pair) fan out over a thread pool (the
    in-process analogue of the reference's multiprocessing.Pool,
    C-Sibelia.py:349; the native engines release the GIL) and band DPs
    batch into one device call.  Returns {block_id: (row0, row1)},
    possibly partial; process_block falls back per pair.  Empty when
    there is nothing to gain (serial host run) or a non-exact aligner is
    chosen."""
    use_dev = lagan_exact.order_on_device(device)
    if os.environ.get("SIBELIA_TPU_ALIGNER", "exact") != "exact":
        return {}
    if not use_dev and processes <= 1:
        return {}
    if not lagan_exact.available():
        return {}
    ids, pairs = [], []
    for unique, sbid, instance_list in annotated_block:
        if not unique:
            continue
        ref_inst, asm_inst = instance_list
        name0 = ref_inst.chr_id + str(ref_inst.start) + "_" + str(ref_inst.end)
        name1 = asm_inst.chr_id + str(asm_inst.start) + "_" + str(asm_inst.end)
        ids.append(sbid)
        pairs.append((ref_inst.seq, asm_inst.seq, name0, name1))
    if not pairs:
        return {}
    if use_dev:
        rows = lagan_exact.align_pairs_exact_batch(pairs, processes, device)
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=processes) as pool:
            rows = list(pool.map(
                lambda p: lagan_exact.align_pair_exact(
                    p[0].encode() if isinstance(p[0], str) else p[0],
                    p[1].encode() if isinstance(p[1], str) else p[1],
                    p[2], p[3], device), pairs))
    return {sbid: r for sbid, r in zip(ids, rows) if r is not None}


def depict_coverage(block_seq, reference_seq, assembly_seq, base_cover):
    """Paint per-base coverage masks (one int array per sequence) with
    the ids of blocks present in both genomes; later stages overwrite
    earlier ones on the shared array (semantics: C-Sibelia.py:325-338)."""
    if base_cover is None:
        base_cover = {}
        for seq_group in (reference_seq, assembly_seq):
            for seq_id, seq in seq_group.items():
                base_cover[seq_id] = np.full(len(seq), UNCOVER, dtype=np.int64)
    for block_id, instance_list in block_seq.items():
        n_ref = sum(1 for inst in instance_list if inst.chr_id in reference_seq)
        if 0 < n_ref < len(instance_list):
            for instance in instance_list:
                lo = min(instance.start, instance.end) - 1
                hi = max(instance.start, instance.end)
                base_cover[instance.chr_id][lo:hi] = block_id
    return base_cover


def _uncovered_runs(cover: np.ndarray) -> list[tuple[int, int]]:
    """Half-open [start, end) runs where cover == UNCOVER."""
    bare = np.concatenate([np.zeros(1, np.int8),
                           (cover == UNCOVER).astype(np.int8),
                           np.zeros(1, np.int8)])
    step = np.diff(bare)
    return list(zip(np.flatnonzero(step == 1).tolist(),
                    np.flatnonzero(step == -1).tolist()))


def _assembly_gap_variant(seq_id, start, end, assembly_seq, reference_seq,
                          main_cover, block_seq, min_block_size):
    """An uncovered assembly span is an insertion. It anchors into the
    reference right after (strand-dependently) the nearest preceding
    unique block when one exists and the anchor base is in range;
    otherwise it is unplaced (semantics: C-Sibelia.py:382-408).
    Returns (variant, anchored)."""
    asm_allele = assembly_seq[seq_id][start:end]
    chr_id = None
    pos = None
    ref_allele = None
    if start > 0:
        left_block = int(main_cover[seq_id][start - 1])
        if left_block != UNCOVER:
            ref_inst, asm_inst = determine_unique_block(
                block_seq[left_block], reference_seq, min_block_size)
            if ref_inst is not None:
                if ref_inst.strand == asm_inst.strand:
                    pos = max(ref_inst.start, ref_inst.end)
                else:
                    pos = min(ref_inst.start, ref_inst.end) - 1
                if pos > 0:
                    anchor = reference_seq[ref_inst.chr_id][pos - 1]
                    ref_allele = anchor
                    asm_allele = anchor + asm_allele
                    chr_id = ref_inst.chr_id
                else:
                    pos = None
    v = Variant(chr_id, pos, seq_id, start, ref_allele, asm_allele,
                ref_allele, asm_allele, None)
    return v, pos is not None


def _reference_gap_variant(seq_id, start, end, reference_seq):
    """An uncovered reference span is a deletion, anchored one base left
    when possible (semantics: C-Sibelia.py:410-415)."""
    anchor = reference_seq[seq_id][start - 1] if start > 0 else ""
    ref_allele = anchor + reference_seq[seq_id][start:end]
    asm_allele = anchor if anchor else None
    return Variant(seq_id, start, None, None, ref_allele, asm_allele,
                   ref_allele, asm_allele, None)


def _coords_key(file_name):
    return int(file_name.split(".")[0][13:])


def call_variants(directory, genomes, reference_seq, assembly_seq,
                  min_block_size, device: torch.device, align=False,
                  processes=1):
    """Classify final-stage blocks, align and diff unique pairs, then
    turn spans uncovered across ALL stages into long indels / insertions
    (reference: C-Sibelia.py:343-427)."""
    coords_re = re.compile(r"blocks_coords[0-9]*\.txt")
    coords_files = sorted((f for f in os.listdir(directory)
                           if coords_re.match(f)), key=_coords_key)
    blocks_coords = [parse_blocks_coords(os.path.join(directory, f), genomes)
                     for f in coords_files]

    annotated_block = []
    for synteny_block_id, instance_list in blocks_coords[-1].items():
        unique = False
        ref_inst, asm_inst = determine_unique_block(
            instance_list, reference_seq, min_block_size)
        if ref_inst is not None:
            unique = True
            instance_list = [ref_inst, asm_inst]
        annotated_block.append((unique, synteny_block_id, instance_list))

    prealigned = _batch_align_unique(annotated_block, processes, device)
    variant: list[Variant] = []
    alignment: list[list[AlignmentRecord]] = []
    for block in annotated_block:
        v, a = process_block(block, prealigned, device)
        variant.extend(v)
        alignment.append(a)

    all_cover = None
    for stage in blocks_coords:
        all_cover = depict_coverage(stage, reference_seq, assembly_seq, all_cover)
    block_seq = blocks_coords[-1]
    main_cover = depict_coverage(block_seq, reference_seq, assembly_seq, None)

    insertion: list[Variant] = []
    # reference: C-Sibelia.py:380 iterates the py2 dict; the order decides
    # breakend numbering and equal-(chr,pos) stable-sort ties
    for seq_id in py2_dict_key_order(list(all_cover.keys())):
        in_reference = seq_id in reference_seq
        for start, end in _uncovered_runs(all_cover[seq_id]):
            if end - start <= min_block_size:
                continue
            if in_reference:
                variant.append(_reference_gap_variant(
                    seq_id, start, end, reference_seq))
            else:
                v, anchored = _assembly_gap_variant(
                    seq_id, start, end, assembly_seq, reference_seq,
                    main_cover, block_seq, min_block_size)
                (variant if anchored else insertion).append(v)

    return variant, insertion, alignment


# -- output writers ---------------------------------------------------------

def _write_wrapped(text, handle):
    for pos in range(0, len(text), LINE_LENGTH):
        handle.write(text[pos:pos + LINE_LENGTH] + "\n")


def write_vcf_header(reference, handle):
    """reference: C-Sibelia.py:433-440 (version string kept for parity)."""
    handle.write("##fileformat=VCFv4.1\n")
    handle.write("##source=C-Sibelia 3.0.5\n")
    handle.write("##reference=" + strip_chr_id(reference.id) + "\n")
    handle.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n')
    handle.write('##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">\n')
    handle.write('##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS for imprecise variants">\n')
    handle.write("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                            "FILTER", "INFO"]) + "\n")


def write_variants_vcf(variant_list, handle):
    for v in variant_list:
        handle.write(v.get_vcf_record() + "\n")


def write_insertions_vcf(variant_list, reference_organism, handle):
    """reference: C-Sibelia.py:446-463 (breakend records)."""
    ref_len = str(len(reference_organism.seq))
    reference_chr = strip_chr_id(reference_organism.id)
    for index, v in enumerate(variant_list):
        ref_pos = "1"
        ref_allele = reference_organism.seq[0]
        contig = v.contig_id
        assembly_start = v.assembly_pos + 1
        assembly_end = assembly_start + len(v.assembly_allele)
        start_alt = ref_allele + "[" + contig + ":" + str(assembly_start) + "["
        end_alt = "]" + contig + ":" + str(assembly_end) + "]" + ref_allele
        info = ";".join(("IMPRECISE", "SVTYPE=BND", "CIPOS=0," + ref_len))
        for bnd, alt in ((f"bnd_{index * 2}", start_alt),
                         (f"bnd_{index * 2 + 1}", end_alt)):
            handle.write("\t".join([reference_chr, ref_pos, bnd, ref_allele,
                                    alt, ".", ".", info]) + "\n")


def write_alignments_maf(alignment_list, handle):
    """reference: C-Sibelia.py:473-484."""
    handle.write("##maf version=1\n\n")
    for group in alignment_list:
        handle.write("a\n")
        for alignment in group:
            block = alignment.block_instance
            start = min(block.start, block.end) - 1
            end = max(block.start, block.end)
            if block.strand != "+":
                start = block.chr_size - end
            handle.write(f"s {block.chr_id} {start} "
                         f"{abs(block.end - block.start) + 1} {block.strand} "
                         f"{block.chr_size} {alignment.body}\n")
        handle.write("\n")


def write_alignments_xmfa(alignment_list, handle):
    """reference: C-Sibelia.py:465-471."""
    for group in alignment_list:
        for alignment in group:
            block = alignment.block_instance
            handle.write(">%i:%i-%i %s %s\n" % (block.chr_num, block.start,
                                                block.end, block.strand,
                                                block.chr_id))
            _write_wrapped(alignment.body, handle)
        handle.write("=\n")


def write_insertions_text(variant_list, handle):
    handle.write("\t".join(["SEQ_ID", "POS", "FRAGMENT"]) + "\n")
    for v in variant_list:
        handle.write("\t".join([v.contig_id, str(v.assembly_pos + 1),
                                v.assembly_allele]) + "\n")


def write_insertions_fasta(variant_list, file_name):
    with open(file_name, "w") as handle:
        for v in variant_list:
            start = str(v.assembly_pos + 1)
            end = str(v.assembly_pos + len(v.assembly_allele))
            description = ('Seq="' + v.contig_id + '",Start=' + start
                           + '",End=' + end)
            handle.write(">" + description + "\n")
            _write_wrapped(v.assembly_allele, handle)


def variant_key(v: Variant):
    return (v.reference_chr_id, v.reference_pos)
