"""Output writers: blocks_coords, coverage report, permutations, GFF,
sequences, SAM, d3, circos.

Byte-parity targets (reference: src/outputgenerator.cpp): the textual
reports reproduce the reference's formatting exactly, including its
unstable-sort row orders (via core/stdsort.py) and C++ iostream float
formatting. The d3/circos visual outputs carry the same data but use our
own templates (the reference embeds third-party resource blobs,
src/resource.cpp, which we do not copy).
"""
from __future__ import annotations

import math
import os

from ..core.stdsort import group_by, std_sort
from ..io.fasta import FASTARecord, reverse_complement
from ..blocks.instance import BlockInstance
from .. import VERSION

DELIMITER = "-" * 80


def _cmp_by_id(a: BlockInstance, b: BlockInstance) -> bool:
    return a.block_id < b.block_id


def _cmp_by_chr(a: BlockInstance, b: BlockInstance) -> bool:
    return a.chr_id < b.chr_id


def _cmp_by_start(a: BlockInstance, b: BlockInstance) -> bool:
    return a.start < b.start


def _list_chrs(out, chr_list: list[FASTARecord]) -> None:
    out.write("Seq_id\tSize\tDescription\n")
    for i, r in enumerate(chr_list):
        out.write(f"{i + 1}\t{len(r.sequence)}\t{r.description}\n")
    out.write(DELIMITER + "\n")


def list_blocks_indices(blocks: list[BlockInstance], chr_list: list[FASTARecord],
                        file_name: str) -> None:
    """blocks_coords.txt (reference: outputgenerator.cpp:236-242, 54-69)."""
    with open(file_name, "w") as out:
        _list_chrs(out, chr_list)
        block_list = list(blocks)
        groups = group_by(block_list, _cmp_by_id)
        for g0, g1 in groups:
            seg = block_list[g0:g1]
            std_sort(seg, _cmp_by_chr)
            block_list[g0:g1] = seg
            out.write(f"Block #{block_list[g0].block_id}\n")
            out.write("Seq_id\tStrand\tStart\tEnd\tLength\n")
            for b in block_list[g0:g1]:
                strand = "-" if b.signed_id < 0 else "+"
                out.write(f"{b.chr.conventional_id}\t{strand}\t"
                          f"{b.conventional_start}\t{b.conventional_end}\t"
                          f"{b.end - b.start}\n")
            out.write(DELIMITER + "\n")


def _calculate_coverage(chr_list, grouped, start, end):
    """reference: outputgenerator.cpp:115-143."""
    import numpy as np
    ret = []
    total_bp = 0.0
    total_covered = 0.0
    for c, rec in enumerate(chr_list):
        size = len(rec.sequence)
        total_bp += size
        cover = np.zeros(size, dtype=np.int8)
        for gi in range(start, end):
            for b in grouped[gi][1]:
                if b.chr_id == c:
                    cover[b.start:b.end] = 1
        covered = float(np.count_nonzero(cover))
        ret.append(covered / size * 100)
        total_covered += covered
    ret.insert(0, total_covered / total_bp * 100)
    return ret


def generate_report(blocks: list[BlockInstance], chr_list: list[FASTARecord],
                    file_name: str) -> None:
    """coverage_report.txt (reference: outputgenerator.cpp:162-205)."""
    with open(file_name, "w") as out:
        block_list = list(blocks)
        groups = group_by(block_list, _cmp_by_id)
        sep_block = [(g1 - g0, block_list[g0:g1]) for g0, g1 in groups]

        _list_chrs(out, chr_list)
        out.write("Degree\tCount\tTotal")
        for i in range(len(chr_list)):
            out.write(f"\tSeq {i + 1}")
        out.write("\n")
        groups2 = group_by(sep_block, lambda a, b: a[0] < b[0])
        groups2.append((0, len(sep_block)))
        for gi, (g0, g1) in enumerate(groups2):
            if gi != len(groups2) - 1:
                out.write(f"{sep_block[g0][0]}\t{g1 - g0}\t")
            else:
                out.write(f"All\t{g1 - g0}\t")
            coverage = _calculate_coverage(chr_list, sep_block, g0, g1)
            for val in coverage:
                out.write(f"{val:.2f}%\t")
            out.write("\n")
        out.write(DELIMITER + "\n")


def list_chromosomes_as_permutations(blocks: list[BlockInstance],
                                     chr_list: list[FASTARecord],
                                     file_name: str) -> None:
    """genomes_permutations.txt (reference: outputgenerator.cpp:207-224)."""
    with open(file_name, "w") as out:
        block_list = list(blocks)
        groups = group_by(block_list, _cmp_by_chr)
        for g0, g1 in groups:
            chr_id = block_list[g0].chr_id
            out.write(f">{chr_list[chr_id].description}\n")
            seg = block_list[g0:g1]
            std_sort(seg, lambda a, b: (a.chr_id, a.start) < (b.chr_id, b.start))
            for b in seg:
                out.write(f"{b.signed_id:+d} ")
            out.write("$\n")


def list_blocks_indices_gff(blocks: list[BlockInstance],
                            chr_list: list[FASTARecord],
                            file_name: str) -> None:
    """blocks_coords.gff (reference: outputgenerator.cpp:598-631)."""
    with open(file_name, "w") as out:
        block_list = list(blocks)
        std_sort(block_list, _cmp_by_id)
        out.write("##gff-version 2\n")
        out.write(f"##source-version Sibelia {VERSION}\n")
        out.write("##Type DNA\n")
        for b in block_list:
            start = min(b.conventional_start, b.conventional_end)
            end = max(b.conventional_start, b.conventional_end)
            strand = "+" if b.signed_id > 0 else "-"
            row = [b.chr.striped_id(), "Sibelia", "synteny_block_copy",
                   str(start), str(end), ".", strand, ".", str(b.block_id)]
            out.write("\t".join(row) + "\n")


def list_blocks_sequences(blocks: list[BlockInstance],
                          chr_list: list[FASTARecord],
                          file_name: str) -> None:
    """blocks_sequences.fasta (reference: outputgenerator.cpp:287-318)."""
    with open(file_name, "w") as out:
        block_list = list(blocks)
        groups = group_by(block_list, _cmp_by_id)
        for g0, g1 in groups:
            for b in block_list[g0:g1]:
                strand = "+" if b.signed_id > 0 else "-"
                out.write(f">Seq=\"{b.chr.description}\",Strand='{strand}',"
                          f"Block_id={b.block_id},Start={b.conventional_start},"
                          f"End={b.conventional_end}\n")
                seq = b.chr.sequence[b.start:b.end]
                if b.signed_id <= 0:
                    seq = reverse_complement(seq)
                for i in range(0, len(seq), 80):
                    out.write(seq[i:i + 80])
                    if i + 80 < len(seq):
                        out.write("\n")
                out.write("\n")


def output_blocks_in_sam(blocks: list[BlockInstance],
                         chr_list: list[FASTARecord],
                         file_name: str) -> None:
    """SAM output (reference: outputgenerator.cpp:633-678)."""
    with open(file_name, "w") as out:
        out.write("@HD\tVN:1.4\n")
        for r in chr_list:
            out.write(f"@SQ\tSN:{r.description}\tLN:{len(r.sequence)}\n")
        block_list = list(blocks)
        groups = group_by(block_list, _cmp_by_id)
        for g0, g1 in groups:
            seg = block_list[g0:g1]
            std_sort(seg, _cmp_by_chr)
            block_list[g0:g1] = seg
            bid = block_list[g0].block_id
            for b in block_list[g0:g1]:
                seq = b.chr.sequence[b.start:b.start + b.length]
                out.write(f"Block #{bid}\t0\t{chr_list[b.chr_id].description}\t"
                          f"{b.conventional_start}\t255\t*\t*\t*\t0\t{seq}\t*\n")


# -- visual outputs (our own minimal templates) -----------------------------

_D3_TEMPLATE_HEAD = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Synteny blocks</title></head>
<body>
<h2>Synteny block adjacency (hierarchical edge data)</h2>
<p>Data arrays below follow the reference d3 diagram's schema
(chart_data: blocks with imports; chart_legend: sequence names).</p>
<script>
"""

_D3_TEMPLATE_TAIL = """
document.addEventListener('DOMContentLoaded', function () {
  var div = document.createElement('pre');
  div.textContent = 'blocks: ' + chart_data.length +
      '\\nsequences: ' + chart_legend.length;
  document.body.appendChild(div);
  var table = document.createElement('table');
  table.border = '1';
  chart_data.forEach(function (d) {
    var tr = document.createElement('tr');
    [d.name, d.size, d.imports.join('; ')].forEach(function (v) {
      var td = document.createElement('td');
      td.textContent = v;
      tr.appendChild(td);
    });
    table.appendChild(tr);
  });
  document.body.appendChild(table);
});
</script>
</body></html>
"""


def _d3_block_id(b: BlockInstance) -> str:
    return (f"seq{b.chr.conventional_id}."
            f"seq {b.chr.conventional_id} - "
            f"{b.conventional_start:>8} - {b.conventional_end:>8}")


def generate_d3_output(blocks: list[BlockInstance], chr_list: list[FASTARecord],
                       file_name: str) -> None:
    """Interactive diagram data (reference: outputgenerator.cpp:483-560;
    same chart_data/chart_legend payload, our own page template)."""
    with open(file_name, "w") as out:
        out.write(_D3_TEMPLATE_HEAD)
        out.write("chart_data = [\n")
        sorted_blocks = list(blocks)
        std_sort(sorted_blocks, _cmp_by_start)
        first = True
        for b in sorted_blocks:
            if not first:
                out.write(",")
            first = False
            imports = [f"\"{_d3_block_id(o)}\"" for o in sorted_blocks
                       if o.block_id == b.block_id and o is not b]
            out.write("    {")
            out.write(f"\"name\":\"{_d3_block_id(b)}\",")
            out.write(f"\"size\":{b.length},")
            out.write(f"\"imports\":[{','.join(imports)}]")
            out.write("}\n")
        out.write("];\n")
        out.write("chart_legend = [\n")
        first = True
        for i, r in enumerate(chr_list):
            if not first:
                out.write(",")
            first = False
            out.write(f"    \"seq {r.id + 1} : {r.description}\"\n")
        out.write("];\n")
        out.write(_D3_TEMPLATE_TAIL)


CIRCOS_MAX_COLOR = 25
CIRCOS_DEFAULT_RADIUS = 1500
CIRCOS_RESERVED_FOR_LABEL = 500
CIRCOS_HIGHLIGHT_THICKNESS = 50

_CIRCOS_TEMPLATE = """# circos configuration (sibelia_tpu)
karyotype = circos.sequences.txt
chromosomes_units = 100000
<links>
  <link>
    file = circos.segdup.txt
    radius = 0.99r
    bezier_radius = 0.2r
    thickness = 2
    ribbon = yes
  </link>
</links>
<<include etc/colors_fonts_patterns.conf>>
<<include etc/housekeeping.conf>>
<image>
<<include circos.image.conf>>
</image>
"""

_CIRCOS_IMAGE_TEMPLATE = """dir = .
file = circos.png
png = yes
svg = yes
angle_offset = -90
auto_alpha_colors = yes
auto_alpha_steps = 5
background = white
"""


def _write_circos_links(out_dir, file_name, blocks):
    sorted_blocks = list(blocks)
    std_sort(sorted_blocks, _cmp_by_id)
    id_length = int(math.log10(len(sorted_blocks))) + 1 if sorted_blocks else 1
    last_id = 0
    link_count = 0
    color = 0
    to_link: list[BlockInstance] = []
    with open(os.path.join(out_dir, file_name), "w") as out:
        for b in sorted_blocks:
            if b.block_id != last_id:
                to_link.clear()
                last_id = b.block_id
            for other in to_link:
                color = (color + 1) % CIRCOS_MAX_COLOR
                for x in (b, other):
                    s, e = x.conventional_start, x.conventional_end
                    if s > e:
                        s, e = e, s
                    out.write(f"block_{link_count:0{id_length}d} "
                              f"seq{x.chr_id + 1} {s} {e} color=chr{color}_a2\n")
                link_count += 1
            to_link.append(b)


def _write_circos_karyotype(out_dir, file_name, history, chr_list):
    shown = set()
    for bl in history:
        for b in bl:
            shown.add(b.chr_id)
    with open(os.path.join(out_dir, file_name), "w") as out:
        for i, r in enumerate(chr_list):
            if r.id in shown:
                out.write(f"chr - seq{i + 1} {r.description} 0 "
                          f"{len(r.sequence)} green_a4\n")


def _write_circos_highlight(out_dir, file_name, blocks, r0, r1, ideogram, config):
    color = 0
    sorted_blocks = list(blocks)
    std_sort(sorted_blocks, _cmp_by_id)
    with open(os.path.join(out_dir, file_name), "w") as out:
        prev = None
        for b in sorted_blocks:
            s, e = b.conventional_start, b.conventional_end
            if s > e:
                s, e = e, s
            if prev is not None and b.block_id != prev.block_id:
                color = (color + 1) % CIRCOS_MAX_COLOR
            if not ideogram:
                fill = f"chr{color}_a0"
            else:
                fill = ("green" if b.signed_id > 0 else "red") + "_a0"
            out.write(f"seq{b.chr.conventional_id} {s} {e} fill_color={fill}\n")
            prev = b
    config.write("\t<highlight>\n")
    config.write(f"\t\tfile = {file_name}\n")
    config.write(f"\t\tideogram = {'yes' if ideogram else 'no'}\n")
    config.write("\t\tfill_color = blue_a3\n")
    config.write("\t\tstroke_color = black\n")
    config.write("\t\tstroke_thickness = 4\n")
    if not ideogram:
        config.write(f"\t\tr0 = 1r +{r0}p\n")
        config.write(f"\t\tr1 = 1r +{r1}p\n")
    config.write("\t</highlight>\n")


def generate_circos_output(blocks: list[BlockInstance], chr_list: list[FASTARecord],
                           out_file: str, out_dir: str) -> None:
    """reference: outputgenerator.cpp:354-367."""
    os.makedirs(out_dir, exist_ok=True)
    with open(out_file, "w") as config:
        config.write(_CIRCOS_TEMPLATE)
        _write_circos_links(out_dir, "circos.segdup.txt", blocks)
        _write_circos_karyotype(out_dir, "circos.sequences.txt", [blocks], chr_list)
        config.write("<highlights>\n\tfill_color = green\n")
        _write_circos_highlight(out_dir, "circos.highlight.txt", blocks, 0, 0, True, config)
        config.write("</highlights>\n")
        config.write("<ideogram>\n\tlabel_radius = 1.08r\n</ideogram>\n")
    with open(os.path.join(out_dir, "circos.image.conf"), "w") as img:
        img.write(_CIRCOS_IMAGE_TEMPLATE)
        img.write(f"radius = {CIRCOS_DEFAULT_RADIUS}p\n")


def generate_hierarchy_circos_output(history: list[list[BlockInstance]],
                                     chr_list: list[FASTARecord],
                                     out_file: str, out_dir: str) -> None:
    """reference: outputgenerator.cpp:328-352."""
    os.makedirs(out_dir, exist_ok=True)
    r = 100
    with open(out_file, "w") as config:
        config.write(_CIRCOS_TEMPLATE)
        _write_circos_links(out_dir, "circos.segdup.txt", history[-1])
        _write_circos_karyotype(out_dir, "circos.sequences.txt", history, chr_list)
        config.write("<highlights>\n\tfill_color = green\n")
        _write_circos_highlight(out_dir, "circos.highlight.txt", history[-1], 0, 0, True, config)
        for i, bl in enumerate(reversed(history[:-1])):
            _write_circos_highlight(out_dir, f"circos.highlight{i + 1}.txt", bl,
                                    r, r + CIRCOS_HIGHLIGHT_THICKNESS, False, config)
            r += int(CIRCOS_HIGHLIGHT_THICKNESS * 1.5)
        config.write("</highlights>\n")
        config.write(f"<ideogram>\n\tlabel_radius = 1r + {r}p\n</ideogram>\n")
    with open(os.path.join(out_dir, "circos.image.conf"), "w") as img:
        img.write(_CIRCOS_IMAGE_TEMPLATE)
        img.write(f"radius = {CIRCOS_DEFAULT_RADIUS + CIRCOS_RESERVED_FOR_LABEL + r}p\n")
