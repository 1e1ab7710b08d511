"""Sibelia command line interface of the PyTorch port.

Same flags and outputs as ``sibelia_tpu/cli/sibelia.py`` (full flag surface
of the reference CLI, src/sibelia.cpp:43-368); the simplification stages run
through the port's ``BlockFinder`` on the device that
``SIBELIA_TPU_TORCH_DEVICE`` selects.

Not yet ported, and refused with exit code 1 when asked for: the
multi-host runtime (``SIBELIA_TPU_COORD``, ``SIBELIA_TPU_SHARDED``),
``--checkpoint``, ``SIBELIA_TPU_PROFILE_DIR`` and the Python
simplification engine (``SIBELIA_TPU_CHECK=1``, ``SIBELIA_TPU_NATIVE=0``).
The native arena slab reservation is not made.

``SIBELIA_TPU_TIMINGS=<path>`` dumps the per-phase seconds of
``core/timings.py`` with the kernel launch counts.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from .. import VERSION
from ..blocks.boundaries import improve_block_boundaries
from ..blocks.finder import BlockFinder
from ..blocks.postprocess import glue_stripes
from ..core import timings
from ..core.config import MAX_INPUT_SIZE, PRESETS, read_stage_file
from ..core.platform import LAUNCHES, SYNC_COUNTS, resolve_device
from ..core.progress import make_progress_bar
from ..io import writers
from ..io.fasta import read_fasta


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="Sibelia",
        description="Program for finding synteny blocks in closely related genomes")
    p.add_argument("--version", action="version", version=VERSION)
    p.add_argument("-i", "--maxiterations", type=int, default=4)
    p.add_argument("--correctboundaries", action="store_true")
    p.add_argument("--nopostprocess", action="store_true")
    p.add_argument("--gff", action="store_true")
    p.add_argument("--allstages", action="store_true")
    p.add_argument("--lastk", type=int, default=None)
    p.add_argument("-t", "--tempdir", default=".")
    group = p.add_mutually_exclusive_group()
    group.add_argument("-k", "--stagefile", default=None)
    group.add_argument("-s", "--parameters", choices=sorted(PRESETS), default=None)
    p.add_argument("-v", "--visualize", action="store_true")
    p.add_argument("-g", "--graphfile", action="store_true")
    p.add_argument("-q", "--sequencesfile", action="store_true")
    p.add_argument("-m", "--minblocksize", type=int, default=5000)
    p.add_argument("-a", "--sharedonly", action="store_true")
    p.add_argument("-r", "--inram", action="store_true")
    p.add_argument("--noblocks", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="directory for per-stage checkpoints (not ported)")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("filenames", nargs="+")
    return p


def _refuse_unported(args) -> None:
    asked = []
    if args.checkpoint:
        asked.append("--checkpoint")
    for var in ("SIBELIA_TPU_PROFILE_DIR", "SIBELIA_TPU_COORD"):
        if os.environ.get(var):
            asked.append(var)
    if os.environ.get("SIBELIA_TPU_SHARDED", "1") not in ("", "0", "1"):
        asked.append("SIBELIA_TPU_SHARDED")
    # both select the Python simplification engine (graph/simplify.py of
    # the JAX package), which the port does not carry
    if os.environ.get("SIBELIA_TPU_CHECK") == "1":
        asked.append("SIBELIA_TPU_CHECK=1")
    if os.environ.get("SIBELIA_TPU_NATIVE") == "0":
        asked.append("SIBELIA_TPU_NATIVE=0")
    if asked:
        raise RuntimeError(", ".join(asked) + " not yet ported to "
                           "sibelia_tpu_torch; use sibelia_tpu.cli.sibelia")


def _spill_dir(args, stage, total: int) -> str | None:
    """External-memory mode of the host ranking arenas (as in the JAX CLI):
    a spill dir under -t when the estimated in-RAM peak would not fit, or
    SIBELIA_TPU_EXTMEM=1 forces it; -r forces in-RAM."""
    if (args.inram or "SIBELIA_TPU_SPILL_DIR" in os.environ
            or os.environ.get("SIBELIA_TPU_EXTMEM") == "0"):
        return None
    last_k = args.lastk if args.lastk is not None else \
        min(stage[-1][0] if stage else (1 << 31), args.minblocksize)
    any_big_k = any(k > 32 for k, _ in stage) or last_k > 32
    est = total * (120 if any_big_k else 70)
    avail = None
    ov = os.environ.get("SIBELIA_TPU_MEMAVAIL_MB")
    if ov and ov.isdigit():
        avail = int(ov) << 20
    else:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        avail = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
    if (os.environ.get("SIBELIA_TPU_EXTMEM") == "1"
            or (avail is not None and est > avail * 3 // 4)):
        path = tempfile.mkdtemp(prefix="sibelia_spill_", dir=args.tempdir)
        os.environ["SIBELIA_TPU_SPILL_DIR"] = path
        print("Using external-memory mode (temp dir: %s)" % path,
              file=sys.stderr)
        return path
    return None


def run(argv: list[str]) -> int:
    args = build_arg_parser().parse_args(argv)
    timings.reset()  # each run dumps its own phases
    spill = None
    try:
        _refuse_unported(args)
        device = resolve_device()
        if args.stagefile is not None:
            stage = read_stage_file(args.stagefile)
        else:
            stage = PRESETS[args.parameters or "loose"]
        if args.correctboundaries and len(args.filenames) != 2:
            raise RuntimeError(
                "In correction mode only two FASTA files are acceptable")

        chr_list = []
        reference_chr_id = set()
        for i, fn in enumerate(args.filenames):
            if not os.path.exists(fn):
                raise RuntimeError(f"Cannot open file {fn}")
            read_fasta(fn, chr_list)
            if i == 0:
                reference_chr_id = {r.id for r in chr_list}
        total = sum(len(r.sequence) for r in chr_list)
        if total > MAX_INPUT_SIZE:
            raise RuntimeError("Input is larger than 1 GB, can't proceed")
        spill = _spill_dir(args, stage, total)
        if args.graphfile:
            # the -g flows rebuild the index at a k they just enumerated
            os.environ.setdefault("SIBELIA_TPU_FCACHE", "1")

        history: list[list] = [[] for _ in range(len(stage) + 1)]
        finder = BlockFinder(chr_list, device)
        os.makedirs(args.outdir, exist_ok=True)
        out = args.outdir
        trim_k = 1 << 31
        for i, (k, d) in enumerate(stage):
            trim_k = min(trim_k, k)
            if args.visualize or args.allstages:
                if not args.noblocks:
                    history[i] = finder.generate_synteny_blocks(
                        k, trim_k, k, args.sharedonly)
                    if not args.nopostprocess:
                        history[i] = glue_stripes(history[i], chr_list)
                if args.graphfile:
                    with open(os.path.join(out, f"de_bruijn_graph{i}.dot"),
                              "w") as g:
                        finder.serialize_condensed_graph(
                            k, g, progress=make_progress_bar())
            print(f"Simplification stage {i + 1} of {len(stage)}")
            print("Enumerating vertices of the graph, then performing bulge "
                  "removal...")
            timings.add("kmers_indexed",
                        2 * sum(len(s) for s in finder.raw_seq))
            finder.perform_graph_simplifications(
                k, d, args.maxiterations, progress=make_progress_bar())

        print("Finding synteny blocks and generating the output...")
        trim_k = min(trim_k, args.minblocksize)
        if args.lastk is not None:
            last_k = args.lastk
        else:
            last_k = min(stage[-1][0] if stage else (1 << 31),
                         args.minblocksize)
        old_format = not args.gff
        coords_writer = (writers.list_blocks_indices if old_format
                         else writers.list_blocks_indices_gff)
        ext = ".txt" if old_format else ".gff"

        if not args.noblocks:
            history[-1] = finder.generate_synteny_blocks(
                last_k, trim_k, args.minblocksize, args.sharedonly,
                progress=make_progress_bar())
            if not args.nopostprocess:
                history[-1] = glue_stripes(history[-1], chr_list)
            if args.correctboundaries:
                improve_block_boundaries(history[-1], reference_chr_id,
                                         args.minblocksize)
            with timings.phase("writers"):
                write_outputs(args, history, chr_list, coords_writer, ext)

        if args.graphfile:
            suffix = f"{len(stage)}" if args.allstages else ""
            with open(os.path.join(out, f"de_bruijn_graph{suffix}.dot"),
                      "w") as g:
                finder.serialize_condensed_graph(last_k, g)
        return 0
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        write_timings()
        if spill:
            # spill files are unlinked at creation; only the dir remains
            try:
                os.rmdir(spill)
            except OSError:
                pass


def write_timings(extra: dict | None = None) -> None:
    """Under SIBELIA_TPU_TIMINGS=<path>, write the phase seconds with the
    sync and launch counts (and `extra`) there as JSON; a later call
    rewrites the file with the counts as they stand then."""
    path = os.environ.get("SIBELIA_TPU_TIMINGS")
    if not path:
        return
    table = timings.snapshot()
    table.update({"syncs_" + tag: n for tag, n in SYNC_COUNTS.items()})
    table.update({"launches_" + name: n for name, n in LAUNCHES.items()})
    table.update(extra or {})
    try:
        with open(path, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
    except OSError:
        pass


def write_outputs(args, history, chr_list, coords_writer, ext: str) -> None:
    out = args.outdir
    if args.allstages:
        for i, blocks in enumerate(history):
            coords_writer(blocks, chr_list,
                          os.path.join(out, f"blocks_coords{i}{ext}"))
    else:
        coords_writer(history[-1], chr_list,
                      os.path.join(out, f"blocks_coords{ext}"))
    writers.list_chromosomes_as_permutations(
        history[-1], chr_list, os.path.join(out, "genomes_permutations.txt"))
    writers.generate_report(
        history[-1], chr_list, os.path.join(out, "coverage_report.txt"))
    if args.sequencesfile:
        writers.list_blocks_sequences(
            history[-1], chr_list, os.path.join(out, "blocks_sequences.fasta"))
    writers.generate_d3_output(
        history[-1], chr_list, os.path.join(out, "d3_blocks_diagram.html"))
    circos_dir = os.path.join(out, "circos")
    circos_file = os.path.join(circos_dir, "circos.conf")
    if not args.visualize:
        writers.generate_circos_output(history[-1], chr_list, circos_file,
                                       circos_dir)
    else:
        writers.generate_hierarchy_circos_output(history, chr_list,
                                                 circos_file, circos_dir)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
