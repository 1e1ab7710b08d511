"""C-Sibelia command line interface of the PyTorch port.

Twin of ``sibelia_tpu/cli/csibelia.py`` (reference
src/csibelia/C-Sibelia.py:509-601): the same arguments and outputs.  It
runs the port's Sibelia CLI with C-Sibelia's fixed flag set (-q
--correctboundaries --nopostprocess --allstages --lastk 30 -m <minblocksize>
-s <preset> -i <maxiter> -r), then the port's ``call_variants`` on the
device that ``SIBELIA_TPU_TORCH_DEVICE`` selects, and writes the VCF (and
the MAF, the unmapped insertions).

In the default (exact) aligner mode on a card, every unique pair's anchors
stage (all pairs of a recursion level in one call), band DP and traceback
run there (``align/anchors_device.py``,
``kernels/order_device.py``); ``SIBELIA_TPU_ANCHORS_DEVICE=1`` and
``SIBELIA_TPU_DEVICE_ORDER=1`` force those modules on whatever the device is
(on the CPU their plain versions), ``SIBELIA_TPU_DEVICE_ORDER=0`` keeps the
band DP in the native library.  Under ``SIBELIA_TPU_NATIVE=0`` the exact
mode takes the anchored aligner, as the JAX CLI's does.

``SIBELIA_TPU_TIMINGS=<path>`` dumps the run's record of
``core/timings.py`` (the Sibelia stage's included: one record for the
whole run) with the launch counts; its counters ``gotoh_flushes`` (gap
batches the fast aligner closed) and ``gotoh_pairs`` (gap subproblems in
them), and of the exact aligner's device path ``order_device_jobs`` and
``order_host_fallback`` (band DPs sent to the device module, and kept by
the native engine for their width), ``order_row_bytes`` (the traceback's
moves and counts brought back; the pointer rows stay on the card) and
``anchors_sweeps`` (hit sets swept) are always there, 0 where nothing
counted; the exact aligner's spans are ``rechaos``, with ``chaos`` (the
native CHAOS of every pair a level), ``anchors_parse`` and
``anchors_device`` inside it, ``order_prepare``, ``order_device`` and
``order_finish``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from ..core import timings
from ..core.platform import resolve_device
from ..variants import caller
from .sibelia import write_timings
from .sibelia import run as sibelia_run

# counters the dump always holds
COUNTERS = ("gotoh_flushes", "gotoh_pairs", "order_device_jobs",
            "order_host_fallback", "order_row_bytes", "anchors_sweeps")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="C-Sibelia",
        description="A tool for comparing two microbial genomes.")
    parser.add_argument("reference")
    parser.add_argument("assembly")
    parser.add_argument("-s", "--parameters", default="fine")
    parser.add_argument("-m", "--minblocksize", type=int, default=500)
    parser.add_argument("-p", "--processcount", type=int, default=1)
    parser.add_argument("-i", "--maxiterations", type=int, default=4)
    parser.add_argument("--maf")
    parser.add_argument("-v", "--variant", default="variant.vcf")
    parser.add_argument("-u", "--unmapped", type=str)
    parser.add_argument("--debug", action="store_true")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("-t", "--tempdir")
    group.add_argument("-o", "--outdir")
    return parser


def _sibelia_argv(args, outdir: str) -> list[str]:
    return [args.reference, args.assembly,
            "-q", "--correctboundaries", "--nopostprocess", "--allstages",
            "--lastk", "30", "-m", str(args.minblocksize), "-o", outdir,
            "-s", args.parameters, "-i", str(args.maxiterations), "-r"]


def run(argv: list[str]) -> int:
    with timings.run_scope():  # one record, the Sibelia stage's included
        return _run(argv)


def _run(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cleanup = False
    if args.outdir is None:
        if args.tempdir is None:
            temp_dir = tempfile.mkdtemp(dir=".")
            cleanup = True
        else:
            temp_dir = args.tempdir
    else:
        temp_dir = args.outdir

    try:
        print("Calculating synteny blocks...", file=sys.stderr)
        with timings.phase("synteny"):
            rc = sibelia_run(_sibelia_argv(args, temp_dir))
        if rc != 0:
            raise RuntimeError("synteny stage failed")

        genomes = (caller.parse_fasta_file(args.reference)
                   + caller.parse_fasta_file(args.assembly))
        reference = caller.parse_fasta_file(args.reference)
        assembly = caller.parse_fasta_file(args.assembly)
        reference_seq = {r.id: r.seq for r in reference}
        assembly_seq = {r.id: r.seq for r in assembly}
        reference_organism = reference[0]
        all_seq = sorted([r.id for r in reference] + [r.id for r in assembly])
        for i in range(len(all_seq) - 1):
            if all_seq[i] == all_seq[i + 1]:
                raise RuntimeError(
                    f'Found duplicated sequence id "{all_seq[i]}"')

        print("Calling variants...", file=sys.stderr)
        with timings.phase("variant_calling"):
            variant_list, insertion_list, alignment_list = caller.call_variants(
                temp_dir, genomes, reference_seq, assembly_seq,
                args.minblocksize, device, align=args.maf is not None,
                processes=args.processcount)
        variant_list.sort(key=caller.variant_key)
        vcf_file = (args.variant if args.outdir is None
                    else os.path.join(args.outdir, args.variant))
        with open(vcf_file, "w") as vcf_out:
            caller.write_vcf_header(reference_organism, vcf_out)
            if args.unmapped is not None:
                ins_file = (args.unmapped if args.outdir is None
                            else os.path.join(args.outdir, args.unmapped))
                caller.write_insertions_fasta(insertion_list, ins_file)
            else:
                caller.write_insertions_vcf(insertion_list, reference_organism,
                                          vcf_out)
            caller.write_variants_vcf(variant_list, vcf_out)

        if args.debug:
            conv = ("variant.txt" if args.outdir is None
                    else os.path.join(args.outdir, "variant.txt"))
            with open(conv, "w") as h:
                for v in variant_list:
                    h.write(str(v) + "\n")
                for v in insertion_list:
                    h.write(str(v) + "\n")

        if args.maf is not None:
            maf_file = (args.maf if args.outdir is None
                        else os.path.join(args.outdir, args.maf))
            with open(maf_file, "w") as h:
                caller.write_alignments_maf(alignment_list, h)
        return 0
    finally:
        write_timings({name: timings._ACC.get(name, 0)
                       for name in COUNTERS})
        if cleanup:
            shutil.rmtree(temp_dir, ignore_errors=True)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
