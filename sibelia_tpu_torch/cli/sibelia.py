"""Sibelia command line interface of the PyTorch port.

Same flags and outputs as ``sibelia_tpu/cli/sibelia.py`` (full flag surface
of the reference CLI, src/sibelia.cpp:43-368); the simplification stages run
through the port's ``BlockFinder`` on the device that
``SIBELIA_TPU_TORCH_DEVICE`` selects.

``--checkpoint DIR`` saves the state after each stage and resumes after
the newest ``stage_*.ckpt`` there, as the JAX CLI does.
``SIBELIA_TPU_PROFILE_DIR=<dir>`` holds a ``torch.profiler`` window (the
CPU, and the card's kernels on a card) over the stages and the output, and
writes it as a Chrome trace, ``sibelia.pt.trace.json``, into the directory,
with the program's spans of the window (``core/timings.py``'s log) as a
process of their own, ``program spans``.

``SIBELIA_TPU_SHARDED=N`` runs the enumerations and the re-prefilter over a
mesh of N shards (``parallel/``).  ``SIBELIA_TPU_COORD``,
``SIBELIA_TPU_NPROCS`` and ``SIBELIA_TPU_PROC_ID`` make N processes one run
(``parallel/runtime.py::init_distributed``): the mesh spans the process
group (``SIBELIA_TPU_SHARDED`` defaults to its size), every process runs
the deterministic rest, and only process 0 writes.

``SIBELIA_TPU_NATIVE=0`` turns the native libraries off: the stages run
the Python engine (``graph/simplify.py``) after the same enumerations on
the device; ``SIBELIA_TPU_CHECK=1`` runs it too, with the runtime invariant
check after every collapsing vertex (``blocks/finder.py``); no arena slab
is mapped.

Host memory is set up as in the JAX CLI.  External-memory mode: the
native ranking arenas spill to unlinked files in a directory under ``-t``
when the estimated in-RAM peak exceeds 3/4 of MemAvailable
(``SIBELIA_TPU_MEMAVAIL_MB`` sets that budget), or when
``SIBELIA_TPU_EXTMEM=1`` forces it; ``-r`` keeps them in RAM.  What it
bounds differs by route.  The port's enumerations run on the device, and
reach those arenas only on the host route: a supergenome of 2^30 rows or
more on any device, or one whose fitted peak the card cannot hold
(``index/enumeration.py::host_route``); the host's trim calls stay below
the native enumeration's 2^16 rows.  So spill mode bounds the host
enumeration of those supergenomes and nothing else: the card's memory is
bounded by that rule, and the engine's arrays and the numpy staging by
nothing.  In RAM the run keeps what it
frees (``mallopt``, as the JAX CLI) and maps one populated arena slab
before the stages (``slab_bytes``: sized by the route, at most 3/4 of the
same budget shared by the run's processes, none below 1 GiB), from which
the engine's node and sequence arrays and the ranking arenas carve.  The slab takes the hugetlb pages
that exist, else plain pages; the pool is never grown.

``SIBELIA_TPU_TRACE=1`` prints one ``[trace] stage`` line a simplification
stage to stderr, as the JAX CLI does.  ``SIBELIA_TPU_TIMINGS=<path>`` dumps
the run's record of ``core/timings.py`` (span seconds and counters: among
them ``sync_wait`` and ``syncs_<tag>``, the blocking copies between host
and card; ``engine_sweep`` with the native engine's ``sweep_detect``,
``sweep_apply``, ``sweep_prefilter``, ``sweep_iterations``, ``sweep_bulges``,
``wave_detections``, ``wave_stale``, ``wave_resume``, ``wave_uncached``
and, under ``SIBELIA_TPU_PROF=2``, its per-id split ``sweep_prof_*``;
``reprefilter``; ``enum_host``) with the kernel launch counts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time

import torch.distributed as dist

from .. import VERSION, native
from ..blocks.boundaries import improve_block_boundaries
from ..blocks.finder import BlockFinder, load_checkpoint, save_checkpoint
from ..blocks.postprocess import glue_stripes
from ..core import timings
from ..core.config import MAX_INPUT_SIZE, PRESETS, read_stage_file
from ..core.platform import LAUNCHES, resolve_device
from ..core.progress import make_progress_bar
from ..io import writers
from ..index.enumeration import host_route, supergenome_rows
from ..io.fasta import read_fasta
from ..parallel.runtime import init_distributed


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
                   help="directory for per-stage checkpoints; resumes from "
                        "the newest one (sibelia_tpu extension)")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("filenames", nargs="+")
    return p


def mem_available() -> int | None:
    """The host's memory budget in bytes: SIBELIA_TPU_MEMAVAIL_MB (a small
    host simulated, or a budget pinned below MemAvailable), else
    /proc/meminfo's MemAvailable; None when neither reads."""
    ov = os.environ.get("SIBELIA_TPU_MEMAVAIL_MB")
    if ov and ov.isdigit():
        return int(ov) << 20
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _last_k(args, stage) -> int:
    if args.lastk is not None:
        return args.lastk
    return min(stage[-1][0] if stage else (1 << 31), args.minblocksize)


# bytes a base of one stage's engine sequence arrays: its chars (1 B) and
# origpos (4 B), which engine.cpp::engine_create carves anew every stage
ENGINE_BYTES_A_BASE = 5


def slab_bytes(total: int, n_chr: int, host_route: bool,
               avail: int | None, n_stages: int = 1, n_procs: int = 1) -> int:
    """Bytes of the native arena slab for an input of `total` bases in
    `n_chr` chromosomes.  On the host route (a stage's enumeration in the
    native ranking arenas) the JAX CLI's size, about 95 B a supergenome
    row.  Else the least that the run's engines carve: every stage's
    sequence arrays, ENGINE_BYTES_A_BASE each (a slab's carve is never
    reused); their node arrays, the growth of their sequence arrays and
    the 2 MiB alignment of every carve come on top, from the slab while it
    lasts and from malloc after, so no populated page of it stays
    unused.  No more than 3/4 of `avail` (the external-memory gate's
    budget) shared by `n_procs` processes, which may all be on this host;
    0 below 1 GiB, as in the JAX CLI."""
    if host_route:
        want = (2 * (total + n_chr + 1) + 128) * 95 + (64 << 20)
    else:
        want = n_stages * ENGINE_BYTES_A_BASE * total
    if avail is not None:
        want = min(want, avail * 3 // 4 // max(n_procs, 1))
    return want if want >= (1 << 30) else 0


def _keep_freed_memory() -> None:
    """glibc keeps what the run frees, as the JAX CLI sets it for in-RAM
    runs: large blocks from the brk heap (M_MMAP_MAX = 0), never trimmed
    (M_TRIM_THRESHOLD at its largest), so the engine's and the staging
    buffers' churn does not fault its pages in again every stage."""
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-4, 0)
        libc.mallopt(-1, 0x7FFFFFFF)
    except (OSError, AttributeError):
        pass


def _spill_dir(args, stage, total: int) -> str | None:
    """External-memory mode of the host ranking arenas (as in the JAX CLI):
    a spill dir under -t when the estimated in-RAM peak would not fit, or
    SIBELIA_TPU_EXTMEM=1 forces it; -r forces in-RAM."""
    if (args.inram or "SIBELIA_TPU_SPILL_DIR" in os.environ
            or os.environ.get("SIBELIA_TPU_EXTMEM") == "0"):
        return None
    any_big_k = any(k > 32 for k, _ in stage) or _last_k(args, stage) > 32
    est = total * (120 if any_big_k else 70)
    avail = mem_available()
    if (os.environ.get("SIBELIA_TPU_EXTMEM") == "1"
            or (avail is not None and est > avail * 3 // 4)):
        path = tempfile.mkdtemp(prefix="sibelia_spill_", dir=args.tempdir)
        os.environ["SIBELIA_TPU_SPILL_DIR"] = path
        print("Using external-memory mode (temp dir: %s)" % path,
              file=sys.stderr)
        return path
    return None


def run(argv: list[str]) -> int:
    with timings.run_scope():  # each run dumps its own record
        return _run(argv)


def _run(argv: list[str]) -> int:
    args = build_arg_parser().parse_args(argv)
    spill = prof = None
    multiproc = False
    try:
        device = resolve_device()
        is_writer = True
        if os.environ.get("SIBELIA_TPU_COORD"):
            # N processes, one run: the sharded enumerations span the
            # group, the rest runs replicated, process 0 writes
            multiproc = init_distributed(device=device)
            if multiproc:
                is_writer = dist.get_rank() == 0
                os.environ.setdefault("SIBELIA_TPU_SHARDED",
                                      str(dist.get_world_size()))
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
        if "SIBELIA_TPU_SPILL_DIR" not in os.environ:
            # in RAM: keep freed memory, and map the slab while the
            # process is small
            _keep_freed_memory()
            # sized on the route of the input's supergenome; each
            # enumeration decides its own route again when it runs
            rows = supergenome_rows(total, len(chr_list))
            ks = {k for k, _ in stage} | {_last_k(args, stage)}
            slab = slab_bytes(
                total, len(chr_list),
                any(host_route(rows, k, device) for k in ks),
                mem_available(), len(stage),
                dist.get_world_size() if multiproc else 1)
            if slab:
                with timings.phase("slab_reserve"):
                    native.slab_reserve(slab)

        history: list[list] = [[] for _ in range(len(stage) + 1)]
        finder = BlockFinder(chr_list, device)
        if is_writer:
            os.makedirs(args.outdir, exist_ok=True)
        out = args.outdir
        # --checkpoint DIR: persist (raw_seq, original_pos, rand state)
        # after each stage and resume from the newest checkpoint
        start_stage = 0
        ckpt_dir = args.checkpoint
        if ckpt_dir:
            if is_writer:
                os.makedirs(ckpt_dir, exist_ok=True)
            done = sorted(f for f in (os.listdir(ckpt_dir)
                                      if os.path.isdir(ckpt_dir) else [])
                          if f.startswith("stage_") and f.endswith(".ckpt"))
            if multiproc:
                # all processes resume from the same checkpoint: none is
                # written before every process has looked
                dist.barrier()
            if done:
                stage_idx, history = load_checkpoint(
                    finder, os.path.join(ckpt_dir, done[-1]))
                start_stage = stage_idx + 1
                print(f"Resuming after stage {stage_idx + 1}",
                      file=sys.stderr)
        trace = os.environ.get("SIBELIA_TPU_TRACE") == "1"
        prof = _open_profile(device)
        trim_k = 1 << 31
        for i, (k, d) in enumerate(stage):
            trim_k = min(trim_k, k)
            if i < start_stage:
                continue
            t_stage = time.time()
            if args.visualize or args.allstages:
                if not args.noblocks:
                    history[i] = finder.generate_synteny_blocks(
                        k, trim_k, k, args.sharedonly)
                    if not args.nopostprocess:
                        history[i] = glue_stripes(history[i], chr_list)
                if args.graphfile:
                    with _output(os.path.join(out, f"de_bruijn_graph{i}.dot"),
                                 is_writer) as g:
                        finder.serialize_condensed_graph(
                            k, g, progress=make_progress_bar())
            print(f"Simplification stage {i + 1} of {len(stage)}")
            print("Enumerating vertices of the graph, then performing bulge "
                  "removal...")
            n_before = sum(len(s) for s in finder.raw_seq)
            timings.add("kmers_indexed", 2 * n_before)
            finder.perform_graph_simplifications(
                k, d, args.maxiterations, progress=make_progress_bar())
            if trace:
                dt = time.time() - t_stage
                n_now = sum(len(s) for s in finder.raw_seq)
                # both strands are indexed: a stage processes twice the
                # working sequence's k-mers
                rate = 2 * n_before / max(dt, 1e-9) / 1e6
                print(f"[trace] stage {i + 1}: k={k} d={d} "
                      f"{dt:.2f}s seq={n_now} {rate:.1f} Mkmers/s",
                      file=sys.stderr)
            if ckpt_dir and is_writer:
                save_checkpoint(finder,
                                os.path.join(ckpt_dir, f"stage_{i:03d}.ckpt"),
                                i, history)

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
                if is_writer:
                    write_outputs(args, history, chr_list, coords_writer,
                                  ext)

        if args.graphfile:
            suffix = f"{len(stage)}" if args.allstages else ""
            with _output(os.path.join(out, f"de_bruijn_graph{suffix}.dot"),
                         is_writer) as g:
                finder.serialize_condensed_graph(last_k, g)
        if multiproc:
            # every process ran the same collectives; hold them all until
            # the writer is done, so that teardown cannot race a write
            dist.barrier()
        return 0
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        cap, used = native.slab_stats()
        if cap:
            timings.add("slab_bytes", cap)
            timings.add("slab_used", used)
        if multiproc:
            dist.destroy_process_group()
        if prof is not None:
            _close_profile(*prof)
        write_timings()
        if spill:
            # spill files are unlinked at creation; only the dir remains
            try:
                os.rmdir(spill)
            except OSError:
                pass


def _output(path: str, is_writer: bool):
    """`path` opened for writing, or the null device on a process that
    does not write: the graph is still built there, since its index's
    enumeration is a collective of every process."""
    return open(path if is_writer else os.devnull, "w")


def _open_profile(device):
    """Under SIBELIA_TPU_PROFILE_DIR=<dir>, start a torch.profiler window
    over the CPU (and the card's kernels and copies on a card); returns
    (profiler, dir, the log's length) for ``_close_profile``, or None."""
    prof_dir = os.environ.get("SIBELIA_TPU_PROFILE_DIR")
    if not prof_dir:
        return None
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof, prof_dir, len(timings.LOG)


def _close_profile(prof, prof_dir: str, first: int) -> None:
    """End the window and write it as a Chrome trace into prof_dir, with
    the spans the window logged from record `first` on."""
    prof.stop()
    os.makedirs(prof_dir, exist_ok=True)
    path = os.path.join(prof_dir, "sibelia.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # the trace's times are microseconds from its base on the same clock
    base = trace.get("baseTimeNanoseconds", 0)
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": "spans",
                   "args": {"name": "program spans"}})
    for name, start, end, parent, run in timings.log_records(first):
        events.append({"ph": "X", "cat": "program_span", "name": name,
                       "pid": "spans", "tid": 0,
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"parent": parent, "run": run}})
    with open(path, "w") as f:
        json.dump(trace, f)


def write_timings(extra: dict | None = None) -> None:
    """Under SIBELIA_TPU_TIMINGS=<path>, write the run's record (span
    seconds and counters) with the launch counts (and `extra`) there as
    JSON; a later call rewrites the file with the record as it stands
    then."""
    path = os.environ.get("SIBELIA_TPU_TIMINGS")
    if not path:
        return
    table = timings.snapshot()
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
