"""Runs the native C++ simplification engine (``engine.cpp``) with the port's
device re-prefilter installed (twin of
``sibelia_tpu/native/__init__.py::simplify_native`` and
``_device_reprefilter``).

Two switches of the JAX package are read here as there:
``SIBELIA_TPU_WAVE_DEVICE=0`` installs no re-prefilter (the engine's host
prefilter runs; ``1`` and unset both mean "installed", since the port's
callback has a plain version on the CPU), and
``SIBELIA_TPU_DENSE_SIMPLIFY=1`` runs the dense reference loop
(``engine_simplify``) in place of the sparse sweep.

The engine calls the re-prefilter at the start of a stage that has no
candidate bitmap and mid-sweep when many ids are flagged; the port's
callback runs ``candidate_scan`` on the run's device, or under
``SIBELIA_TPU_SHARDED=N`` (N > 1, N shards available)
``parallel/sharded_sweep.py::sharded_candidate_scan`` over ``make_mesh(N)``,
as the JAX package's does.  An exception in the
callback cannot unwind through the C++ frames, so the callback stashes it
and returns 0, and ``simplify`` re-raises it once the sweep returns: a
failing kernel fails the run.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..core import timings
from ..core.convert import to_numpy, to_tensor
from ..core.platform import sync_wait
from ..index.enum_device import candidate_scan
from ..index.enum_device import _CAND_BAND
from ..index.enumeration import build_supergenome
from ..parallel.sharded import requested_mesh
from ..parallel.sharded_sweep import sharded_candidate_scan
from . import PROGRESS_CFUNC, REPREFILTER_CFUNC, load


def device_reprefilter(lib, handle, n_chr: int, k: int, min_branch: int,
                       n_ids: int, device: torch.device) -> np.ndarray:
    """uint8[n_ids] bulge-candidate bitmap of the engine's frozen state:
    its live instance table and current sequence, exported and rebuilt in
    the supergenome frame.  A superset of "AnyBulges reports a group", as
    the host prefilter is.  Positions stay int64, so every input size runs
    on the device."""
    timings.add("reprefilter_calls", 1)
    chroms = []
    for c in range(n_chr):
        buf = np.empty(lib.engine_chr_len(handle, c), dtype=np.uint8)
        lib.engine_export_chars(handle, c, buf.ctypes.data)
        chroms.append(buf)
    lens = np.asarray([len(c) for c in chroms], dtype=np.int64)
    m = int(lib.engine_live_node_count(handle))
    strand = np.empty(m, dtype=np.int8)
    chrs = np.empty(m, dtype=np.int32)
    pos = np.empty(m, dtype=np.int64)
    bif = np.empty(m, dtype=np.uint32)
    lib.engine_export_nodes(handle, strand.ctypes.data, chrs.ctypes.data,
                            pos.ctypes.data, bif.ctypes.data)
    codes, block_starts = build_supergenome(chroms)
    n = codes.shape[0]
    # positive-frame node -> supergenome coordinate (strand 1 lives in the
    # rc half at the mirrored local offset)
    block = np.where(strand == 0, chrs, n_chr + chrs)
    local = np.where(strand == 0, pos, lens[chrs] - 1 - pos)
    mesh = requested_mesh(device)
    if mesh is not None:
        timings.add("sharded_reprefilter_calls", 1)
        # whole slices of at least the band's rows on every shard
        B = max(m, n_ids, mesh.size * _CAND_BAND)
        B = -(-B // mesh.size) * mesh.size
        sg = block_starts[block] + local
        order = np.argsort(sg, kind="stable")
        pos_p = np.full(B, n, dtype=np.int64)
        ids_p = np.full(B, B, dtype=np.int64)
        pos_p[:m] = sg[order]
        ids_p[:m] = bif[order]
        # the scan uploads its three arrays to the shards itself
        with sync_wait("reprefilter_upload", 3):
            cand = sharded_candidate_scan(codes, pos_p, ids_p, k,
                                          min_branch, m, mesh)
        with sync_wait("reprefilter_fetch"):
            return to_numpy(cand[:n_ids]).astype(np.uint8)
    B = max(m, n_ids)
    pos_p = np.full(B, n, dtype=np.int64)
    ids_p = np.full(B, B, dtype=np.int64)
    pos_p[:m] = block_starts[block] + local
    ids_p[:m] = bif
    with sync_wait("reprefilter_upload", 3):
        pos_d, perm = torch.sort(to_tensor(pos_p, device))
        ids_d = to_tensor(ids_p, device)[perm]
        codes_d = to_tensor(codes, device)
    cand = candidate_scan(codes_d, pos_d, ids_d, k, min_branch, m)
    with sync_wait("reprefilter_fetch"):
        return to_numpy(cand[:n_ids]).astype(np.uint8)


# engine_sweep_stats: seconds (wall) and counts of the engine's sweeps,
# since its creation, under these names in core/timings
SWEEP_SECONDS = ("sweep_detect", "sweep_apply", "sweep_prefilter")
SWEEP_COUNTS = ("sweep_iterations", "sweep_bulges", "wave_detections",
                "wave_stale", "wave_resume", "wave_uncached")
# the per-id split under SIBELIA_TPU_PROF=2 (SweepStats; thread seconds,
# the detection threads' included)
PROF_SECONDS = ("detect", "pairs", "collapse", "cleanup", "erase", "replace",
                "update", "walk", "vec", "bits", "map", "interp")
PROF_COUNTS = ("ids", "collapses", "deltas", "swept")


def record_sweep_stats(lib, handle) -> None:
    """Add the engine's sweep record (``engine_sweep_stats``) to
    ``core/timings``: the wave's parallel detection, the application
    (in-order apply and serial recomputes), the host prefilter and the
    counters; under SIBELIA_TPU_PROF=2 also the per-id split as
    ``sweep_prof_*``."""
    secs = (ctypes.c_double * (len(SWEEP_SECONDS) + len(PROF_SECONDS)))()
    counts = (ctypes.c_int64 * (len(SWEEP_COUNTS) + len(PROF_COUNTS)))()
    deep = lib.engine_sweep_stats(handle, secs, counts)
    n_s, n_c = len(SWEEP_SECONDS), len(SWEEP_COUNTS)
    for name, v in zip(SWEEP_SECONDS, secs[:n_s]):
        timings.add(name, v)
    for name, v in zip(SWEEP_COUNTS, counts[:n_c]):
        timings.add(name, int(v))
    if deep:
        for name, v in zip(PROF_SECONDS, secs[n_s:]):
            timings.add("sweep_prof_" + name, v)
        for name, v in zip(PROF_COUNTS, counts[n_c:]):
            timings.add("sweep_prof_" + name, int(v))


def simplify(seq, enum, k: int, min_branch: int, max_iterations: int,
             device: torch.device, candidates: np.ndarray | None = None,
             release_enum: bool = False, progress=None) -> int:
    """Run one simplification stage in the native engine (its sparse
    sweep, or the dense loop under SIBELIA_TPU_DENSE_SIMPLIFY=1).  `seq` is a MutableSequence, mutated in place; `enum` a
    BifEnumeration; `candidates` the uint8[count] bitmap of the stage-start
    prefilter, if computed.  Returns the bulge count."""
    lib = load()
    n_chr = seq.n_chr
    chr_lens = (ctypes.c_int64 * n_chr)(*[seq.chr_len(c) for c in range(n_chr)])
    char_bufs = [np.ascontiguousarray(seq.chars[c]) for c in range(n_chr)]
    op_bufs = [np.ascontiguousarray(seq.origpos[c], dtype=np.int32)
               for c in range(n_chr)]
    char_ptrs = (ctypes.c_void_p * n_chr)(*[b.ctypes.data for b in char_bufs])
    op_ptrs = (ctypes.c_void_p * n_chr)(*[b.ctypes.data for b in op_bufs])
    sep = (ctypes.c_int64 * n_chr)(*seq.sep_origpos)
    with timings.phase("engine_ingest"):
        handle = lib.engine_create(n_chr, chr_lens, char_ptrs, op_ptrs, sep)
    try:
        lens = np.asarray([seq.chr_len(c) for c in range(n_chr)],
                          dtype=np.int64)
        packed = []
        for strand in (0, 1):
            chrs = np.ascontiguousarray(enum.chr[strand], dtype=np.int32)
            pos = enum.pos[strand] if strand == 0 else (
                lens[chrs] - 1 - enum.pos[strand])
            packed.append((chrs, np.ascontiguousarray(pos, dtype=np.int32),
                           np.ascontiguousarray(enum.bif_id[strand],
                                                dtype=np.uint32)))
        if release_enum:
            enum.chr = enum.pos = enum.bif_id = (None, None)
        (c0, p0, b0), (c1, p1, b1) = packed
        with timings.phase("engine_ingest"):
            lib.engine_set_bifs(
                handle, enum.count,
                len(c0), c0.ctypes.data, p0.ctypes.data, b0.ctypes.data,
                len(c1), c1.ctypes.data, p1.ctypes.data, b1.ctypes.data)
        cand_ptr, cand_len = None, 0
        if candidates is not None:
            cand = np.ascontiguousarray(candidates, dtype=np.uint8)
            if cand.size != enum.count:
                raise ValueError("candidate bitmap size != vertex count")
            cand_ptr, cand_len = cand.ctypes.data, enum.count
        # the engine holds its own copies from here on
        del packed, c0, p0, b0, c1, p1, b1, char_bufs, op_bufs
        for c in range(n_chr):
            seq.chars[c] = None
            seq.origpos[c] = None
        progress_cb = None
        if progress is not None:
            progress_cb = PROGRESS_CFUNC(
                lambda p, st: progress(int(p), int(st)))
            lib.engine_set_progress(handle, progress_cb)
        errors: list[BaseException] = []

        def _reprefilter(cand_out, n_ids):
            if errors:
                return 0
            try:
                with timings.phase("reprefilter"):
                    bm = device_reprefilter(lib, handle, n_chr, k,
                                            min_branch, int(n_ids), device)
            except BaseException as e:  # re-raised after the sweep
                errors.append(e)
                return 0
            ctypes.memmove(cand_out, bm.ctypes.data, int(n_ids))
            return 1

        reprefilter_cb = None
        if os.environ.get("SIBELIA_TPU_WAVE_DEVICE") != "0":
            reprefilter_cb = REPREFILTER_CFUNC(_reprefilter)
            lib.engine_set_reprefilter(handle, reprefilter_cb)
        with timings.phase("engine_sweep"):
            if os.environ.get("SIBELIA_TPU_DENSE_SIMPLIFY") == "1":
                ret = lib.engine_simplify(handle, k, min_branch,
                                          max_iterations)
            else:
                ret = lib.engine_simplify_sparse(handle, k, min_branch,
                                                 max_iterations, cand_ptr,
                                                 cand_len)
        if errors:
            raise errors[0]
        record_sweep_stats(lib, handle)
        with timings.phase("engine_writeback"):
            for c in range(n_chr):
                ln = lib.engine_chr_len(handle, c)
                chars = np.empty(ln, dtype=np.uint8)
                op = np.empty(ln, dtype=np.int32)
                lib.engine_get_chr(handle, c, chars.ctypes.data,
                                   op.ctypes.data)
                seq.chars[c] = chars
                seq.origpos[c] = op
        return int(ret)
    finally:
        lib.engine_destroy(handle)
