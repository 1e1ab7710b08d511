"""Runs the native C++ simplification engine (``engine.cpp``) with the port's
device re-prefilter installed (twin of
``sibelia_tpu/native/__init__.py::simplify_native`` and
``_device_reprefilter``).

The engine calls the re-prefilter at the start of a stage that has no
candidate bitmap and mid-sweep when many ids are flagged; the port's
callback runs ``candidate_scan`` on the run's device.  An exception in the
callback cannot unwind through the C++ frames, so the callback stashes it
and returns 0, and ``simplify`` re-raises it once the sweep returns: a
failing kernel fails the run.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import timings
from ..core.convert import to_numpy, to_tensor
from ..core.platform import note_sync
from ..index.enum_device import candidate_scan
from ..index.enumeration import build_supergenome
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
    B = max(m, n_ids)
    pos_p = np.full(B, n, dtype=np.int64)
    ids_p = np.full(B, B, dtype=np.int64)
    pos_p[:m] = block_starts[block] + local
    ids_p[:m] = bif
    pos_d, perm = torch.sort(to_tensor(pos_p, device))
    ids_d = to_tensor(ids_p, device)[perm]
    note_sync("reprefilter_upload", 3)
    cand = candidate_scan(to_tensor(codes, device), pos_d, ids_d, k,
                          min_branch, m)
    note_sync("reprefilter_fetch")
    return to_numpy(cand[:n_ids]).astype(np.uint8)


def simplify(seq, enum, k: int, min_branch: int, max_iterations: int,
             device: torch.device, candidates: np.ndarray | None = None,
             release_enum: bool = False, progress=None) -> int:
    """Run one simplification stage in the native engine (its sparse
    sweep).  `seq` is a MutableSequence, mutated in place; `enum` a
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
                bm = device_reprefilter(lib, handle, n_chr, k, min_branch,
                                        int(n_ids), device)
            except BaseException as e:  # re-raised after the sweep
                errors.append(e)
                return 0
            ctypes.memmove(cand_out, bm.ctypes.data, int(n_ids))
            return 1

        reprefilter_cb = REPREFILTER_CFUNC(_reprefilter)
        lib.engine_set_reprefilter(handle, reprefilter_cb)
        with timings.phase("engine_sweep"):
            ret = lib.engine_simplify_sparse(handle, k, min_branch,
                                             max_iterations, cand_ptr,
                                             cand_len)
        if errors:
            raise errors[0]
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
