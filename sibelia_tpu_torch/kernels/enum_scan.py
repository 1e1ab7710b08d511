"""Post-sort segment scan of the fused k <= 32 enumeration.

Replaces the three Pallas TPU kernels of ``sibelia_tpu/kernels/enum_scan.py``
(``_fwd_kernel``, ``_bwd_kernel``, ``_fin_kernel``, reached through the one
``pl.pallas_call`` in ``_grid_call``) with one hand-written CUDA C++ scan
for Hopper, ``csrc/enum_scan.cu``: three launches, reduce-then-scan over
tiles of ``TILE_ROWS`` rows, because blocks run in parallel where the TPU
grid ran in order.  It is memory-bound on the card: one read of the four
i32 columns and one write of the two is 24 bytes a row, and the kernel
moves 24.5 (the key columns are read once; two bits a row, packed, carry
the verdicts from the first pass to the last).  Columns whose base
pointers are not all 16-byte aligned (a slice at an odd offset) take
4-byte loads and stores in place of 16-byte ones.

``enum_segment_scan`` takes a CUDA tensor to the kernel and a CPU tensor
to ``enum_segment_scan_plain``, the XLA algebra of
``sibelia_tpu/index/enum_device.py::_enum_device_impl`` in torch ops.  The
kernel is built with nvcc at first use into ``kernels/build/`` (rebuilt
when the source is newer, ``kernels/nvcc.py``) and bound through a plain
C interface.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.platform import note_launch
from . import nvcc

TILE_ROWS = 4096  # rows of one block of the kernel (TILE in csrc/enum_scan.cu)


def build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the kernel library."""
    lib = nvcc.load("enum_scan")
    lib.enum_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.enum_scan_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.enum_scan_launch.restype = ctypes.c_int
    lib.enum_scan_launch.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    return lib


def enum_segment_scan_plain(sk1, sk2, saux, order, nv, n: int):
    """The post-sort pipeline in torch ops.  Inputs are the sorted int32
    columns (uint32 keys as bit views) and the valid-row count `nv` (int
    or 0-d tensor); `n` fills `poskey` where a row is not selected.
    Returns (ids i32[len], poskey i32[len], n_groups, n_sel)."""
    total = sk1.shape[0]
    dev = sk1.device
    i32 = torch.int32
    iota = torch.arange(total, dtype=i32, device=dev)
    isval = iota < nv
    start = torch.ones(total, dtype=torch.bool, device=dev)
    start[1:] = (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])
    # forced boundary at the first invalid row: at k == 32 a real all-T
    # window and the invalid-window sentinel share their sort keys
    start |= iota == nv
    prev_aux = torch.cat([saux[:1], saux[:-1]])
    A = ((~start) & (prev_aux != saux)).to(i32)
    B = (((saux >> 3) == 0) | ((saux & 7) == 0)).to(i32)
    ordinal = torch.cumsum(start.to(i32), 0, dtype=i32)
    seg_a = torch.cummax((ordinal << 1) | A, 0).values & 1
    seg_b = torch.cummax((ordinal << 1) | B, 0).values & 1
    is_end = torch.ones(total, dtype=torch.bool, device=dev)
    is_end[:-1] = start[1:]
    counted_end = torch.where(is_end, seg_b | (seg_a & (~start).to(i32)), 0)
    # broadcast each segment's end-row verdict back over its rows
    fkey = ((ordinal[-1] - ordinal.flip(0)) << 1) | counted_end.flip(0)
    counted = (torch.cummax(fkey, 0).values & 1).flip(0).to(torch.bool)
    id_cums = torch.cumsum((start & counted & isval).to(i32), 0, dtype=i32)
    sel = counted & isval
    poskey = torch.where(sel, order, n).to(i32)
    return id_cums - 1, poskey, id_cums[-1], sel.sum(dtype=i32)


def enum_segment_scan(sk1, sk2, saux, order, nv, n: int):
    """Same contract as enum_segment_scan_plain.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream."""
    if sk1.device.type == "cpu":
        return enum_segment_scan_plain(sk1, sk2, saux, order, nv, n)
    if sk1.device.type != "cuda":
        raise ValueError(f"enum_segment_scan: unsupported device {sk1.device}")
    total = sk1.shape[0]
    for t in (sk1, sk2, saux, order):
        if (t.device != sk1.device or t.dtype != torch.int32
                or t.shape != (total,) or not t.is_contiguous()):
            raise ValueError("enum_segment_scan: columns must be contiguous "
                             "int32[n] on one device")
    if not 0 < total < (1 << 30):
        raise ValueError(f"enum_segment_scan: {total} rows outside (0, 2^30)")
    nv_t = torch.as_tensor(nv, dtype=torch.int32, device=sk1.device)
    lib = build()
    ids = torch.empty_like(sk1)
    poskey = torch.empty_like(sk1)
    totals = torch.empty(2, dtype=torch.int32, device=sk1.device)
    scratch = torch.empty(lib.enum_scan_scratch_bytes(total),
                          dtype=torch.uint8, device=sk1.device)
    stream = torch.cuda.current_stream(sk1.device).cuda_stream
    err = lib.enum_scan_launch(
        sk1.data_ptr(), sk2.data_ptr(), saux.data_ptr(), order.data_ptr(),
        total, nv_t.data_ptr(), int(n), ids.data_ptr(), poskey.data_ptr(),
        totals.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"enum_scan_launch failed: CUDA error {err}")
    note_launch("enum_segment_scan")
    return ids, poskey, totals[0], totals[1]
