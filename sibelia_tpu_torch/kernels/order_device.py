"""Band DP of the LAGAN ``order`` stage on the port's device.

Twin of ``sibelia_tpu/kernels/order_device.py``.  The anchored global
aligner is a 3-state (M/N/O) integer DP over an irregular anti-diagonal
band (squares between anchors, width-15 barrels along them; reference:
src/lagan/src/order.c:271-382,609-705 with the limited-memory diagonal
matrix of diagmatrix.c).  A cell depends on the two previous diagonals
only, so the DP is a chain of ``nd - 1`` diagonals of ``wmax`` lanes each.
The JAX package runs that chain as a ``lax.scan`` (``_make_run``, lines
80-174, the scan at 171); here it is one hand-written CUDA C++ kernel,
``csrc/order_band.cu::k_order_band``: a block a pair, the diagonal loop
inside the kernel, the previous diagonals in shared memory, one uint8
pointer a lane a diagonal written to device memory.  It is bound by the
latency of the longest pair's chain, not by bytes or operations.

Split of labour, as in the JAX package: band construction (shapes, necks)
and the pointer-walk traceback stay in the native library
(``le_order_prepare`` .. ``le_order_finish``), the O(band area) recurrence
runs on the device.  What the JAX package pads for XLA's sake (diagonals to
a multiple of 4096, one dispatch a padded shape) is not padded here: the
kernel takes ragged ``nd`` and one launch serves every pair of a batch that
shares ``wmax`` (block size and shared memory are set a launch).  ``wmax``
and the budget gate are computed as there, so that the same pairs go to the
host (``STATS``).

``band_rows`` takes CUDA tensors to the kernel and CPU tensors to
``order_band_rows_plain``, the same int32 algebra step by step in torch
ops, batched over the pairs; ``order_band_rows`` packs a list of jobs,
moves them to the device and brings the pointer rows back through one
pinned buffer a batch.  Only lanes inside the band are part of the
contract: ``le_order_finish`` reads no other.

Semantics replicated exactly:
  * substitution scores and the ``.`` contig-break char exemptions
    (lagan_common.h: nucmatrix values; order.c gap -400/-25);
  * the host DP's tie preferences and pointer nibble layout
    (order.c:609-705);
  * neck renormalization including its use of the already-updated M in
    the N/O clamps when the normalizer is non-positive
    (diagmatrix.c:268-293).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import timings
from ..core.platform import note_launch
from ..native import _take_string, load_lagan
from . import nvcc
from .gotoh import _pinned

GAP_START = -400  # order.c kGapstart
GAP_CONT = -25    # order.c kGapcont
DUMMY = np.int32(-(2 << 30) + (1 << 28))  # INT_MIN + (1 << 28)
_ROWS_BUDGET_BYTES = 256 << 20  # pointer-row buffer cap per pair
BATCH_ROW_BYTES = 256 << 20     # pointer rows of one batch on the device
N_PARAMS = 9  # size, o_dd, o_up, o_lf, x0, y0, isneck, sp1, sp2
# int64 columns of the per-pair table the kernel and the plain version read
(T_S1, T_N1, T_S2, T_N2, T_PARAMS, T_DIAGS, T_INIT, T_ROWS, T_WMAX,
 N_TABLE) = range(10)

# char codes: 0 other/NUL, 1..4 ACGT, 5 '.', 6 N, 7 '-'
_CODE = np.zeros(256, np.uint8)
for _ch, _cd in ((65, 1), (67, 2), (71, 3), (84, 4), (46, 5), (78, 6),
                 (45, 7)):
    _CODE[_ch] = _cd
_CB_CODE = 5  # iscb(c) <=> c == '.'

_SM = np.zeros((8, 8), np.int32)
_SYM = [1, 2, 3, 4, 5, 6]  # A C G T . N
_VAL = [
    [91, -114, -31, -123, 0, -43],
    [-114, 100, -125, -31, 0, -43],
    [-31, -125, 100, -114, 0, -43],
    [-123, -31, -114, 91, 0, -43],
    [0, 0, 0, 0, 0, 0],
    [-43, -43, -43, -43, 0, -43],
]
for _i, _a in enumerate(_SYM):
    for _j, _b in enumerate(_SYM):
        _SM[_a, _b] = _VAL[_i][_j]


# device-coverage accounting: device_jobs = band DPs sent to the device
# path, host_fallback = pairs the traceback-budget/band gate sent to the
# host engine.  Read via get_stats(); the variant caller logs it under
# SIBELIA_TPU_TRACE=1 and the C-Sibelia CLI dumps it with its timings.
STATS = {"device_jobs": 0, "host_fallback": 0}
# bytes of pointer rows the batches of this process brought back
ROW_BYTES = [0]


def get_stats() -> dict:
    return dict(STATS)


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


class _Job:
    __slots__ = ("handle", "nd", "wmax", "params", "init", "s1c", "s2c")


def _prepare_job(lib, seq1: bytes, seq2: bytes, anchors_text: str,
                 max_band_width: int) -> _Job | None:
    """The band of one pair from the native library: per diagonal 2..nd
    the nine ints of ``params`` (int32 [nd - 1, 9]), the three init rows of
    diagonal 1 and both sequences' codes (uint8).  None, with the handle
    released, when the band goes to the host engine."""
    h = lib.le_order_prepare(seq1, len(seq1), seq2, len(seq2),
                             anchors_text.encode("latin-1"))
    dims = (ctypes.c_longlong * 4)()
    lib.le_order_dims(h, dims)
    d1, d2, nd, maxw = (int(dims[0]), int(dims[1]), int(dims[2]),
                        int(dims[3]))
    # gate on the pointer-row buffer as the JAX package sizes it (its
    # diagonals padded to 4096), not just the band width, so that the same
    # pairs stay on the device
    wmax = 1 << max(4, int(maxw - 1).bit_length())
    ndp = _bucket(nd - 1, 4096) if nd > 1 else 0
    if (maxw > max_band_width or nd < 2
            or wmax * ndp > _ROWS_BUDGET_BYTES):
        lib.le_order_release(h)
        STATS["host_fallback"] += 1
        return None
    STATS["device_jobs"] += 1
    starts = np.empty(nd, np.int32)
    ends = np.empty(nd, np.int32)
    isneck = np.empty(nd, np.int32)
    lib.le_order_band(h, starts.ctypes.data, ends.ctypes.data,
                      isneck.ctypes.data)
    n1, n2 = d1 - 1, d2 - 1
    s1buf = np.empty(n1 + 17, np.uint8)
    s2buf = np.empty(n2 + 17, np.uint8)
    lib.le_order_seq(h, 1, s1buf.ctypes.data)
    lib.le_order_seq(h, 2, s2buf.ctypes.data)

    size = ends - starts + 1
    diag = np.arange(1, nd + 1)
    below = diag < d2
    x0 = np.where(below, starts + 1, diag - d2 + starts + 1)
    y0 = np.where(below, diag - starts, d2 - starts)

    # constant per-diagonal offsets of the three neighbors' lane indices
    # (elem spaces differ below/at-or-above the d2 corner)
    def starts_at(dg):
        return np.where((dg >= 1) & (dg <= nd),
                        starts[np.clip(dg, 1, nd) - 1], 0)

    def size_at(dg):
        return np.where((dg >= 1) & (dg <= nd),
                        size[np.clip(dg, 1, nd) - 1], 0)

    dg2, dg1 = diag - 2, diag - 1
    e_dd = np.where(dg2 < d2, x0 - 2, d2 - y0 + 1)
    e_up = np.where(dg1 < d2, x0 - 2, d2 - y0)
    e_lf = np.where(dg1 < d2, x0 - 1, d2 - y0 + 1)

    job = _Job()
    job.handle = h
    job.nd = nd
    job.wmax = wmax
    cols = np.stack([size, e_dd - starts_at(dg2), e_up - starts_at(dg1),
                     e_lf - starts_at(dg1), x0, y0, isneck,
                     size_at(dg1), size_at(dg2)], axis=1)
    # the DP runs diagonals 2..nd
    job.params = np.ascontiguousarray(cols[1:], dtype=np.int32)

    # diagonal-1 init: cell 0 = (0, GAP_START, GAP_START), the rest of
    # the band zeros (the host ring is calloc'd), pad dummy
    lane = np.arange(wmax)
    init = np.empty((3, wmax), np.int32)
    init[:] = np.where(lane < size[0], 0, DUMMY)
    init[1:, 0] = GAP_START
    job.init = init
    job.s1c = _CODE[s1buf]
    job.s2c = _CODE[s2buf]
    return job


def _finish(lib, job: _Job, rows: np.ndarray, name1: str,
            name2: str) -> str:
    ptrs = np.zeros((job.nd, job.wmax), np.uint8)
    ptrs[1:] = rows[:job.nd - 1]
    out = lib.le_order_finish(job.handle, name1.encode("latin-1"),
                              name2.encode("latin-1"), ptrs.ctypes.data,
                              job.wmax)
    return _take_string(lib, out)


# -- the band DP: packing, plain version, kernel wrapper ---------------------

def pack_jobs(jobs: list[_Job]) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray]:
    """(codes uint8[*], params int32[*, 9], init int32[*], table int64
    [B, N_TABLE]): the jobs' arrays end to end, in the order given, and
    where each pair's lie.  Pointer rows are laid out in the same order,
    ``(nd - 1) * wmax`` bytes a pair from ``table[:, T_ROWS]``."""
    table = np.zeros((len(jobs), N_TABLE), np.int64)
    at_code = at_diag = at_init = at_rows = 0
    for b, job in enumerate(jobs):
        n1, n2, diags = len(job.s1c), len(job.s2c), job.nd - 1
        table[b] = (at_code, n1, at_code + n1, n2, at_diag, diags, at_init,
                    at_rows, job.wmax)
        at_code += n1 + n2
        at_diag += diags
        at_init += 3 * job.wmax
        at_rows += diags * job.wmax
    codes = np.concatenate([a for job in jobs for a in (job.s1c, job.s2c)])
    params = np.concatenate([job.params for job in jobs])
    init = np.concatenate([job.init.reshape(-1) for job in jobs])
    return codes, params, init, table


def sub_table(table: np.ndarray, keep) -> np.ndarray:
    """The table of the pairs `keep` alone, over the same packed arrays:
    their pointer rows laid out end to end anew."""
    sub = np.ascontiguousarray(table[keep])
    size = sub[:, T_DIAGS] * sub[:, T_WMAX]
    sub[:, T_ROWS] = np.cumsum(size) - size
    return sub


def rows_bytes(table: np.ndarray) -> int:
    """Bytes of the pointer rows of a packed batch."""
    return int((table[:, T_DIAGS] * table[:, T_WMAX]).sum())


def order_band_rows_plain(codes: torch.Tensor, params: torch.Tensor,
                          init: torch.Tensor, table: np.ndarray
                          ) -> torch.Tensor:
    """The kernel's function in torch ops: uint8 [rows_bytes(table)], each
    pair's pointer rows [nd - 1, wmax] end to end.  The algebra of
    ``sibelia_tpu/kernels/order_device.py::_make_run`` step by step in
    int32, a Python loop over the diagonals, the pairs as a leading batch
    axis: a pair narrower than the widest is padded with lanes outside its
    band, a pair with fewer diagonals with empty diagonals."""
    dev = codes.device
    i32 = torch.int32
    B = table.shape[0]
    out = torch.empty(rows_bytes(table), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    W = int(table[:, T_WMAX].max())
    D = int(table[:, T_DIAGS].max())
    dummy = int(DUMMY)
    sm_flat = torch.from_numpy(_SM.reshape(-1)).to(dev)
    j = torch.arange(W, dtype=i32, device=dev)[None, :]
    # per pair: params padded with empty diagonals, init rows with dummies
    par = torch.zeros((B, D, N_PARAMS), dtype=i32, device=dev)
    cur = torch.full((B, 3, W), dummy, dtype=i32, device=dev)
    for b in range(B):
        lo, n, w = (int(table[b, c]) for c in (T_PARAMS, T_DIAGS, T_WMAX))
        par[b, :n] = params[lo:lo + n]
        at = int(table[b, T_INIT])
        cur[b, :, :w] = init[at:at + 3 * w].view(3, w)
    tab = torch.from_numpy(table).to(dev)
    s1_at, n1 = tab[:, T_S1, None], tab[:, T_N1, None]
    s2_at, n2 = tab[:, T_S2, None], tab[:, T_N2, None]
    codes_l = codes.long()
    rows = torch.empty((B, D, W), dtype=torch.uint8, device=dev)
    p1 = cur
    p2 = torch.full((B, 3, W), dummy, dtype=i32, device=dev)

    def neighbor(arr, off, sp):  # arr [B, C, W]; off, sp [B, 1]
        idx = j + off
        ok = (idx >= 0) & (idx < sp)
        got = arr.gather(2, idx.clamp(0, W - 1).long()[:, None, :]
                         .expand(-1, arr.shape[1], -1))
        return torch.where(ok[:, None, :], got, dummy)

    def renorm(x, norm, mask):  # x [B, 3, W]; norm [B, 1]; mask [B, W]
        pos = norm > 0
        m, n_, o = x[:, 0], x[:, 1], x[:, 2]
        t = m - norm
        m2 = torch.where(pos, torch.minimum(m, t), torch.maximum(m, t))
        tn = n_ - norm
        n2_ = torch.where(pos, torch.minimum(n_, tn), torch.maximum(m2, tn))
        to = o - norm
        o2 = torch.where(pos, torch.minimum(o, to), torch.maximum(m2, to))
        return torch.where(mask[:, None, :], torch.stack([m2, n2_, o2], 1), x)

    for t in range(D):
        row = par[:, t]
        size, o_dd, o_up, o_lf, x0, y0, isneck, sp1, sp2 = (
            row[:, c, None] for c in range(N_PARAMS))
        inband = j < size
        dd = neighbor(p2, o_dd, sp2)
        dm, dn_, do_ = dd[:, 0], dd[:, 1], dd[:, 2]
        un = neighbor(p1[:, 1:2], o_up, sp1)[:, 0]
        lo_ = neighbor(p1[:, 2:3], o_lf, sp1)[:, 0]
        c1 = codes_l[s1_at + (x0 - 1 + j).long().clamp(min=0)
                     .minimum(n1 - 1)]
        c2 = codes_l[s2_at + (y0 - 1 - j).long().clamp(min=0)
                     .minimum(n2 - 1)]
        cb1 = c1 == _CB_CODE
        cb2 = c2 == _CB_CODE
        g_cont1 = torch.where(cb1, 0, GAP_CONT).to(i32)
        g_cont2 = torch.where(cb2, 0, GAP_CONT).to(i32)
        s1v = dm
        s2v = dn_ + g_cont2
        s3v = do_ + g_cont1
        best = torch.where(s1v >= s2v,
                           torch.where(s1v >= s3v, s1v, s3v),
                           torch.where(s2v >= s3v, s2v, s3v))
        cm = sm_flat[c1 * 8 + c2] + best
        t1 = cm + torch.where(cb2, 0, GAP_START).to(i32)
        t2 = un + g_cont2
        takes_n = t1 >= t2
        cn = torch.where(takes_n, t1, t2)
        u1 = cm + torch.where(cb1, 0, GAP_START).to(i32)
        u2 = lo_ + g_cont1
        takes_o = u1 >= u2
        co = torch.where(takes_o, u1, u2)
        ptr = (torch.where(takes_n, 0, 4) | torch.where(takes_o, 0, 8)
               | torch.where(cm >= cn, torch.where(cm < co, 2, 0),
                             torch.where(cn >= co, 1, 2)))
        rows[:, t] = ptr.to(torch.uint8)
        cur = torch.where(inband[:, None, :], torch.stack([cm, cn, co], 1),
                          dummy)
        neck = isneck == 1
        if bool(neck.any()):
            norm = torch.where(inband, cur[:, 0], dummy).max(1, keepdim=True
                                                             ).values
            cur = torch.where(neck[:, :, None],
                              renorm(cur, norm, inband), cur)
            p1 = torch.where(neck[:, :, None],
                             renorm(p1, norm, j < sp1), p1)
        p1, p2 = cur, p1
    for b in range(B):
        lo, n, w = (int(table[b, c]) for c in (T_ROWS, T_DIAGS, T_WMAX))
        out[lo:lo + n * w] = rows[b, :n, :w].reshape(-1)
    return out


def build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the kernel library."""
    lib = nvcc.load("order_band")
    lib.order_band_launch.restype = ctypes.c_int
    lib.order_band_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    return lib


_SM_DEVICE: dict[torch.device, torch.Tensor] = {}


def _check(who: str, codes, params, init, table: np.ndarray) -> None:
    dev = codes.device
    for t, dtype in ((codes, torch.uint8), (params, torch.int32),
                     (init, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{who}: codes uint8, params and init int32, "
                             "contiguous, on one device")
    if (table.dtype != np.int64 or table.ndim != 2
            or table.shape[1] != N_TABLE or params.ndim != 2
            or params.shape[1] != N_PARAMS
            or (table.shape[0] and params.shape[0]
                < (table[:, T_PARAMS] + table[:, T_DIAGS]).max())):
        raise ValueError(f"{who}: table must be int64 [B, {N_TABLE}] into "
                         "params [*, 9]")
    w = table[:, T_WMAX]
    if table.shape[0] and (((w & (w - 1)) != 0).any() or w.min() < 16
                           or w.max() > 8192
                           or table[:, T_DIAGS].min() < 1):
        raise ValueError(f"{who}: wmax must be a power of two in 16..8192 "
                         "and every pair have a diagonal")


def band_rows(codes: torch.Tensor, params: torch.Tensor, init: torch.Tensor,
              table: np.ndarray) -> torch.Tensor:
    """Same contract as order_band_rows_plain, inside the band.  CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, once for every ``wmax`` among the pairs."""
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band_rows: unsupported device {codes.device}")
    _check("band_rows", codes, params, init, table)
    if codes.device.type == "cpu":
        return order_band_rows_plain(codes, params, init, table)
    dev = codes.device
    lib = build()
    if dev not in _SM_DEVICE:
        _SM_DEVICE[dev] = torch.from_numpy(_SM.reshape(-1).copy()).to(dev)
    out = torch.empty(rows_bytes(table), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for wmax in np.unique(table[:, T_WMAX]).tolist():
        # the class's pairs, the longest chain first
        sel = table[table[:, T_WMAX] == wmax]
        sel = np.ascontiguousarray(sel[np.argsort(-sel[:, T_DIAGS],
                                                  kind="stable")])
        tab = torch.from_numpy(sel).to(dev)
        err = lib.order_band_launch(
            codes.data_ptr(), params.data_ptr(), init.data_ptr(),
            tab.data_ptr(), _SM_DEVICE[dev].data_ptr(), sel.shape[0],
            int(wmax), GAP_START, GAP_CONT, int(DUMMY), _CB_CODE,
            out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"order_band_launch failed: CUDA error {err}")
        note_launch("order_band")
    return out


def order_band_rows(jobs: list[_Job], device: torch.device
                    ) -> list[np.ndarray]:
    """The pointer rows uint8 [nd - 1, wmax] of each job.  On a card: the
    jobs go up in batches of at most BATCH_ROW_BYTES of rows (one pair
    alone may hold as much), each batch's rows come down in one copy into
    a pinned buffer."""
    out: list[np.ndarray] = []
    at = 0
    while at < len(jobs):
        end, size = at, 0
        while end < len(jobs) and (end == at or size + (jobs[end].nd - 1)
                                   * jobs[end].wmax <= BATCH_ROW_BYTES):
            size += (jobs[end].nd - 1) * jobs[end].wmax
            end += 1
        codes, params, init, table = pack_jobs(jobs[at:end])
        args = [torch.from_numpy(a).to(device) for a in (codes, params, init)]
        rows = band_rows(*args, table)
        if device.type == "cuda":
            host = _pinned("order_rows", rows.numel())
            host.copy_(rows, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
            rows = host
        ROW_BYTES[0] += rows.numel()
        # a copy: the pinned buffer serves the next batch
        flat = rows.numpy().copy() if device.type == "cuda" else rows.numpy()
        for b, job in enumerate(jobs[at:end]):
            lo = int(table[b, T_ROWS])
            out.append(flat[lo:lo + (job.nd - 1) * job.wmax]
                       .reshape(job.nd - 1, job.wmax))
        at = end
    return out


def order_mfa_device(seq1: bytes, name1: str, seq2: bytes, name2: str,
                     anchors_text: str, device: torch.device,
                     max_band_width: int = 8192) -> str | None:
    """Device twin of native lagan_order: same -mfa text, or None when
    the band is too wide for the padded layout (caller falls back to the
    host DP)."""
    return order_mfa_device_batch(
        [(seq1, name1, seq2, name2, anchors_text)], device,
        max_band_width)[0]


def order_mfa_device_batch(jobs: list[tuple[bytes, str, bytes, str, str]],
                           device: torch.device,
                           max_band_width: int = 8192) -> list[str | None]:
    """Batched device order: jobs = [(seq1, name1, seq2, name2,
    anchors_text)].  Every pair's band DP runs in one call of
    order_band_rows; a None result marks a pair that needs the host
    fallback."""
    lib = load_lagan()
    prepared: list[_Job | None] = []
    results: list[str | None] = [None] * len(jobs)
    try:
        with timings.phase("order_prepare"):
            for s1, _n1, s2, _n2, anch in jobs:
                prepared.append(_prepare_job(lib, s1, s2, anch,
                                             max_band_width))
        idxs = [i for i, job in enumerate(prepared) if job is not None]
        with timings.phase("order_device"):
            rows = order_band_rows([prepared[i] for i in idxs], device)
        with timings.phase("order_finish"):
            for i, r in zip(idxs, rows):
                results[i] = _finish(lib, prepared[i], r, jobs[i][1],
                                     jobs[i][3])
    finally:
        for job in prepared:
            if job is not None:
                lib.le_order_release(job.handle)
    return results
