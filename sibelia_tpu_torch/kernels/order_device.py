"""Band DP of the LAGAN ``order`` stage, and its traceback, on the port's
device.

Twin of ``sibelia_tpu/kernels/order_device.py``.  The anchored global
aligner is a 3-state (M/N/O) integer DP over an irregular anti-diagonal
band (squares between anchors, width-15 barrels along them; reference:
src/lagan/src/order.c:271-382,609-705 with the limited-memory diagonal
matrix of diagmatrix.c).  A cell depends on the two previous diagonals
only, so the DP is a chain of ``nd - 1`` diagonals of ``wmax`` lanes each.
The JAX package runs that chain as a ``lax.scan`` (``_make_run``, lines
80-174, the scan at 171) and walks the pointers back in its native library.
Here hand-written CUDA C++ kernels of ``csrc/order_band.cu`` do the work
on the card:

* ``k_band_params`` makes the nine ``params`` columns of every diagonal
  from the band's three (starts, ends, isneck), so that 12 and not 36 bytes
  a diagonal go up and no numpy pass runs on the host;
* ``k_order_band_warp`` (``wmax`` <= 32, every pair of a real run): a warp a
  pair runs the chain, the two previous diagonals in registers, the
  neighbour reads as shuffles, no barrier in the diagonal loop; a second
  warp packs whatever a step needs besides the band's values into one word
  a lane a diagonal, a tile ahead.  Above 32 lanes ``k_band_words`` makes
  those words for every diagonal on the whole card first, and a block a
  pair runs the chain alone: ``k_order_band_reg`` up to 4096 lanes (a warp
  up to 256), 2 to 8 adjacent lanes a thread in registers, the neighbours
  by shuffles and, across warps, shared memory; ``k_order_band`` at 8192,
  the band in shared memory.  Only lanes inside the band are computed.  One uint8
  pointer a lane a diagonal goes to device memory and stays there;
* the walk of ``order_finish_mfa`` from (d1, d2) back to an edge; one
  move byte a step comes down (at most ``nd`` bytes a pair).  Up to 32
  lanes it runs in segments of ``WALK_SEGMENT_ROWS`` rows side by side:
  ``k_walk_tables`` walks every way into every segment (128 entry codes)
  to where it leaves, ``k_walk_compose`` chains each pair's segments from
  the top, ``k_walk_replay`` walks each segment from its true entry and
  writes its moves (``order_moves_segments_plain`` is the algebra on the
  host).  Above 32 lanes ``k_order_moves_wide``, a warp a pair over
  windows of a slice of the rows around the walk's lane.

None is bound by bytes or operations: the DP and the wide walk by the
longest pair's chain of dependent steps, the narrow walk by a segment's,
the wide DP's step by the latency of its instructions on the one SM that
does all of a pair's lanes.

Split of labour: band construction (shapes, necks) stays in the native
library (``le_order_prepare``), the ``-mfa`` text is made here from the
moves (``mfa_text``: ``print_mfa_row``'s rule in numpy).  What the JAX
package pads for XLA's sake (diagonals to a multiple of 4096, one dispatch
a padded shape) is not padded here: the kernels take ragged ``nd`` and one
launch serves every pair of a batch that shares ``wmax``.  ``wmax`` and the
budget gate are computed as there, so that the same pairs go to the host
(``STATS``).

Each kernel's wrapper (``band_params``, ``band_rows``, ``band_moves``)
takes CUDA tensors to the kernel and CPU tensors to its plain version
(``band_params_plain``, ``order_band_rows_plain``: the same int32 algebra
step by step in torch ops, batched over the pairs; ``order_moves_plain``:
the same walk step by step).  ``order_moves`` packs a list of jobs, moves
them to the device in batches (on the CPU at most ``BATCH_ROW_BYTES`` of
pointer rows; on a card as many pairs as half of what it can give holds,
up to ``BATCH_DIAGONALS``, so that wide pairs run side by side) and brings
the moves back through one pinned buffer a batch.
``order_mfa_device_batch`` with a ``mesh`` (``parallel/sharded.py``; under
``SIBELIA_TPU_SHARDED=N`` by default, as in the JAX package) cuts the
jobs into one contiguous slice a shard, and each shard runs
``order_moves`` on its slice on its device: pairs are independent, so
the text is the unsharded call's, byte for byte.  Only
lanes inside the band are part of the rows' contract: the walk reads no
other.

Semantics replicated exactly:
  * substitution scores and the ``.`` contig-break char exemptions
    (lagan_common.h: nucmatrix values; order.c gap -400/-25);
  * the host DP's tie preferences and pointer nibble layout
    (order.c:609-705);
  * neck renormalization including its use of the already-updated M in
    the N/O clamps when the normalizer is non-positive
    (diagmatrix.c:268-293);
  * getChain's walk with its run continuation bits and its stop off the
    band (order.c:485-556), and printMFAAlign's rows (order.c:776-800).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import timings
from ..core.convert import download
from ..core.platform import card_free_bytes, note_launch
from ..native import load_lagan
from ..parallel.sharded import Mesh, requested_mesh
from . import nvcc

GAP_START = -400  # order.c kGapstart
GAP_CONT = -25    # order.c kGapcont
DUMMY = np.int32(-(2 << 30) + (1 << 28))  # INT_MIN + (1 << 28)
_ROWS_BUDGET_BYTES = 256 << 20  # pointer-row buffer cap per pair
BATCH_ROW_BYTES = 256 << 20     # pointer rows of one batch on the CPU
# a batch's bytes on the card a diagonal besides its pointer rows: params
# (36), band (12), moves (1); and above 32 lanes the band DP's words, two
# bytes a lane
CARD_BYTES_A_DIAGONAL = 49
# diagonals of one batch on a card: what the host stages (about 13 B a
# diagonal) stays that of BATCH_ROW_BYTES of 32-lane pairs, about 100 MB
BATCH_DIAGONALS = BATCH_ROW_BYTES // 32
N_PARAMS = 9  # size, o_dd, o_up, o_lf, x0, y0, isneck, sp1, sp2
# the narrow walk (wmax <= 32) in segments of this many rows, walked side
# by side: 128 entry codes a segment, WALK_STOP once the walk has ended
WALK_SEGMENT_ROWS = 1024
WALK_ENTRIES = 128
WALK_STOP = 255
# int64 columns of the per-pair table the kernel and the plain version read
(T_S1, T_N1, T_S2, T_N2, T_PARAMS, T_DIAGS, T_INIT, T_ROWS, T_WMAX,
 T_MOVES, T_PAIR, T_BAND, T_DIAG1, N_TABLE) = range(14)
_SEQ_PAD = 16  # a mapped sequence is numlets + 17 codes, and d = numlets + 1

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
# host engine.  Read via get_stats(); each is also a counter of
# core/timings (order_device_jobs, order_host_fallback), which the C-Sibelia
# CLI dumps.
STATS = {"device_jobs": 0, "host_fallback": 0}
# bytes the batches of this process brought back from the device: the
# moves and their counts (pointer rows stay there); the counter
# order_row_bytes of core/timings
ROW_BYTES = [0]


def get_stats() -> dict:
    return dict(STATS)


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


class _Job:
    """One pair's band: ``band`` int32 [3, nd] (starts, ends, isneck of
    diagonals 1..nd), ``init`` the three rows of diagonal 1, both mapped
    sequences (``s1lets``: bytes as the native library maps them, ``s1c``:
    their codes), and ``params``, made from the band when first read."""
    __slots__ = ("handle", "nd", "wmax", "d2", "band", "init", "s1c", "s2c",
                 "s1lets", "s2lets", "_params")

    @property
    def params(self) -> np.ndarray:
        if self._params is None:
            self._params = _params_of(self.band, self.d2)
        return self._params


def _params_of(band: np.ndarray, d2: int) -> np.ndarray:
    """int32 [nd - 1, 9]: per diagonal 2..nd the nine ints the DP reads
    (size, the three neighbours' lane offsets, x0, y0, isneck, the sizes of
    the two diagonals before), from starts, ends, isneck of diagonals
    1..nd."""
    starts, ends, isneck = band
    nd = starts.shape[0]
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
    cols = np.stack([size, e_dd - starts_at(dg2), e_up - starts_at(dg1),
                     e_lf - starts_at(dg1), x0, y0, isneck,
                     size_at(dg1), size_at(dg2)], axis=1)
    # the DP runs diagonals 2..nd
    return np.ascontiguousarray(cols[1:], dtype=np.int32)


def _prepare_job(lib, seq1: bytes, seq2: bytes, anchors_text: str,
                 max_band_width: int) -> _Job | None:
    """The band of one pair from the native library.  None, with the handle
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
        timings.add("order_host_fallback", 1)
        return None
    STATS["device_jobs"] += 1
    timings.add("order_device_jobs", 1)
    band = np.empty((3, nd), np.int32)
    lib.le_order_band(h, band[0].ctypes.data, band[1].ctypes.data,
                      band[2].ctypes.data)
    n1, n2 = d1 - 1, d2 - 1
    s1buf = np.empty(n1 + 17, np.uint8)
    s2buf = np.empty(n2 + 17, np.uint8)
    lib.le_order_seq(h, 1, s1buf.ctypes.data)
    lib.le_order_seq(h, 2, s2buf.ctypes.data)

    job = _Job()
    job.handle = h
    job.nd = nd
    job.wmax = wmax
    job.d2 = d2
    job.band = band
    job._params = None
    # diagonal-1 init: cell 0 = (0, GAP_START, GAP_START), the rest of
    # the band zeros (the host ring is calloc'd), pad dummy
    lane = np.arange(wmax)
    init = np.empty((3, wmax), np.int32)
    init[:] = np.where(lane < band[1, 0] - band[0, 0] + 1, 0, DUMMY)
    init[1:, 0] = GAP_START
    job.init = init
    job.s1lets, job.s2lets = s1buf, s2buf
    job.s1c = _CODE[s1buf]
    job.s2c = _CODE[s2buf]
    return job


def _mfa_row(lets: np.ndarray, moves: np.ndarray, skip: int) -> bytes:
    """printMFAAlign's row loop (order.c:776-800): column 0 skipped, the
    sequence from lets[1] on with '-' at the skipped move, 60 columns a
    line."""
    m = moves[1:]
    n = m.shape[0]
    if n == 0:
        return b""
    emit = m != skip
    chars = np.where(emit, lets[np.cumsum(emit)], np.uint8(ord("-")))
    lines = -(-n // 60)
    out = np.full(n + lines, 10, np.uint8)
    at = np.arange(n)
    out[at + at // 60] = chars
    return out.tobytes()


def mfa_text(job: _Job, moves: np.ndarray, name1: str, name2: str) -> str:
    """The -mfa text of native lagan_order from the walk's moves (in
    alignment order; 2 skips a base of seq2, 3 one of seq1)."""
    return (b">" + name1.encode("latin-1") + b"\n"
            + _mfa_row(job.s1lets, moves, 3)
            + b">" + name2.encode("latin-1") + b"\n"
            + _mfa_row(job.s2lets, moves, 2)).decode("latin-1")


# -- packing ------------------------------------------------------------------

def _table(jobs: list[_Job]) -> np.ndarray:
    """int64 [B, N_TABLE]: where each pair's arrays lie in the packed
    ones, in the order given.  Pointer rows take ``(nd - 1) * wmax`` bytes
    a pair from ``T_ROWS``, moves ``nd`` bytes from ``T_MOVES``, the band
    ``3 * nd`` ints from ``T_BAND``; ``T_DIAG1`` says whether diagonal 1's
    only cell lies inside its band."""
    table = np.zeros((len(jobs), N_TABLE), np.int64)
    at_code = at_diag = at_init = at_rows = at_moves = 0
    for b, job in enumerate(jobs):
        n1, n2, diags = len(job.s1c), len(job.s2c), job.nd - 1
        table[b] = (at_code, n1, at_code + n1, n2, at_diag, diags, at_init,
                    at_rows, job.wmax, at_moves, b, 3 * at_moves,
                    int(job.band[0, 0] <= 0 <= job.band[1, 0]))
        at_code += n1 + n2
        at_diag += diags
        at_init += 3 * job.wmax
        at_rows += diags * job.wmax
        at_moves += job.nd
    return table


def pack_bands(jobs: list[_Job]) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(codes uint8[*], band int32[*], init int32[*], table): the jobs'
    arrays end to end, the band as (starts, ends, isneck) a pair."""
    codes = np.concatenate([a for job in jobs for a in (job.s1c, job.s2c)])
    band = np.concatenate([job.band.reshape(-1) for job in jobs])
    init = np.concatenate([job.init.reshape(-1) for job in jobs])
    return codes, band, init, _table(jobs)


def pack_jobs(jobs: list[_Job]) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray]:
    """(codes uint8[*], params int32[*, 9], init int32[*], table): as
    pack_bands, with each pair's params (made on the host) in place of its
    band."""
    codes, _, init, table = pack_bands(jobs)
    params = np.concatenate([job.params for job in jobs])
    return codes, params, init, table


def sub_table(table: np.ndarray, keep) -> np.ndarray:
    """The table of the pairs `keep` alone, over the same packed arrays:
    their pointer rows and moves laid out end to end anew."""
    sub = np.ascontiguousarray(table[keep])
    size = sub[:, T_DIAGS] * sub[:, T_WMAX]
    sub[:, T_ROWS] = np.cumsum(size) - size
    sub[:, T_MOVES] = np.cumsum(sub[:, T_DIAGS] + 1) - sub[:, T_DIAGS] - 1
    sub[:, T_PAIR] = np.arange(sub.shape[0])
    return sub


def rows_bytes(table: np.ndarray) -> int:
    """Bytes of the pointer rows of a packed batch."""
    return int((table[:, T_DIAGS] * table[:, T_WMAX]).sum())


def moves_bytes(table: np.ndarray) -> int:
    """Bytes of the moves buffer of a packed batch: nd a pair."""
    return int((table[:, T_DIAGS] + 1).sum())


# -- plain versions -----------------------------------------------------------

def band_params_plain(band: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """k_band_params's function in torch ops: int32 [sum(nd - 1), 9], the
    algebra of ``_params_of`` a pair."""
    dev = band.device
    out = torch.empty((int(table[:, T_DIAGS].sum()), N_PARAMS),
                      dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for lo, n, at, n2 in table[:, [T_PARAMS, T_DIAGS, T_BAND, T_N2]].tolist():
        nd, d2 = n + 1, n2 - _SEQ_PAD
        starts, ends, isneck = band[at:at + 3 * nd].view(3, nd)
        size = ends - starts + 1
        diag = torch.arange(2, nd + 1, dtype=torch.int32, device=dev)
        st, st1, sz1 = starts[1:], starts[:-1], size[:-1]
        st2 = torch.cat([zero, starts[:-2]])
        sz2 = torch.cat([zero, size[:-2]])
        x0 = torch.where(diag < d2, st + 1, diag - d2 + st + 1)
        y0 = torch.where(diag < d2, diag - st, d2 - st)
        e_dd = torch.where(diag - 2 < d2, x0 - 2, d2 - y0 + 1)
        e_up = torch.where(diag - 1 < d2, x0 - 2, d2 - y0)
        e_lf = torch.where(diag - 1 < d2, x0 - 1, d2 - y0 + 1)
        out[lo:lo + n] = torch.stack(
            [size[1:], e_dd - st2, e_up - st1, e_lf - st1, x0, y0,
             isneck[1:], sz1, sz2], dim=1)
    return out


def order_moves_plain(codes: torch.Tensor, params: torch.Tensor,
                      table: np.ndarray, rows: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk's function step by step on the host: (moves uint8
    [moves_bytes(table)], counts int32 [B]).  Pair b's walk from (d1, d2)
    (``order_finish_mfa`` of native/lagan_order.cpp) leaves one byte a step
    (0 mismatch, 1 match, 2, 3), the last step first, written backwards
    from ``table[b, T_MOVES] + nd``: its ``counts[table[b, T_PAIR]]`` moves
    end there, in alignment order.  Bytes before them are 0."""
    dev = codes.device
    codes_h = codes.cpu().numpy().tobytes()
    par = params.cpu().numpy()
    rows_h = rows.cpu().numpy().tobytes()
    moves = np.zeros(moves_bytes(table), np.uint8)
    counts = np.zeros(table.shape[0], np.int32)
    for row in table.tolist():
        s1, s2 = row[T_S1], row[T_S2]
        d1, d2 = row[T_N1] - _SEQ_PAD, row[T_N2] - _SEQ_PAD
        w, nd, at_rows = row[T_WMAX], row[T_DIAGS] + 1, row[T_ROWS]
        p = par[row[T_PARAMS]:row[T_PARAMS] + nd - 1]
        x0s, y0s, sizes = (p[:, c].tolist() for c in (4, 5, 0))
        diag1 = 0 if row[T_DIAG1] else 0xF

        def get_ptr(x, y):
            dn = x + y - 1
            if dn <= 0 or dn > nd:
                return 0xF
            if dn == 1:
                return diag1
            r = dn - 2
            lane = x - x0s[r] if dn < d2 else y0s[r] - y
            if lane < 0 or lane >= sizes[r]:
                return 0xF
            return rows_h[at_rows + r * w + lane]

        out = []
        x, y, inrun = d1, d2, 0
        zz = get_ptr(x, y)
        while True:
            which = zz & 3
            if which == 3:
                break  # off the band
            if inrun == 1:
                if zz & 4:
                    which = 1
            elif inrun == 2:
                if zz & 8:
                    which = 2
            if which == 0:
                inrun = 0
                out.append(int(codes_h[s1 + x - 1] == codes_h[s2 + y - 1]))
                x -= 1
                y -= 1
            elif which == 1:
                inrun = 1
                out.append(2)
                x -= 1
            else:
                inrun = 2
                out.append(3)
                y -= 1
            if not (x > 0 and y > 0):
                break
            zz = get_ptr(x, y)
        end = row[T_MOVES] + nd
        moves[end - len(out):end] = out[::-1]
        counts[row[T_PAIR]] = len(out)
    return torch.from_numpy(moves).to(dev), torch.from_numpy(counts).to(dev)


def order_moves_segments_plain(codes: torch.Tensor, params: torch.Tensor,
                               table: np.ndarray, rows: torch.Tensor,
                               segment_rows: int = WALK_SEGMENT_ROWS,
                               trace: list | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The narrow walk's algebra (``k_walk_tables``, ``k_walk_compose``,
    ``k_walk_replay``) on the host, for the tests: order_moves_plain's
    contract for pairs of wmax <= 32.

    A pair's rows are cut into segments of `segment_rows` from row 0 up.
    The walk enters a segment at its top row or, by a diagonal step over
    it, the row below, in any lane and run state: WALK_ENTRIES (sel, lane)
    codes, sel 0-2 the top row in run state sel, 3 the row below (run
    state 0).  Tables: from every entry code of every segment (the top
    segment only from the walk's start), the steps taken inside it and the
    code it leaves by, or WALK_STOP.  Composition: from the top segment
    down, one lookup a segment gives each its true entry and, summed, the
    index of its first move.  Replay: each segment walks from its entry
    and writes its moves.  `trace` gets (pair, segment, entry, steps,
    exit) of every segment the walk entered."""
    dev = codes.device
    codes_h = codes.cpu().numpy()
    par = params.cpu().numpy()
    rows_h = rows.cpu().numpy()
    moves = np.zeros(moves_bytes(table), np.uint8)
    counts = np.zeros(table.shape[0], np.int32)
    for b, row in enumerate(table.tolist()):
        s1, s2 = row[T_S1], row[T_S2]
        d1, d2 = row[T_N1] - _SEQ_PAD, row[T_N2] - _SEQ_PAD
        w, nd1 = row[T_WMAX], row[T_DIAGS]
        if w > 32:
            raise ValueError("order_moves_segments_plain: wmax <= 32")
        p = par[row[T_PARAMS]:row[T_PARAMS] + nd1]
        x0s, y0s, sizes = (p[:, c].tolist() for c in (4, 5, 0))
        ptr = rows_h[row[T_ROWS]:row[T_ROWS] + nd1 * w].reshape(nd1, w)
        diag1 = 0 if row[T_DIAG1] else 0xF

        def lane_of(r, x, y):
            return x - x0s[r] if r + 2 < d2 else y0s[r] - y

        def walk(lo, hi, code, out=None):
            """(steps, exit code) of the walk from `code` into rows [lo,
            hi), its moves appended to `out`."""
            sel, ln = code >> 5, code & 31
            r, inrun = (hi - 1, sel) if sel < 3 else (hi - 2, 0)
            if r + 2 < d2:
                x = x0s[r] + ln
                y = r + 3 - x
            else:
                y = y0s[r] - ln
                x = r + 3 - y
            zz = int(ptr[r, ln]) if ln < sizes[r] else 0xF
            steps = 0
            while zz & 3 != 3:
                which = zz & 3
                if inrun == 1 and zz & 4:
                    which = 1
                elif inrun == 2 and zz & 8:
                    which = 2
                if out is not None:
                    out.append(int(codes_h[s1 + x - 1] == codes_h[s2 + y - 1])
                               if which == 0 else which + 1)
                steps += 1
                x -= which != 2
                y -= which != 1
                inrun = which
                if not (x > 0 and y > 0):
                    break
                r -= 2 if which == 0 else 1
                if r < 0:
                    zz = diag1 if r == -1 else 0xF
                    continue
                ln = lane_of(r, x, y)
                inside = 0 <= ln < sizes[r]
                if r < lo:  # leaves by the segment below's entry
                    return steps, ((inrun if r == lo - 1 else 3) << 5 | ln
                                   if inside else WALK_STOP)
                zz = int(ptr[r, ln]) if inside else 0xF
            return steps, WALK_STOP

        S = segment_rows
        nseg = -(-nd1 // S)
        bounds = [(k * S, min(nd1, (k + 1) * S)) for k in range(nseg)]
        ln0 = lane_of(nd1 - 1, d1, d2)
        start = ln0 if 0 <= ln0 < 32 else WALK_STOP
        tables = [[walk(lo, hi, c) for c in range(WALK_ENTRIES)]
                  for lo, hi in bounds[:-1]]
        tables.append({start: walk(*bounds[-1], start)}
                      if start != WALK_STOP else {})
        # composition, from the top segment down
        entries, state, total = [], start, 0
        for k in range(nseg - 1, -1, -1):
            if state == WALK_STOP:
                break
            steps, exit_ = tables[k][state]
            entries.append((k, state, total))
            total += steps
            state = exit_
        # replay
        end = row[T_MOVES] + nd1 + 1
        for k, code, first in entries:
            out: list[int] = []
            steps, exit_ = walk(*bounds[k], code, out)
            moves[end - first - steps:end - first] = out[::-1]
            if trace is not None:
                trace.append((b, k, code, steps, exit_))
        counts[row[T_PAIR]] = total
    return torch.from_numpy(moves).to(dev), torch.from_numpy(counts).to(dev)


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
    void_p, c_int = ctypes.c_void_p, ctypes.c_int
    lib.order_band_launch.restype = c_int
    lib.order_band_launch.argtypes = ([void_p] * 5 + [c_int] * 6
                                      + [void_p] * 2
                                      + [ctypes.c_longlong, void_p])
    lib.order_moves_launch.restype = c_int
    lib.order_moves_launch.argtypes = ([void_p] * 4 + [c_int] * 3 + [void_p]
                                       + [c_int] + [void_p] * 6)
    lib.band_params_launch.restype = c_int
    lib.band_params_launch.argtypes = [void_p, void_p, c_int,
                                       ctypes.c_longlong, void_p, void_p]
    return lib


_SM_DEVICE: dict[torch.device, torch.Tensor] = {}


def _check_table(who: str, table: np.ndarray) -> None:
    if (table.dtype != np.int64 or table.ndim != 2
            or table.shape[1] != N_TABLE):
        raise ValueError(f"{who}: table must be int64 [B, {N_TABLE}]")
    w = table[:, T_WMAX]
    if table.shape[0] and (((w & (w - 1)) != 0).any() or w.min() < 16
                           or w.max() > 8192
                           or table[:, T_DIAGS].min() < 1):
        raise ValueError(f"{who}: wmax must be a power of two in 16..8192 "
                         "and every pair have a diagonal")


def _check(who: str, typed, table: np.ndarray,
           params: torch.Tensor | None = None) -> torch.device:
    """Raises unless every (tensor, dtype) of `typed` is contiguous on one
    CPU or CUDA device and the table indexes into `params`."""
    dev = typed[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    for t, dtype in typed:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{who}: codes, rows uint8, band, params and "
                             "init int32, contiguous, on one device")
    _check_table(who, table)
    if params is not None and (
            params.ndim != 2 or params.shape[1] != N_PARAMS
            or (table.shape[0] and params.shape[0]
                < (table[:, T_PARAMS] + table[:, T_DIAGS]).max())):
        raise ValueError(f"{who}: table must be int64 [B, {N_TABLE}] into "
                         "params [*, 9]")
    return dev


def _classes(table: np.ndarray, dev: torch.device):
    """(wmax, the class's table, the same on the device) of each band
    width among the pairs, the longest chain first."""
    for wmax in np.unique(table[:, T_WMAX]).tolist():
        sel = table[table[:, T_WMAX] == wmax]
        sel = np.ascontiguousarray(sel[np.argsort(-sel[:, T_DIAGS],
                                                  kind="stable")])
        yield int(wmax), sel, torch.from_numpy(sel).to(dev)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {err}")
    note_launch(name)


def band_params(band: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Same contract as band_params_plain.  CPU tensors run the plain
    version; CUDA tensors launch k_band_params once on the current
    stream."""
    dev = _check("band_params", [(band, torch.int32)], table)
    if dev.type == "cpu":
        return band_params_plain(band, table)
    lib = build()
    out = torch.empty((int(table[:, T_DIAGS].sum()), N_PARAMS),
                      dtype=torch.int32, device=dev)
    if table.shape[0]:
        with torch.cuda.device(dev):
            _launched("band_params", lib.band_params_launch(
                band.data_ptr(), torch.from_numpy(table).to(dev).data_ptr(),
                table.shape[0], int(table[:, T_DIAGS].max()), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream))
    return out


def band_rows(codes: torch.Tensor, params: torch.Tensor, init: torch.Tensor,
              table: np.ndarray) -> torch.Tensor:
    """Same contract as order_band_rows_plain, inside the band.  CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, once for every ``wmax`` among the pairs (above 32
    lanes after ``k_band_words``, into a buffer of two bytes a pointer byte
    of the class's pairs)."""
    dev = _check("band_rows", [(codes, torch.uint8), (params, torch.int32),
                               (init, torch.int32)], table, params)
    if dev.type == "cpu":
        return order_band_rows_plain(codes, params, init, table)
    lib = build()
    if dev not in _SM_DEVICE:
        _SM_DEVICE[dev] = torch.from_numpy(_SM.reshape(-1).copy()).to(dev)
    out = torch.empty(rows_bytes(table), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for wmax, sel, tab in _classes(table, dev):
        words, base = class_words(table, wmax, dev)
        with torch.cuda.device(dev):
            _launched("order_band", lib.order_band_launch(
                codes.data_ptr(), params.data_ptr(), init.data_ptr(),
                tab.data_ptr(), _SM_DEVICE[dev].data_ptr(), len(sel), wmax,
                GAP_START, GAP_CONT, int(DUMMY), _CB_CODE, out.data_ptr(),
                None if words is None else words.data_ptr(), base, stream))
    return out


def class_words(table: np.ndarray, wmax: int, dev: torch.device
                ) -> tuple[torch.Tensor | None, int]:
    """The band DP's words of the pairs of width `wmax` (above 32 lanes,
    else None): int16, pair b's from its ``T_ROWS`` less the base
    returned."""
    if wmax <= 32:
        return None, 0
    sel = table[table[:, T_WMAX] == wmax]
    base = int(sel[:, T_ROWS].min())
    end = int((sel[:, T_ROWS] + sel[:, T_DIAGS] * wmax).max())
    return torch.empty(end - base, dtype=torch.int16, device=dev), base


def band_moves(codes: torch.Tensor, params: torch.Tensor, table: np.ndarray,
               rows: torch.Tensor, split_ms: np.ndarray | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as order_moves_plain, except that bytes before a
    pair's moves are not set.  CPU tensors run the plain version; CUDA
    tensors launch the walk on the current stream, once for every ``wmax``
    among the pairs: up to 32 lanes the three kernels of the walk in
    segments of WALK_SEGMENT_ROWS rows (a multiple of 32), above
    ``k_order_moves_wide``.  ``split_ms`` (float32 [3], for measurements):
    the narrow class's three kernels' ms, tables, composition, replay, the
    call waiting for them."""
    dev = _check("band_moves", [(codes, torch.uint8), (params, torch.int32),
                                (rows, torch.uint8)], table, params)
    if rows.shape != (rows_bytes(table),):
        raise ValueError("band_moves: rows must hold the table's pointer "
                         "rows")
    if dev.type == "cpu":
        return order_moves_plain(codes, params, table, rows)
    lib = build()
    segment_rows = WALK_SEGMENT_ROWS
    moves = torch.empty(moves_bytes(table), dtype=torch.uint8, device=dev)
    counts = torch.empty(table.shape[0], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for wmax, sel, tab in _classes(table, dev):
        scratch, n_segs = [], 0
        if wmax <= 32:
            # the first segment of each pair, the segments' tables and
            # entries
            first = np.zeros(len(sel) + 1, np.int32)
            first[1:] = np.cumsum(-(-sel[:, T_DIAGS] // segment_rows))
            n_segs = int(first[-1])
            scratch = [torch.from_numpy(first).to(dev),
                       torch.empty(n_segs * WALK_ENTRIES, dtype=torch.int32,
                                   device=dev),
                       torch.empty(n_segs * 2, dtype=torch.int32, device=dev)]
        first_seg, tables, entries = (
            [t.data_ptr() for t in scratch] or [None] * 3)
        with torch.cuda.device(dev):
            _launched("order_moves", lib.order_moves_launch(
                codes.data_ptr(), params.data_ptr(), tab.data_ptr(),
                rows.data_ptr(), len(sel), wmax, segment_rows, first_seg,
                n_segs, tables, entries, moves.data_ptr(), counts.data_ptr(),
                stream, split_ms.ctypes.data if split_ms is not None
                and wmax <= 32 else None))
    return moves, counts


def card_bytes_of(job: _Job) -> int:
    """A pair's bytes on the card in a batch: pointer rows, the band DP's
    words (above 32 lanes), CARD_BYTES_A_DIAGONAL."""
    lanes = job.wmax * (3 if job.wmax > 32 else 1)
    return (job.nd - 1) * (lanes + CARD_BYTES_A_DIAGONAL)


def _batches(jobs: list[_Job], card_bytes: int | None = None):
    """Slices of `jobs` (one pair alone may hold more): without
    `card_bytes` (the CPU), of at most BATCH_ROW_BYTES of pointer rows; on
    a card, of at most `card_bytes` there (the pointer rows and
    ``card_bytes_of``) and BATCH_DIAGONALS diagonals, so
    that the pairs of one band width run side by side in one launch."""
    at = 0
    while at < len(jobs):
        end, used, diags = at, 0, 0
        while end < len(jobs):
            job = jobs[end]
            more = diags + job.nd - 1
            if card_bytes is None:
                need = used + (job.nd - 1) * job.wmax
                fits = need <= BATCH_ROW_BYTES
            else:
                need = used + card_bytes_of(job)
                fits = need <= card_bytes and more <= BATCH_DIAGONALS
            if end > at and not fits:
                break
            used, diags = need, more
            end += 1
        yield jobs[at:end]
        at = end


def order_band_rows(jobs: list[_Job], device: torch.device
                    ) -> list[np.ndarray]:
    """The pointer rows uint8 [nd - 1, wmax] of each job, brought to the
    host (the tests' way to the rows; a run leaves them on the device:
    order_moves)."""
    out: list[np.ndarray] = []
    for batch in _batches(jobs):
        codes, params, init, table = pack_jobs(batch)
        args = [torch.from_numpy(a).to(device) for a in (codes, params, init)]
        flat = band_rows(*args, table).cpu().numpy()
        for b, job in enumerate(batch):
            lo = int(table[b, T_ROWS])
            out.append(flat[lo:lo + (job.nd - 1) * job.wmax]
                       .reshape(job.nd - 1, job.wmax))
    return out


def _card_budget(device: torch.device) -> int | None:
    """Half of what the card can give (``card_free_bytes``); None on the
    CPU."""
    free = card_free_bytes(device)
    return None if free is None else free // 2


def order_moves(jobs: list[_Job], device: torch.device) -> list[np.ndarray]:
    """The walk's moves uint8 [count] of each job, in alignment order.  The
    jobs go up in batches (12 bytes a diagonal and the codes; ``_batches``
    cuts them); params, the pointer rows and the walk stay on the
    device; each batch's moves and counts come down in one copy through a
    pinned buffer."""
    out: list[np.ndarray] = []
    for batch in _batches(jobs, _card_budget(device)):
        codes, band, init, table = pack_bands(batch)
        codes, band, init = (torch.from_numpy(a).to(device)
                             for a in (codes, band, init))
        params = band_params(band, table)
        rows = band_rows(codes, params, init, table)
        moves, counts = band_moves(codes, params, table, rows)
        n = moves.numel()
        # one buffer, one copy: the moves, then the counts' bytes
        both = torch.cat([moves, counts.view(torch.uint8)])
        flat = download(both, "order_moves")
        moves, counts = flat[:n], flat[n:].view(np.int32)
        ROW_BYTES[0] += both.numel()
        timings.add("order_row_bytes", both.numel())
        for b, job in enumerate(batch):
            end = int(table[b, T_MOVES]) + job.nd
            # a copy: the pinned buffer serves the next batch
            out.append(moves[end - int(counts[b]):end].copy())
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
                           max_band_width: int = 8192,
                           mesh: Mesh | None = None) -> list[str | None]:
    """Batched device order: jobs = [(seq1, name1, seq2, name2,
    anchors_text)].  Every pair's band DP and walk run in one call of
    order_moves, or with `mesh` one call a shard on a contiguous slice of
    the pairs (when `mesh` is None, SIBELIA_TPU_SHARDED=N > 1 with N
    shards available builds one); a None result marks a pair that needs
    the host fallback."""
    if mesh is None:
        mesh = requested_mesh(device, "pairs")
    lib = load_lagan()
    prepared: list[_Job | None] = []
    results: list[str | None] = [None] * len(jobs)
    with timings.phase("order_prepare"):
        for s1, _n1, s2, _n2, anch in jobs:
            job = _prepare_job(lib, s1, s2, anch, max_band_width)
            if job is not None:  # the band is copied out
                lib.le_order_release(job.handle)
            prepared.append(job)
    idxs = [i for i, job in enumerate(prepared) if job is not None]
    with timings.phase("order_device"):
        if mesh is None:
            moves = order_moves([prepared[i] for i in idxs], device)
        else:
            moves = order_moves_sharded([prepared[i] for i in idxs], mesh)
    with timings.phase("order_finish"):
        for i, m in zip(idxs, moves):
            results[i] = mfa_text(prepared[i], m, jobs[i][1], jobs[i][3])
    return results


def order_moves_sharded(jobs: list[_Job], mesh: Mesh) -> list[np.ndarray]:
    """order_moves over a mesh: shard s takes jobs[len * s // n :
    len * (s + 1) // n] on its device; every process gets every move."""
    n = mesh.size
    timings.add("order_mesh_shards", n)
    cut = [len(jobs) * s // n for s in range(n + 1)]
    mine = [order_moves(jobs[cut[s]:cut[s + 1]], mesh.devices[s])
            for s in mesh.local_shards()]
    return [m for part in mesh.gather_objects(mine) for m in part]
