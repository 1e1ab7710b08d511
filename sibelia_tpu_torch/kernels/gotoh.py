"""Batched Gotoh alignment of the fast aligner's gap subproblems.

Twin of ``sibelia_tpu/kernels/gotoh.py`` and ``gotoh_pallas.py``.  The
Pallas TPU kernel ``gotoh_pallas.py::_kernel`` and the host traceback of
``batch_align_pallas`` are replaced by one hand-written CUDA C++ kernel,
``csrc/gotoh.cu``: a warp a pair runs the DP over the pair's true lengths,
keeps four direction bits a cell in shared memory, walks the traceback on
the card and writes the two aligned rows and their length, 516 bytes a
pair at T = 128.  It is bound by the latency of its row chain, not by
bytes or operations.

``batch_align_rows`` takes CUDA tensors to the kernel and CPU tensors to
``batch_align_rows_plain``: ``batched_gotoh_dirs_plain`` (the algebra of
``sibelia_tpu/kernels/gotoh.py::batched_gotoh_dirs`` in torch ops)
followed by the traceback of the whole batch at once.  ``batch_align``
closes a batch of gap subproblems with one upload, one launch and one
download through pinned buffers, and reproduces the host ``_gotoh`` rows
exactly.  ``batched_gotoh_dirs`` returns the four direction planes as
int8 [4, B, T, T] (``m_choice``, ``ix_open``, ``iy_open``,
``cell_state``): on a card from the same kernel with its flag set, which
also writes each cell's four bits to device memory, so that every cell of
the kernel's DP can be held against the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import timings
from ..core.convert import download, pinned
from ..core.platform import note_launch
from ..variants.scoring import _SM, GAP_EXTEND, GAP_OPEN
from . import nvcc

NEG = -(1 << 28)  # sibelia_tpu/kernels/gotoh.py:30
T_MAX = 128  # 32 lanes x 4 columns


def score_classes() -> tuple[np.ndarray, np.ndarray]:
    """(byte_class uint8[256], class_score int32[5, 5]) with
    class_score[byte_class[x], byte_class[y]] == _SM[x, y] for all bytes:
    _SM is -43 unless both bytes are uppercase ACGT, so A, C, G, T and
    "other" are the only classes it tells apart."""
    byte_class = np.full(256, 4, dtype=np.uint8)
    byte_class[list(b"ACGT")] = np.arange(4, dtype=np.uint8)
    rep = np.array(list(b"ACGT") + [0])  # byte 0 stands for "other"
    return byte_class, _SM[rep[:, None], rep[None, :]].astype(np.int32)


_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_TABLE_BYTES = 256 + 4 * 25  # byte_class and class_score


def _device_tables(device: torch.device):
    if device not in _TABLES:
        byte_class, class_score = score_classes()
        _TABLES[device] = (torch.from_numpy(byte_class).to(device),
                           torch.from_numpy(class_score).to(device))
    return _TABLES[device]


def build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the kernel library."""
    lib = nvcc.load("gotoh")
    lib.gotoh_align_launch.restype = ctypes.c_int
    lib.gotoh_align_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    return lib


def _argmax3(x, y, z):
    """0, 1 or 2 for the largest of three, ties to the lower index."""
    return torch.where(x >= torch.maximum(y, z), 0,
                       torch.where(y >= z, 1, 2)).to(torch.int8)


def batched_gotoh_dirs_plain(a_codes: torch.Tensor, b_codes: torch.Tensor,
                             T: int) -> torch.Tensor:
    """a_codes, b_codes: uint8 [B, T] byte codes, zero-padded.  Returns
    int8 [4, B, T, T]: per cell (i-1, j-1) of the (T+1)^2 DP, m_choice,
    ix_open, iy_open and cell_state (sibelia_tpu/kernels/gotoh.py:37-102,
    rows as a Python loop, the batch written out)."""
    dev = a_codes.device
    B = a_codes.shape[0]
    i32 = torch.int32
    sm = torch.from_numpy(_SM).to(dev)
    a = a_codes.long()
    b = b_codes.long()
    j = torch.arange(T + 1, dtype=i32, device=dev)
    ge_j = GAP_EXTEND * j
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    M = torch.full((B, T + 1), NEG, dtype=i32, device=dev)
    M[:, 0] = 0
    Ix = torch.full((B, T + 1), NEG, dtype=i32, device=dev)
    Iy = (GAP_OPEN + ge_j).expand(B, T + 1).clone()
    Iy[:, 0] = NEG
    out = torch.empty((4, B, T, T), dtype=torch.int8, device=dev)
    for i in range(1, T + 1):
        Mp, Ixp, Iyp = M, Ix, Iy
        srow = torch.gather(sm[a[:, i - 1]], 1, b)  # S(a[i-1], b[j-1])
        best_prev = torch.maximum(torch.maximum(Mp, Ixp), Iyp)
        M = torch.cat([neg_col, best_prev[:, :-1] + srow], dim=1)
        out[0, :, i - 1] = _argmax3(Mp[:, :-1], Ixp[:, :-1], Iyp[:, :-1])
        ix_open_score = Mp + GAP_OPEN + GAP_EXTEND
        ix_ext_score = Ixp + GAP_EXTEND
        Ix = torch.maximum(ix_open_score, ix_ext_score)
        out[1, :, i - 1] = (ix_open_score >= ix_ext_score)[:, 1:]
        # Iy via the exclusive running max of (M[i, j'] - GE*j')
        cm = torch.cummax(M - ge_j, dim=1).values
        Iy = ge_j + GAP_OPEN + torch.cat([neg_col, cm[:, :-1]], dim=1)
        Iy[:, 0] = NEG
        out[2, :, i - 1] = ((M[:, :-1] + GAP_OPEN + GAP_EXTEND)
                            >= (Iy[:, :-1] + GAP_EXTEND))
        out[3, :, i - 1] = _argmax3(M, Ix, Iy)[:, 1:]
    return out


def unpack_dirs(packed: torch.Tensor) -> torch.Tensor:
    """The four planes int8 [4, B, T, T] from the kernel's byte a cell,
    uint8 [B, T, T] (csrc/gotoh.cu): bits 0-1 are cell_state, bit 2 is
    ix_open, bit 3 is iy_open of the cell to the right; m_choice of a cell
    is cell_state of its upper left neighbour.  The first row and column
    are the DP's borders in closed form."""
    B, T, _ = packed.shape
    p = packed.to(torch.int8)
    out = torch.empty((4, B, T, T), dtype=torch.int8, device=packed.device)
    out[0, :, 0, :] = 2
    out[0, :, :, 0] = 1
    out[0, :, 0, 0] = 0
    out[0, :, 1:, 1:] = p[:, :-1, :-1] & 3
    out[1] = (p >> 2) & 1
    out[2, :, :, 0] = 0
    out[2, :, :, 1:] = (p[:, :, :-1] >> 3) & 1
    out[3] = p & 3
    return out


def _check_codes(who: str, a_codes: torch.Tensor, b_codes: torch.Tensor,
                 T: int) -> int:
    """Raises unless both are contiguous uint8 [B, T] on one device, B >= 1
    and T in 1..T_MAX; returns B."""
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{who}: T={T} outside 1..{T_MAX}")
    B = a_codes.shape[0]
    for t in (a_codes, b_codes):
        if (t.device != a_codes.device or t.dtype != torch.uint8
                or t.shape != (B, T) or not t.is_contiguous()):
            raise ValueError(f"{who}: codes must be contiguous uint8 [B, T] "
                             "on one device")
    if B < 1:
        raise ValueError(f"{who}: empty batch")
    return B


def _split(out: torch.Tensor, B: int, T: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows uint8 [B, 2, 2T], lengths int32 [B]) as views of one uint8
    buffer of B * (4T + 4) bytes, rows first."""
    return (out[:B * 4 * T].view(B, 2, 2 * T),
            out[B * 4 * T:].view(torch.int32))


def _launch(a_codes: torch.Tensor, b_codes: torch.Tensor, lens: torch.Tensor,
            T: int, dirs: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the kernel on the current stream, on checked CUDA
    inputs; returns the buffer that _split reads.  With `dirs` (uint8
    [B, T, T]) the form that also writes the direction bits."""
    B, dev = a_codes.shape[0], a_codes.device
    lib = build()
    byte_class, class_score = _device_tables(dev)
    out = torch.empty(B * (4 * T + 4), dtype=torch.uint8, device=dev)
    rows, lengths = _split(out, B, T)
    err = lib.gotoh_align_launch(
        a_codes.data_ptr(), b_codes.data_ptr(), lens.data_ptr(),
        byte_class.data_ptr(), class_score.data_ptr(), B, T, GAP_OPEN,
        GAP_EXTEND, NEG, rows.data_ptr(), lengths.data_ptr(),
        None if dirs is None else dirs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gotoh_align_launch failed: CUDA error {err}")
    note_launch("gotoh_align" if dirs is None else "gotoh_align_dirs")
    return out


def batched_gotoh_dirs_packed(a_codes: torch.Tensor, b_codes: torch.Tensor,
                              T: int) -> torch.Tensor:
    """uint8 [B, T, T], the byte a cell that unpack_dirs reads: one launch
    of the kernel's plane-writing form on the current stream, every length
    taken as T.  CUDA tensors only."""
    if a_codes.device.type != "cuda":
        raise ValueError(
            f"batched_gotoh_dirs: unsupported device {a_codes.device}")
    B = _check_codes("batched_gotoh_dirs", a_codes, b_codes, T)
    dev = a_codes.device
    lens = torch.full((2, B), T, dtype=torch.int32, device=dev)
    packed = torch.empty((B, T, T), dtype=torch.uint8, device=dev)
    _launch(a_codes, b_codes, lens, T, packed)
    return packed


def batched_gotoh_dirs(a_codes: torch.Tensor, b_codes: torch.Tensor,
                       T: int) -> torch.Tensor:
    """Same contract as batched_gotoh_dirs_plain.  CPU tensors run the
    plain version; CUDA tensors launch the kernel's plane-writing form and
    unpack its bytes on the card."""
    if a_codes.device.type == "cpu":
        return batched_gotoh_dirs_plain(a_codes, b_codes, T)
    return unpack_dirs(batched_gotoh_dirs_packed(a_codes, b_codes, T))


def batch_align_rows_plain(a_codes: torch.Tensor, b_codes: torch.Tensor,
                           lens: torch.Tensor, T: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops.  a_codes, b_codes: uint8 [B, T],
    zero-padded; lens: int32 [2, B], len(a) then len(b), each in 1..T.
    Returns (rows uint8 [B, 2, 2T], lengths int32 [B]): the aligned rows
    of a and b, '-' for a gap, zero past each length.  The planes of
    batched_gotoh_dirs_plain, then traceback_from_dirs for the whole
    batch at once, one step of every pair's walk a loop turn."""
    dev = a_codes.device
    B = a_codes.shape[0]
    m_choice, ix_open, iy_open, cell_state = (
        p.reshape(B, T * T) for p in batched_gotoh_dirs_plain(a_codes,
                                                              b_codes, T))

    def at(plane, i, j):  # plane[x, i-1, j-1], any value where i or j is 0
        flat = (i - 1).clamp(min=0) * T + (j - 1).clamp(min=0)
        return plane.gather(1, flat[:, None])[:, 0]

    def byte_at(codes, i):  # codes[x, i-1]
        return codes.gather(1, (i - 1).clamp(min=0)[:, None])[:, 0]

    i, j = lens[0].long(), lens[1].long()
    state = at(cell_state, i, j)
    zero = torch.zeros_like(state)
    gap = torch.full((B,), ord("-"), dtype=torch.uint8, device=dev)
    rev = torch.zeros((B, 2, 2 * T + 1), dtype=torch.uint8, device=dev)
    length = torch.zeros(B, dtype=torch.long, device=dev)
    for _ in range(2 * T):
        active = (i > 0) | (j > 0)
        if not bool(active.any()):
            break
        diag = active & (state == 0) & (i > 0) & (j > 0)
        up = active & ~diag & (state == 1) & (i > 0)
        left = active & ~diag & ~up & (state == 2) & (j > 0)
        rest = active & ~diag & ~up & ~left
        take_a = diag | up | (rest & (i > 0))
        take_b = diag | left | (rest & ~(i > 0))
        chars = torch.stack([torch.where(take_a, byte_at(a_codes, i), gap),
                             torch.where(take_b, byte_at(b_codes, j), gap)], 1)
        # a finished pair writes gaps into the spare column past its length
        rev.scatter_(2, length[:, None, None].expand(B, 2, 1),
                     chars[:, :, None])
        opened_x = (j == 0) | (at(ix_open, i, j) != 0)
        opened_y = (i == 0) | (at(iy_open, i, j) != 0)
        state = torch.where(diag, at(m_choice, i, j),
                            torch.where((up & opened_x) | (left & opened_y),
                                        zero, state))
        i = i - take_a.long()
        j = j - take_b.long()
        length = length + active.long()
    col = torch.arange(2 * T, device=dev)[None, :]
    src = (length[:, None] - 1 - col).clamp(min=0)[:, None, :].expand(B, 2, -1)
    rows = rev.gather(2, src) * (col < length[:, None])[:, None, :]
    return rows, length.to(torch.int32)


def batch_align_rows(a_codes: torch.Tensor, b_codes: torch.Tensor,
                     lens: torch.Tensor, T: int, check_lens: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as batch_align_rows_plain, but nothing is promised
    past each length.  CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream.  A length outside 1..T
    raises; on a card that check waits for the device, so a caller that
    has checked the lengths on the host passes check_lens=False."""
    if a_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"batch_align_rows: unsupported device {a_codes.device}")
    B = _check_codes("batch_align_rows", a_codes, b_codes, T)
    if (lens.device != a_codes.device or lens.dtype != torch.int32
            or lens.shape != (2, B) or not lens.is_contiguous()):
        raise ValueError("batch_align_rows: lens must be contiguous int32 "
                         "[2, B] on the codes' device")
    if check_lens and bool(((lens < 1) | (lens > T)).any()):
        raise ValueError(f"batch_align_rows: a length outside 1..{T}")
    if a_codes.device.type == "cpu":
        return batch_align_rows_plain(a_codes, b_codes, lens, T)
    return _split(_launch(a_codes, b_codes, lens, T), B, T)


def _pack_into(pairs: list[tuple[bytes, bytes]], codes: np.ndarray,
               lens: np.ndarray) -> None:
    """Writes each pair's bytes into codes uint8 [2, B, T] (what lies past
    a length is left as it is) and its lengths into lens int32 [2, B].
    Raises on a length outside 1..T."""
    B, T = len(pairs), codes.shape[2]
    for side in (0, 1):
        seqs = [pair[side] for pair in pairs]
        n = np.fromiter(map(len, seqs), dtype=np.int64, count=B)
        if n.min() < 1 or n.max() > T:
            raise ValueError(f"gotoh: a sequence length outside 1..{T}")
        lens[side] = n
        starts = np.cumsum(n) - n
        cols = np.arange(int(n.sum())) - np.repeat(starts, n)
        codes[side, np.repeat(np.arange(B), n), cols] = np.frombuffer(
            b"".join(seqs), dtype=np.uint8)


def pack_codes(pairs: list[tuple[bytes, bytes]], T: int) -> np.ndarray:
    """uint8 [2, B, T]: the a and b sides of each pair, zero-padded."""
    codes = np.zeros((2, len(pairs), T), dtype=np.uint8)
    _pack_into(pairs, codes, np.empty((2, len(pairs)), dtype=np.int32))
    return codes


def traceback_from_dirs(a: bytes, b: bytes, m_choice, ix_open, iy_open,
                        cell_state) -> tuple[str, str]:
    """Replay the host Gotoh traceback from direction bits; the start
    state is the stored argmax at the true corner (n, m).  A copy of
    sibelia_tpu/kernels/gotoh.py:105-146, whose module imports jax."""
    n, m = len(a), len(b)
    out_a: list[str] = []
    out_b: list[str] = []
    i, j = n, m
    if n == 0 or m == 0:
        return ("-" * m if n == 0 else a.decode(),
                b.decode() if n == 0 else "-" * m)
    state = int(cell_state[n - 1][m - 1])
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            out_a.append(chr(a[i - 1]))
            out_b.append(chr(b[j - 1]))
            nxt = int(m_choice[i - 1][j - 1])
            i -= 1
            j -= 1
            state = nxt
        elif state == 1 and i > 0:
            out_a.append(chr(a[i - 1]))
            out_b.append("-")
            if bool(ix_open[i - 1][j - 1]) if j > 0 else True:
                state = 0
            i -= 1
        elif state == 2 and j > 0:
            out_a.append("-")
            out_b.append(chr(b[j - 1]))
            if bool(iy_open[i - 1][j - 1]) if i > 0 else True:
                state = 0
            j -= 1
        else:
            if i > 0:
                out_a.append(chr(a[i - 1]))
                out_b.append("-")
                i -= 1
            else:
                out_a.append("-")
                out_b.append(chr(b[j - 1]))
                j -= 1
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def batch_align(pairs: list[tuple[bytes, bytes]], T: int,
                device: torch.device) -> list[tuple[str, str]]:
    """Aligned rows of each (a, b), len(a) and len(b) in 1..T, identical to
    the host Gotoh's (twin of gotoh_pallas.py::batch_align_pallas, with no
    padding of the batch).  On a card: lengths and codes go up in one copy
    from a pinned buffer, one launch, rows and lengths come down in one
    copy into a second pinned buffer.  The counters ``gotoh_cells`` (the
    DP cells of the true lengths) and ``gotoh_bytes`` give the launch's
    shape.  ``gotoh_bytes`` is what the kernel touches, not the padded
    buffers: it reads the two score tables, each pair's lengths and its
    n + m bases, and writes each pair's length and its two rows up to
    that length."""
    if not pairs:
        return []
    B = len(pairs)
    on_card = device.type == "cuda"
    with timings.phase("gotoh_pack"):
        # lengths first: int32 needs its 4-byte alignment, bytes need none
        n_in = 8 * B + 2 * B * T
        host_in = (pinned("in", n_in) if on_card
                   else torch.zeros(n_in, dtype=torch.uint8))
        lens = host_in[:8 * B].view(torch.int32).view(2, B)
        codes = host_in[8 * B:].view(2, B, T)
        _pack_into(pairs, codes.numpy(), lens.numpy())
        n = lens.numpy().astype(np.int64)
        timings.add("gotoh_cells", int((n[0] * n[1]).sum()))
    with timings.phase("gotoh_device"):
        if on_card:
            dev_in = host_in.to(device, non_blocking=True)
            codes_d = dev_in[8 * B:].view(2, B, T)
            out = _launch(codes_d[0], codes_d[1],
                          dev_in[:8 * B].view(torch.int32).view(2, B), T)
            host_out = torch.from_numpy(download(out, "out"))
        else:
            rows, lengths = batch_align_rows_plain(codes[0], codes[1], lens,
                                                   T)
            host_out = torch.cat([rows.reshape(-1),
                                  lengths.view(torch.uint8)])
    with timings.phase("gotoh_traceback"):
        rows, lengths = _split(host_out, B, T)
        timings.add("gotoh_bytes", _TABLE_BYTES + 12 * B + int(n.sum())
                    + 2 * int(lengths.sum()))
        # chr() of every byte, as the host traceback writes its rows
        text = rows.numpy().tobytes().decode("latin-1")
        return [(text[at:at + L], text[at + 2 * T:at + 2 * T + L])
                for at, L in zip(range(0, B * 4 * T, 4 * T),
                                 lengths.tolist())]
