"""Batched Gotoh direction planes for the fast aligner's gap subproblems.

Twin of ``sibelia_tpu/kernels/gotoh.py`` and ``gotoh_pallas.py``.  The
Pallas TPU kernel ``gotoh_pallas.py::_kernel`` is replaced by the
hand-written CUDA C++ kernel ``csrc/gotoh.cu`` (one warp per problem, the
codes looked up through a 5-class score table instead of a precomputed
[B, T, T] score cube).  It is bound by the write of its four int8 planes,
64 KB a problem at T = 128, and by the serial chain of T rows.

``batched_gotoh_dirs`` takes a CUDA tensor to the kernel and a CPU tensor
to ``batched_gotoh_dirs_plain``, the algebra of
``sibelia_tpu/kernels/gotoh.py::batched_gotoh_dirs`` in torch ops.  Both
return the four planes stacked as int8 [4, B, T, T]: ``m_choice``,
``ix_open``, ``iy_open``, ``cell_state``.  ``batch_align`` closes a batch
of gap subproblems with one upload, one launch, one download and the host
traceback, which reproduces the host ``_gotoh`` rows exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import timings
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


def _device_tables(device: torch.device):
    if device not in _TABLES:
        byte_class, class_score = score_classes()
        _TABLES[device] = (torch.from_numpy(byte_class).to(device),
                           torch.from_numpy(class_score).to(device))
    return _TABLES[device]


def build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the kernel library."""
    lib = nvcc.load("gotoh")
    lib.gotoh_dirs_launch.restype = ctypes.c_int
    lib.gotoh_dirs_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_void_p])
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


def batched_gotoh_dirs(a_codes: torch.Tensor, b_codes: torch.Tensor,
                       T: int) -> torch.Tensor:
    """Same contract as batched_gotoh_dirs_plain.  CPU tensors run the
    plain version; CUDA tensors launch the kernel on the current stream."""
    if a_codes.device.type == "cpu":
        return batched_gotoh_dirs_plain(a_codes, b_codes, T)
    if a_codes.device.type != "cuda":
        raise ValueError(
            f"batched_gotoh_dirs: unsupported device {a_codes.device}")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"batched_gotoh_dirs: T={T} outside 1..{T_MAX}")
    B = a_codes.shape[0]
    for t in (a_codes, b_codes):
        if (t.device != a_codes.device or t.dtype != torch.uint8
                or t.shape != (B, T) or not t.is_contiguous()):
            raise ValueError("batched_gotoh_dirs: codes must be contiguous "
                             "uint8 [B, T] on one device")
    if B < 1:
        raise ValueError("batched_gotoh_dirs: empty batch")
    lib = build()
    byte_class, class_score = _device_tables(a_codes.device)
    out = torch.empty((4, B, T, T), dtype=torch.int8, device=a_codes.device)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = lib.gotoh_dirs_launch(
        a_codes.data_ptr(), b_codes.data_ptr(), byte_class.data_ptr(),
        class_score.data_ptr(), B, T, GAP_OPEN, GAP_EXTEND, NEG,
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gotoh_dirs_launch failed: CUDA error {err}")
    note_launch("gotoh_dirs")
    return out


def pack_codes(pairs: list[tuple[bytes, bytes]], T: int) -> np.ndarray:
    """uint8 [2, B, T]: the a and b sides of each pair, zero-padded."""
    codes = np.zeros((2, len(pairs), T), dtype=np.uint8)
    for x, (a, b) in enumerate(pairs):
        codes[0, x, :len(a)] = np.frombuffer(a, dtype=np.uint8)
        codes[1, x, :len(b)] = np.frombuffer(b, dtype=np.uint8)
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
    padding of the batch)."""
    if not pairs:
        return []
    with timings.phase("gotoh_pack"):
        codes = pack_codes(pairs, T)
    with timings.phase("gotoh_device"):
        codes_d = torch.from_numpy(codes).to(device)
        planes = batched_gotoh_dirs(codes_d[0], codes_d[1], T).cpu().numpy()
    with timings.phase("gotoh_traceback"):
        return [traceback_from_dirs(a, b, *planes[:, x])
                for x, (a, b) in enumerate(pairs)]
