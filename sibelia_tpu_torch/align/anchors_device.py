"""Device backend for the LAGAN `anchors` stage.

Twin of ``sibelia_tpu/align/anchors_device.py``.  The reference's chain
selector (src/lagan/src/anchors.c) is a sweep over hit start/end events
with a Pareto-pruned skiplist; with the pipeline's gap parameters (gapopen
= gapcont = 0 -- rechaos.pl passes none) the recurrence degenerates to a
weighted longest-increasing-subsequence:

    sofar(H) = score(H) + max(0, max{ sofar(P) :
                   P's end event precedes H's start event,
                   P.a_e < H.a_s, sofar(P) > 0 })

The skiplist is modelled by an `alive` vector.  Its invariant (sofar
non-decreasing along ascending a_e) makes both operations masked maxima:
  * find_lt(key)  == the alive entry with the largest a_e < key
    (ties on a_e -> the larger sofar, then the first index);
  * inserting E refuses when that entry's sofar strictly exceeds
    E's (anchors.c wh_rulez), else erases every alive entry at
    a_e >= E.a_e with sofar <= E.sofar (the prune-next loop);
  * the final pick walks ascending with a strict '>', i.e. the
    smallest a_e among alive max-sofar entries.
The JAX package runs the 2n events as one ``lax.scan`` (``_sweep_device``,
lines 189-257, the scan at 251); here they run inside hand-written CUDA
C++ kernels of ``csrc/anchors_sweep.cu``, the event loop inside the kernel.
A set of at most WARP_HITS hits (every set of a real C-Sibelia run) takes a
warp of ``k_anchors_sweep_warp``: a lane a hit, everything in registers,
three hardware warp reductions an event, no barrier and no memory access in
the loop.  A larger set takes a block of ``k_anchors_sweep``: the hits
ranked once by (a_e, end event, the later first), then one warp runs the
events over the alive staircase, a bit set over the ranks with sofar by
rank in shared memory (in device memory above SHARED_HITS hits): under
the invariant below sofar never falls along the alive ranks, so find_lt is
the last alive rank below the key's and a kill a prefix of the alive ranks
from the hit's own (``sweep_staircase_plain`` is that algebra on the
host).  Both are bound by the chain of a set's 2n events; no set goes to
the host for its size.

``sweep_packed`` takes CUDA tensors to the kernels (one launch a class
that has sets) and CPU tensors to ``sweep_plain``, the same float32 and
int32 algebra step by step in torch ops, batched over the hit sets (a
shorter set is padded with events that do nothing).  ``sweep`` takes a
list of hit sets: one upload, the launches, one download.  The exact
aligner hands it the sets of all pairs of a recursion level at once
(``anchors_text_device_batch``).

Tie-breaks replicate the list semantics exactly:
  * query pick = max (sofar, a_e, end-event recency) lexicographically
    (find_lt returns the LAST list entry below the key; equal-sofar
    larger-a_e entries coexist, equal-(sofar, a_e) keeps the later);
  * final chain start = max sofar, then SMALLEST a_e (the list is
    walked ascending with a strict '>'), then latest end event.

Parsing (rolltonum + the two sscanf's + -gfc chunk attachment,
anchors.c:193-266) is host code below: ``_parse_hit`` and ``_parse_chunk``
are the definition, and ``parse_hit`` / ``parse_chunk`` put a regular
expression for the line shapes chaos and rechaos emit in front of them
(any other line goes to the scanner); output formatting matches
doOutput (anchors.c:167-191) byte-for-byte.  Inputs with b_e < b_s
would break the frozen-sofar argument (the reference would insert a
hit before computing its score); the pipeline's chaos stage never
emits them, and this backend refuses such input (caller falls back to
the native stage).
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from ..core import timings
from ..core.platform import note_launch
from ..kernels import nvcc

_WS = " \t\n\v\f\r"


def _rolltonum(s: str) -> int:
    """anchors.c:193-226: offset of the first of the last two
    whitespace-preceded digit runs before a ';', else len(s)."""
    got1 = got2 = -1
    in_num = False
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == ";" and got1 >= 0 and got2 >= 0:
            return got1
        if c.isdigit():
            if not in_num and (i == 0 or s[i - 1] in _WS):
                if got1 >= 0:
                    got2 = i
                else:
                    got1 = i
                in_num = True
        elif in_num and c in _WS:
            if got2 >= 0:
                got1, got2 = got2, -1
            in_num = False
        else:
            in_num = False
            got1 = got2 = -1
        i += 1
    return n


class _Scan:
    """Minimal sscanf-style scanner (only what the two formats need)."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in _WS:
            self.i += 1

    def int_(self):
        self.ws()
        j = self.i
        if j < len(self.s) and self.s[j] in "+-":
            j += 1
        k = j
        while k < len(self.s) and self.s[k].isdigit():
            k += 1
        if k == j:
            return None
        v = int(self.s[self.i:k])
        self.i = k
        return v

    def lit(self, ch: str) -> bool:
        if self.i < len(self.s) and self.s[self.i] == ch:
            self.i += 1
            return True
        return False

    def lits(self, word: str) -> bool:
        for ch in word:
            if not self.lit(ch):
                return False
        return True

    def float_(self):
        self.ws()
        j = self.i
        n = len(self.s)
        k = j
        if k < n and self.s[k] in "+-":
            k += 1
        d0 = k
        while k < n and self.s[k].isdigit():
            k += 1
        if k < n and self.s[k] == ".":
            k += 1
            while k < n and self.s[k].isdigit():
                k += 1
        if k == d0 or (k == d0 + 1 and self.s[d0] == "."):
            if not (k > d0 and any(c.isdigit() for c in self.s[d0:k])):
                return None
        if k < n and self.s[k] in "eE":
            m = k + 1
            if m < n and self.s[m] in "+-":
                m += 1
            e0 = m
            while m < n and self.s[m].isdigit():
                m += 1
            if m > e0:
                k = m
        if k == j:
            return None
        try:
            v = float(self.s[j:k])
        except ValueError:
            return None
        self.i = k
        return v


def _parse_hit(line: str):
    off = _rolltonum(line)
    sc = _Scan(line[off:])
    a_s = sc.int_()
    a_e = sc.int_()
    if a_s is None or a_e is None:
        return None
    sc.ws()
    if not sc.lit(";"):
        return None
    h = sc.i
    off2 = _rolltonum(line[off + h:])
    sc2 = _Scan(line[off + h + off2:])
    b_s = sc2.int_()
    b_e = sc2.int_()
    if b_s is None or b_e is None:
        return None
    sc2.ws()
    if not sc2.lit(";"):
        return None
    sc2.ws()
    if not sc2.lits("score"):
        return None
    sc2.ws()
    if not sc2.lit("="):
        return None
    score = sc2.float_()
    if score is None:
        return None
    return a_s, a_e, b_s, b_e, np.float32(score)


def _parse_chunk(line: str):
    sc = _Scan(line)
    vals = [sc.int_() for _ in range(4)]
    if any(v is None for v in vals):
        return None
    sc.ws()
    if sc.i != len(line):
        return None
    return tuple(vals)


# The lines chaos prints ("name b e; name b e; score = %f (+)") and rechaos
# appends ("score=1.1 (+)", "score=55 (+)"): names of printable ASCII
# without ';', single spaces, plain decimal numbers.  On these the scanner
# gives the same five values (tests/test_torch_anchors_device.py holds the
# two together on generated lines).
_NAME = r"[!-:<-~]+"
_HIT_RE = re.compile(
    rf"{_NAME} ([0-9]+) ([0-9]+); {_NAME} ([0-9]+) ([0-9]+); "
    r"score ?= ?(-?[0-9]+(?:\.[0-9]+)?) \([+-]\)", re.ASCII)
_CHUNK_RE = re.compile(r"(-?[0-9]+) (-?[0-9]+) (-?[0-9]+) (-?[0-9]+) ?",
                       re.ASCII)


def parse_hit(line: str):
    """_parse_hit, through the regular expression where the line has the
    emitted shape."""
    m = _HIT_RE.fullmatch(line)
    if m is None:
        return _parse_hit(line)
    a_s, a_e, b_s, b_e, score = m.groups()
    return int(a_s), int(a_e), int(b_s), int(b_e), np.float32(float(score))


def parse_chunk(line: str):
    """_parse_chunk, through the regular expression where the line has the
    emitted shape."""
    m = _CHUNK_RE.fullmatch(line)
    if m is None:
        return _parse_chunk(line)
    return tuple(int(g) for g in m.groups())


NEG = np.float32(-3.4e38)   # "no entry" of a float maximum
IMIN = -2**31 + 1           # "no entry" of an a_e maximum
IMAX = 2**31 - 1
# hits up to which a block keeps sofar by rank (4 bytes a hit, beside a bit
# a hit) in shared memory; csrc/anchors_sweep.cu is given the number
SHARED_HITS = 24_000
# hits up to which a set takes a warp of k_anchors_sweep_warp (a lane a hit)
WARP_HITS = 32

# hits of each sweep this process ran, in order
HITS_PER_SWEEP: list[int] = []


def sweep_plain(a_s: torch.Tensor, a_e: torch.Tensor, score: torch.Tensor,
                ev_hit: torch.Tensor, ev_isstart: torch.Tensor,
                offsets: np.ndarray):
    """The kernel's function in torch ops.  a_s, a_e int32 [N], score
    float32 [N]: the hits of S sets end to end, set s at offsets[s] ..
    offsets[s + 1] (int64 [S + 1], every set with a hit); ev_hit,
    ev_isstart int32 [2N]: each set's ordered events at twice its hits'
    offset, a hit's index counted inside its set.  Returns (sofar float32
    [N], bk int32 [N], best int32 [S], best_val float32 [S]).  The steps of
    ``sibelia_tpu/align/anchors_device.py::_sweep_device``, a Python loop
    over the events, the sets as a leading batch axis."""
    dev = a_s.device
    S = len(offsets) - 1
    sizes = np.diff(offsets)
    nmax = int(sizes.max())
    i32 = torch.int32
    A_s = torch.zeros((S, nmax), dtype=i32, device=dev)
    A_e = torch.zeros((S, nmax), dtype=i32, device=dev)
    SC = torch.zeros((S, nmax), dtype=torch.float32, device=dev)
    H = torch.zeros((S, 2 * nmax), dtype=torch.int64, device=dev)
    ST = torch.full((S, 2 * nmax), -1, dtype=i32, device=dev)  # -1: no event
    for s in range(S):
        lo, n = int(offsets[s]), int(sizes[s])
        A_s[s, :n] = a_s[lo:lo + n]
        A_e[s, :n] = a_e[lo:lo + n]
        SC[s, :n] = score[lo:lo + n]
        H[s, :2 * n] = ev_hit[2 * lo:2 * lo + 2 * n]
        ST[s, :2 * n] = ev_isstart[2 * lo:2 * lo + 2 * n]
    idx = torch.arange(nmax, device=dev)[None, :]
    sofar = torch.zeros((S, nmax), dtype=torch.float32, device=dev)
    bk = torch.full((S, nmax), -1, dtype=i32, device=dev)
    alive = torch.zeros((S, nmax), dtype=torch.bool, device=dev)
    neg = float(NEG)
    for e in range(2 * nmax):
        h = H[:, e:e + 1]
        is_start = ST[:, e] == 1
        is_end = ST[:, e] == 0
        ae_h = A_e.gather(1, h)
        key = torch.where(is_start[:, None], A_s.gather(1, h), ae_h)
        # find_lt(key)
        mask = alive & (A_e < key)
        any_m = mask.any(1)
        m_a = torch.where(mask, A_e, IMIN).max(1, keepdim=True).values
        mask_a = mask & (A_e == m_a)
        hs = torch.where(mask_a, sofar, neg).max(1).values
        p = (mask_a & (sofar == hs[:, None])).to(torch.uint8).argmax(1)
        sofar_h = sofar.gather(1, h)[:, 0]
        # a start event
        chain = any_m & (hs > 0)
        new_sofar = SC.gather(1, h)[:, 0] + torch.where(chain, hs, 0.0)
        sofar.scatter_(1, h, torch.where(is_start, new_sofar,
                                         sofar_h)[:, None])
        bk.scatter_(1, h, torch.where(
            is_start, torch.where(chain, p, -1).to(i32),
            bk.gather(1, h)[:, 0])[:, None])
        # an end event
        refuse = any_m & (hs > sofar_h)
        kill = (alive & (A_e >= ae_h) & (sofar <= sofar_h[:, None])
                & (idx != h) & (is_end & ~refuse)[:, None])
        alive = alive & ~kill
        alive.scatter_(1, h, torch.where(is_end, ~refuse,
                                         alive.gather(1, h)[:, 0])[:, None])
    # final pick: max sofar among ALIVE entries, smallest a_e on ties
    m1 = torch.where(alive, sofar, neg).max(1).values
    mask2 = alive & (sofar == m1[:, None])
    m2 = torch.where(mask2, A_e, IMAX).min(1, keepdim=True).values
    best = (mask2 & (A_e == m2)).to(torch.uint8).argmax(1).to(i32)
    keep = torch.from_numpy(np.arange(nmax)[None, :] < sizes[:, None]).to(dev)
    return sofar[keep], bk[keep], best, m1


def staircase_order(a_e: np.ndarray, ev_hit: np.ndarray,
                    ev_isstart: np.ndarray) -> np.ndarray:
    """The hits of one set in the staircase's rank order: by a_e, then by
    their end events, the later first."""
    end_at = np.empty(len(a_e), np.int64)
    ends = np.flatnonzero(ev_isstart == 0)
    end_at[ev_hit[ends]] = ends
    return np.lexsort((-end_at, a_e))


def sweep_staircase_plain(a_s: torch.Tensor, a_e: torch.Tensor,
                          score: torch.Tensor, ev_hit: torch.Tensor,
                          ev_isstart: torch.Tensor, offsets: np.ndarray):
    """k_anchors_sweep's algebra (the sets of more than WARP_HITS hits) on
    the host, for the tests: the contract of sweep_plain on events where
    each hit has one start and one end, the start first.

    The hits are ranked by (a_e, end event, the later first).  Among alive
    hits sofar then does not fall along the ranks: across a_e by the
    skiplist's invariant, and inside a tie group because an insertion
    kills the group's members at or below its own sofar and ranks before
    the survivors.  So find_lt(key) is the last alive rank below the key's
    rank (the hits with a_e < key), an unrefused end kills the alive ranks
    from its own group's first rank on while their sofar is at most its
    own (a prefix), and the final pick is the first alive rank that holds
    the largest sofar."""
    dev = a_s.device
    a_s, a_e, score, ev_hit, ev_isstart = (
        t.cpu().numpy() for t in (a_s, a_e, score, ev_hit, ev_isstart))
    S = len(offsets) - 1
    sofar_out = np.zeros(a_s.shape[0], np.float32)
    bk_out = np.full(a_s.shape[0], -1, np.int32)
    best = np.zeros(S, np.int32)
    best_val = np.full(S, NEG, np.float32)
    zero = np.float32(0)
    for s in range(S):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        n = hi - lo
        eh, es = ev_hit[2 * lo:2 * hi], ev_isstart[2 * lo:2 * hi]
        ae, sc = a_e[lo:hi], score[lo:hi]
        order = staircase_order(ae, eh, es)
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n)
        keys = np.where(es == 1, a_s[lo:hi][eh], ae[eh])
        K = np.searchsorted(ae[order], keys, side="left")
        alive = np.zeros(n, bool)  # by rank
        sofar = np.zeros(n, np.float32)  # by rank
        bk = np.full(n, -1, np.int64)  # by hit, a rank
        for e in range(2 * n):
            h, k, r = int(eh[e]), int(K[e]), int(rank[eh[e]])
            below = np.flatnonzero(alive[:k])
            p = int(below[-1]) if below.size else -1
            hs = sofar[p] if p >= 0 else NEG
            if es[e] == 1:
                chain = p >= 0 and hs > 0
                sofar[r] = sc[h] + (hs if chain else zero)
                bk[h] = p if chain else -1
            elif not (p >= 0 and hs > sofar[r]):
                at = k + np.flatnonzero(alive[k:])
                above = sofar[at] > sofar[r]
                alive[at[:int(above.argmax()) if above.any() else at.size]] = (
                    False)
                alive[r] = True
        sofar_out[lo:hi] = sofar[rank]
        bk_out[lo:hi] = np.where(bk >= 0, order[np.maximum(bk, 0)], -1)
        if alive.any():
            top = sofar[alive].max()
            best[s] = order[int(np.flatnonzero(alive & (sofar == top))[0])]
            best_val[s] = top
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (sofar_out, bk_out, best, best_val))


def build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the kernel library."""
    lib = nvcc.load("anchors_sweep")
    void_p, c_int = ctypes.c_void_p, ctypes.c_int
    lib.anchors_sweep_launch.restype = c_int
    lib.anchors_sweep_launch.argtypes = (
        [void_p] * 6 + [c_int] * 3 + [void_p] * 6)
    lib.anchors_sweep_scratch_bytes.restype = ctypes.c_longlong
    lib.anchors_sweep_scratch_bytes.argtypes = [ctypes.c_longlong, c_int]
    lib.anchors_sweep_warp_launch.restype = c_int
    lib.anchors_sweep_warp_launch.argtypes = (
        [void_p] * 6 + [c_int] + [void_p] * 5)
    return lib


def sweep_packed(a_s: torch.Tensor, a_e: torch.Tensor, score: torch.Tensor,
                 ev_hit: torch.Tensor, ev_isstart: torch.Tensor,
                 offsets: np.ndarray):
    """Same contract as sweep_plain.  CPU tensors run the plain version;
    CUDA tensors launch the kernels on the current stream: one launch for
    the sets of at most WARP_HITS hits (a warp each), one for the larger
    (a block each), which needs one start and one later end event a hit
    (as event_order gives them; ``sweep`` checks)."""
    dev = a_s.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sweep_packed: unsupported device {dev}")
    N = a_s.shape[0]
    for t, dtype, n in ((a_s, torch.int32, N), (a_e, torch.int32, N),
                        (score, torch.float32, N),
                        (ev_hit, torch.int32, 2 * N),
                        (ev_isstart, torch.int32, 2 * N)):
        if (t.device != dev or t.dtype != dtype or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError("sweep_packed: a_s, a_e int32 [N], score "
                             "float32 [N], events int32 [2N], contiguous, "
                             "on one device")
    if (offsets.dtype != np.int64 or offsets.ndim != 1 or len(offsets) < 2
            or offsets[0] != 0 or offsets[-1] != N
            or np.diff(offsets).min() < 1):
        raise ValueError("sweep_packed: offsets must be int64 [S + 1] from "
                         "0 to N, every set with a hit")
    if dev.type == "cpu":
        return sweep_plain(a_s, a_e, score, ev_hit, ev_isstart, offsets)
    S = len(offsets) - 1
    lib = build()
    sizes = np.diff(offsets)
    small = np.flatnonzero(sizes <= WARP_HITS)
    large = np.flatnonzero(sizes > WARP_HITS)
    # one upload: (first hit, one past the last, number) of each set, the
    # small sets first
    order = np.concatenate([small, large])
    spans = torch.from_numpy(np.stack(
        [offsets[order], offsets[order + 1], order], axis=1)).to(dev)
    sofar = torch.empty(N, dtype=torch.float32, device=dev)
    bk = torch.empty(N, dtype=torch.int32, device=dev)
    best = torch.empty(S, dtype=torch.int32, device=dev)
    best_val = torch.empty(S, dtype=torch.float32, device=dev)
    ins = [t.data_ptr() for t in (a_s, a_e, score, ev_hit, ev_isstart)]
    outs = [t.data_ptr() for t in (sofar, bk, best, best_val)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if small.size:
        err = lib.anchors_sweep_warp_launch(*ins, spans.data_ptr(),
                                            small.size, *outs, stream)
        if err != 0:
            raise RuntimeError("anchors_sweep_warp_launch failed: CUDA "
                               f"error {err}")
        note_launch("anchors_sweep")
    if large.size:
        scratch = torch.empty(
            lib.anchors_sweep_scratch_bytes(N, large.size), dtype=torch.uint8,
            device=dev)
        err = lib.anchors_sweep_launch(
            *ins, spans.data_ptr() + 24 * small.size, large.size,
            int(sizes[large].max()), SHARED_HITS, scratch.data_ptr(), *outs,
            stream)
        if err != 0:
            raise RuntimeError(f"anchors_sweep_launch failed: CUDA error {err}")
        note_launch("anchors_sweep")
    return sofar, bk, best, best_val


def sweep(sets: list[tuple], device: torch.device
          ) -> list[tuple[np.ndarray, np.ndarray, int, float]]:
    """(sofar, bk, best, best_val) of each (a_s, a_e, score, ev_hit,
    ev_isstart): one upload (the five columns as one int32 buffer), one
    call of sweep_packed, one download."""
    if not sets:
        return []
    offsets = np.zeros(len(sets) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s[0]) for s in sets])
    N, S = int(offsets[-1]), len(sets)
    dtypes = (np.int32, np.int32, np.float32, np.int32, np.int32)
    for s in sets:
        if len(s[0]) > WARP_HITS:
            check_events(np.asarray(s[3]), np.asarray(s[4]))
    packed = torch.from_numpy(np.concatenate(
        [np.asarray(s[c], dtype=dt).view(np.int32)
         for c, dt in enumerate(dtypes) for s in sets])).to(device)
    a_s, a_e, score, ev_hit, ev_isstart = packed.split([N, N, N, 2 * N, 2 * N])
    out = sweep_packed(a_s, a_e, score.view(torch.float32), ev_hit,
                       ev_isstart, offsets)
    flat = torch.cat([t.view(torch.int32) for t in out]).cpu().numpy()
    sofar, bk = flat[:N].view(np.float32), flat[N:2 * N]
    best, best_val = flat[2 * N:2 * N + S], flat[2 * N + S:].view(np.float32)
    return [(sofar[lo:hi], bk[lo:hi], int(best[s]), float(best_val[s]))
            for s, (lo, hi) in enumerate(zip(offsets, offsets[1:]))]


def check_events(ev_hit: np.ndarray, ev_isstart: np.ndarray) -> None:
    """Raises unless the 2n events of one set hold one start and one later
    end of each of its n hits (the block form's precondition)."""
    n = ev_hit.shape[0] // 2
    ok = (ev_hit.shape == ev_isstart.shape == (2 * n,)
          and bool(np.isin(ev_isstart, (0, 1)).all())
          and bool(((ev_hit >= 0) & (ev_hit < n)).all()))
    if ok:
        slot = 2 * ev_hit.astype(np.int64) + ev_isstart
        at = np.empty(2 * n, np.int64)
        at[slot] = np.arange(2 * n)
        ok = bool((np.bincount(slot, minlength=2 * n) == 1).all()
                  and (at[1::2] < at[0::2]).all())
    if not ok:
        raise ValueError("sweep: each hit needs one start event and one "
                         "later end event")


def event_order(b_s: np.ndarray, b_e: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """(ev_hit, ev_isstart) int32 [2n]: the event array in list order
    (start, end interleaved per hit), stable-sorted by (number,
    starts-first), then runs of equal end events reversed (glibc msort
    under the reference's inconsistent comparator, anchors.c:45-58)."""
    n = len(b_s)
    ev_num = np.empty(2 * n, dtype=np.int64)
    ev_st = np.empty(2 * n, dtype=np.int32)
    ev_h = np.empty(2 * n, dtype=np.int32)
    ev_num[0::2] = b_s
    ev_num[1::2] = b_e
    ev_st[0::2] = 1
    ev_st[1::2] = 0
    ev_h[0::2] = np.arange(n)
    ev_h[1::2] = np.arange(n)
    key = ev_num * 2 + (1 - ev_st)  # starts first at equal number
    perm = np.argsort(key, kind="stable")
    ev_num, ev_st, ev_h = ev_num[perm], ev_st[perm], ev_h[perm]
    # reverse runs of equal (number, end)
    i = 0
    while i < 2 * n:
        j = i + 1
        while (j < 2 * n and ev_num[j] == ev_num[i]
               and ev_st[j] == ev_st[i]):
            j += 1
        if ev_st[i] == 0 and j - i > 1:
            ev_h[i:j] = ev_h[i:j][::-1]
        i = j
    return ev_h, ev_st


class _Hits:
    """The parsed hits of one anchors input, in list order (reverse file
    order: parseCHAOS prepends), with each hit's chunks."""
    __slots__ = ("order", "a_s", "a_e", "b_s", "b_e", "score", "chunks")


def parse_hits(hits_text: str, gfc: bool = True) -> _Hits | None:
    """The hits of a chaos output; None when it holds none."""
    hits = []       # (a_s, a_e, b_s, b_e, score) in file order
    chunks = []     # per hit, reversed file order
    pending = -1
    for line in hits_text.split("\n"):
        if gfc and pending >= 0:
            c = parse_chunk(line)
            if c is not None:
                chunks[pending].insert(0, c)
                continue
        t = parse_hit(line)
        if t is not None:
            hits.append(t)
            chunks.append([])
            pending = len(hits) - 1 if gfc else -1
    if not hits:
        return None
    out = _Hits()
    n = len(hits)
    # list order = reverse file order (parseCHAOS prepends)
    out.order = list(range(n - 1, -1, -1))
    cols = list(zip(*(hits[i] for i in out.order)))
    out.a_s, out.a_e, out.b_s, out.b_e = (
        np.asarray(c, dtype=np.int32) for c in cols[:4])
    out.score = np.asarray(cols[4], dtype=np.float32)
    out.chunks = chunks
    return out


def _anchors_text(hits: _Hits, gfc: bool, bk: np.ndarray, best: int,
                  best_val: float) -> str:
    """doOutput (anchors.c:167-191): walk the chain, expanding chunks.
    The reference's final pick starts from best = -1 with a strict '>', so
    a run whose every chain scores <= -1 emits nothing."""
    out = []
    t = best if best_val > -1 else -1
    while t >= 0:
        ch = hits.chunks[hits.order[t]]  # file-order index
        if not gfc or not ch:
            out.append("(%d %d)=(%d %d) %f\n"
                       % (hits.a_s[t], hits.a_e[t], hits.b_s[t], hits.b_e[t],
                          float(hits.score[t])))
        else:
            for (y, x, length, sc) in ch:
                out.append("(%d %d)=(%d %d) %d\n"
                           % (y, y + length - 1, x, x + length - 1, sc))
        t = int(bk[t])
    return "".join(out)


def anchors_text_device_batch(texts: list[str], gfc: bool = True,
                              device: torch.device = torch.device("cpu")
                              ) -> list[str | None]:
    """anchors_text_device of each text, the sweeps of all of them in one
    call of ``sweep``: one upload, one launch a class of set sizes, one
    download."""
    results: list[str | None] = [""] * len(texts)
    parsed, sets = [], []
    with timings.phase("anchors_parse"):
        for i, text in enumerate(texts):
            hits = parse_hits(text, gfc)
            if hits is None:
                continue
            if np.any(hits.b_e < hits.b_s):
                results[i] = None  # precondition (see module docstring)
                continue
            ev_h, ev_st = event_order(hits.b_s, hits.b_e)
            parsed.append((i, hits))
            sets.append((hits.a_s, hits.a_e, hits.score, ev_h, ev_st))
            HITS_PER_SWEEP.append(len(hits.order))
            timings.add("anchors_sweeps", 1)
    if sets:
        with timings.phase("anchors_device"):
            swept = sweep(sets, device)
        with timings.phase("anchors_parse"):
            for (i, hits), (_sofar, bk, best, best_val) in zip(parsed, swept):
                results[i] = _anchors_text(hits, gfc, bk, best, best_val)
    return results


def anchors_text_device(hits_text: str, gfc: bool = True,
                        device: torch.device = torch.device("cpu")
                        ) -> str | None:
    """Device-backed twin of native lagan_anchors (anchors.c semantics);
    None when the input violates the frozen-sofar precondition (caller
    falls back to the native stage)."""
    return anchors_text_device_batch([hits_text], gfc, device)[0]
