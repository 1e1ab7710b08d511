#!/usr/bin/env python3
"""Drive the PyTorch port (sibelia_tpu_torch) on one CUDA card and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # the smoke run below
    python3 chip_smoke.py --kernels        # phases 1-3c only: build and check
    python3 chip_smoke.py --profile DIR    # step breakdown of phase 4 only
    python3 chip_smoke.py --cards          # phase 4c's CLI runs over cards
    python3 chip_smoke.py --memory         # the card's peak up to the rule
    python3 chip_smoke.py --trim           # phase 4d only: trim rounds
    python3 chip_smoke.py --parent DIR     # the smoke run; phases order,
                                           # anchors and csibelia_exact time
                                           # DIR's band DP, walks and sweep,
                                           # phase tools its draft_assemble
                                           # and sweep,
                                           # phase memory its -s loose and
                                           # phase 4's enumeration, beside
                                           # this tree's

It imports the port alone: the run fails if ``jax``, ``jaxlib`` or the JAX
package ``sibelia_tpu`` was imported by the end.  The port builds its CUDA
kernels (nvcc) and its native C++ host libraries (g++) from its own sources.

Phases, each of which fails the run:
  1. build    torch/CUDA versions, the card's name and power limit, and the
              four kernel libraries built from kernels/csrc/*.cu, one nvcc
              each, started together;
  2. kernel   the segment scan kernel against its plain PyTorch version on
              the card, bit-equal, at random segment lengths 1-300 for n in
              {1, 1000, 32768+7, 2^22+13}, one segment of 2^20 rows, a
              k == 32 all-T case and the main path's shapes (the 32 MB input
              below at k = 30, and at k = 5000 by prefix doubling), with nv
              in {0, n, inside a segment}; then the edge cases of
              ``scan_edge_cases`` at the kernel's tile (n = 1, n around one
              tile, n not a multiple of 4, one segment over all rows, every
              row its own segment, segments of exactly one tile, a verdict
              flag on the first or last row only, nv on a tile boundary),
              each also on columns whose base pointer is 4 bytes past a
              16-byte boundary; the shapes of trim_blocks' enumerations
              (TRIM_ROWS: 1 to 2,838,317 rows of two related copies at
              k = 30); kernel and plain times beside each other, and the
              kernel's bound (24 B/row at 3.35 TB/s);
  3. gotoh    the Gotoh kernel against its plain versions at B in {1, 7, 8,
              1000, 4096} for T = 128 and at B = 64 for T in {16, 37}:
              related and unrelated pairs of lengths 1..T, n = m = T, N and
              lowercase bytes, score ties.  Its plane-writing form (every
              length taken as T): all four planes bit-equal to the plain
              planes.  The kernel itself: both aligned rows equal up to each
              pair's alignment length, and the lengths equal, to the plain
              planes followed by the batched plain traceback; also on 1 x T
              and T x 1 pairs, unrelated pairs (long gaps in both rows), a
              batch of 1 x 1 pairs, and one and 1545 unrelated 128 x 128
              pairs (the longest chain a batch can hold).  Times of the
              kernel and of its plane-writing form (a call replayed from a
              CUDA graph, and enqueued by the host) and of the plain version
              (B = 4096, T = 128 is the reference), the kernel's bound from
              these pairs' lengths, and the bytes a pair that cross PCIe;
  3b. order   the order stage's three kernels against their plain versions:
              the band DP's pointer bytes inside the band bit-equal, at wmax
              in {16, 32 (a warp a pair, the band in registers), 64, 128,
              256 (a warp a pair, 2 to 8 lanes a thread in registers), 1024,
              2048, 4096 (a block a pair, 8 lanes a thread in registers),
              8192 (a block a pair of producer and chain warps, the band in
              shared memory)}, three wmax-1024 pairs side by side, nd from
              2 up,
              necks, '.' and N codes, a walk that stops off the band, eleven
              ragged pairs (more than a block's warps) and ragged batches of
              them in one call;
              the traceback's moves and counts equal to ``order_moves_plain``
              and the params made on the card equal to the host's, on every
              case; the -mfa text of ``order_mfa_device_batch`` on the card
              equal to native ``lagan_order`` on every pair and on two 200
              kbp pairs (wmax 32), whose band DP (us a diagonal) and
              traceback are timed apart (no plain DP there: it costs a
              Python step a diagonal), the narrow walk also in segments of
              256 to 2048 rows and, with ``--parent DIR``, beside DIR's
              walk in turns, moves equal, with the longest walk's steps;
              kernel and plain times, bounds and bytes of every case; the
              wide forms on bands the size of the matrix (no anchor, as a
              draft contig's wrong strand) at wmax 64 to 8192 and eight
              pairs of 4096 in one launch, us a diagonal and a step, with
              ``--parent DIR`` beside DIR's forms (built from its source, in
              turns, pointer bytes and moves equal);
  3c. anchors the anchors stage's sweep kernels against their plain PyTorch
              version, sofar, bk, best and best_val bit-equal, at n in {1,
              2, 13, 32 (a warp a set), 33, 60, 1000, one above the
              shared-memory limit (a block a set)}, tie-heavy sets, 200 sets
              of 1-13 hits in one launch (the shape of an exact run's
              level), a mixed list of small and large sets in one call;
              ``anchors_text_device`` on the card equal to native
              ``lagan_anchors`` on real chaos hits; times of the kernels
              (n = 13 also replayed from a CUDA graph), the plain version
              and the native sweep on the same set, and the bound; the
              block form timed at n in {33, 60, 256, 1000, 24,001}, with
              ``--parent DIR`` beside DIR's in turns, every output equal;
  4. enum     enumeration at k = 30, min_branch = 150 of 16 synthetic
              strains x 2 Mbp (about 64 M supergenome rows): the port on the
              card against the port on the CPU (plain versions), every
              field and the candidate bitmap identical;
  4b. enum_k  enumeration of the same input at k in {100, 5000}, the first
              and last of the loose preset's k > 32 values, by prefix
              doubling: the port on
              the card against the port's host native enumeration
              (native/ranking.cpp, which the CPU tests hold to the JAX
              package's), every field identical;
              card and host seconds, and a step run with ms per doubling
              round;
  4c. sharded the sharded enumeration (``parallel/sharded_enum.py``) of the
              phase 4 input at k = 30 and k = 100 on meshes of one and four
              shards of cuda:0, every field and dtype equal to the
              single-card enumeration, one segment scan launch a shard,
              with its ms, bytes between shards and blocking copies, and
              at k = 30 the CUDA kernels and device time of a call; the
              sharded prefilter on four shards of the card equal to four
              CPU shards and a superset of ``candidate_scan`` (4 x 2 Mbp,
              k = 30); (a) at k = 30 through an NCCL group of one rank
              (``seq_mesh``); with two cards or more, the -s loose CLI
              under SIBELIA_TPU_SHARDED=<cards> and as two NCCL processes,
              byte-identical to one card; and ``order_mfa_device_batch``
              over a pair mesh of two shards of the card on phase 3b's
              jobs, the unsharded call's text;
  4d. trim    the crossover of trim_blocks' rounds: ms a round (the
              enumeration and the walk) by the numpy route, the native
              round (the host route) and the card's enumeration with the
              native walk, on two related copies of 1 to 2,838,317 rows
              (CROSSOVER_ROWS), identical results, with the CUDA kernels a
              card call launches and their device time;
  5. e2e      ``sibelia_tpu_torch.cli.sibelia -s loose -m 5000`` on 4 strains
              x 2 Mbp on the card against the same CLI on the CPU
              (``SIBELIA_TPU_TORCH_DEVICE=cpu``): every output file
              byte-identical, with the re-prefilter call count of the
              card's run above 0, trim enumerations on the card
              (``trim_card_calls``) and at least 5 + trim_card_calls
              segment scan launches (the four stages, the final block
              generation and those); the block_trim split; then -g
              --allstages with --checkpoint on two 100 kbp strains, card
              against CPU, every .dot file identical, and the run resumed
              from its second-last checkpoint, identical; and one untimed
              run under SIBELIA_TPU_PROFILE_DIR, files identical, with the
              card's busy share of its trace's window;
  5b. memory the card's peak (allocated and reserved, from an emptied
              allocator) of one single-card enumeration at k = 30 (with
              min_branch, so the candidate prefilter runs), 100 and 5000 on
              4, 8 and 16 of the phase 4 strains, the fitted bytes a row
              and their extrapolation to 2^30 - 1 rows against the card's
              memory; the same calls with the card filled to leave the
              size rule's fitted peak (``index/enumeration.py::
              card_peak_bytes``), each finished with its reserved peak
              under it; the route the rule picks at 2^30 - 1 rows, and the
              rule's host route on 4 strains (1 GiB left) equal to the
              card's enumeration; -s loose on 4 and 8 strains with an 8 GiB
              slab, each stage's carve, the run's at least the card route's
              slab; then -s loose on the phase 5 input in a process of its
              own: wall, slab_reserve, engine_sweep, slab bytes mapped and
              carved, files equal to phase 5's CPU run.  With ``--parent
              DIR`` the port of the tree at DIR runs beside it (parent,
              here, here, parent, twice), and phase 4's enumeration in
              processes of their own (parent, here, here, parent);
  6. csibelia ``sibelia_tpu_torch.cli.csibelia ref.fasta asm.fasta --maf``
              with the fast aligner and device gap batching
              (``SIBELIA_TPU_ALIGNER=fast SIBELIA_TPU_DEVICE_ALIGN=1``) and
              the CLI's defaults (-s fine -m 500 -i 4) on a 1.4 Mbp
              reference strain against a second strain of the same base cut
              into contigs of 20-200 kbp (half the size of C-Sibelia's S.
              aureus example; phase 7 runs the whole size): on the card and
              on the CPU, variant.vcf and
              alignment.maf byte-identical, both kernels launched on the
              card, the segment scan at least 7 + trim_card_calls times
              (three stages, their three block generations, the final one
              and the trim enumerations on the card, of which there are
              some); the block_trim split of both runs; the histogram of
              the run's gap lengths; then the Gotoh kernel against its plain
              versions on the run's largest gap batch, rows and planes;
  7. csibelia_exact  the same CLI on a 2.8 Mbp pair made the same way (the
              size of C-Sibelia's S. aureus example) with NO aligner switch
              set: the default, exact LAGAN mode, which on the card means
              every level's anchors sweeps in one call and every band DP
              with its traceback there.  On the card and with
              ``SIBELIA_TPU_TORCH_DEVICE=cpu`` (the native stages):
              variant.vcf and alignment.maf byte-identical; the segment
              scan and the block_trim split as in phase 6; ``order_band``,
              ``order_moves``, ``band_params`` and ``anchors_sweep``
              launched, the last at most twice a recursion level; no host
              fallback; the bytes that came back under a tenth of the
              pointer rows; every pair's -mfa text equal to native
              ``lagan_order``; the run's (nd, wmax) and hits-a-sweep
              histograms and the phase seconds of both runs; then the
              kernels again on what the run gave them: the band DP, the
              traceback and the params on its largest batch (timed, moves
              and params against their plain versions; the batch's longest
              pair alone beside it; its narrow walk in segments of 256 to
              2048 rows and, with ``--parent DIR``, beside DIR's) and the
              band DP against the plain version on that batch's pairs of at
              most 6,000 diagonals; the sweep on the level with the most hits
              against the plain version, with the native sweep's time
              beside it;
  8. tools    the modules no port CLI reached before: (a) the -s loose CLI
              under SIBELIA_TPU_NATIVE=0 (the Python engine) on 2 x 200 kbp,
              card against CPU and against the card's native-engine run,
              every file identical, at least 5 segment scan launches; (b)
              SIBELIA_TPU_CHECK=1 on 2 x 5 kbp (the invariant check after
              every collapse), card against CPU; (c) ``draft_assemble`` of
              10 contigs (3 reverse-complemented) against a 40 kbp finished
              strain, (d) ``slagan_pairwise`` on a 200 kbp pair with an
              inversion and a translocation, (e) ``prolagan_fasta`` on two
              profiles of two 20 kbp sequences: each on the card equal to
              the CPU's native stages, no host fallback, the anchors sweep
              (at most twice a level in (e)) and in (c) and (d) the band DP,
              the traceback and the params kernels launched; seconds of
              every run; for (c), (d), (e) the exact aligner's phases card /
              CPU, every band DP's (nd, wmax), the launches of the warp and
              the wide forms and the sweep's sets by hits; (e)'s sweep
              calls (a recursion level's sets each) timed; with ``--parent
              DIR``, (c) also in processes of its own, parent, here, here,
              parent, and (e)'s sweep calls beside DIR's sweep.  Each run's
              launches are counted from 0 and added to the kernels line
              (the narrow walk's three kernels count as one launch of
              ``order_moves``, as the wide band DP's two of
              ``order_band``).

``--memory`` runs phase 1, then the peaks of phase 5b's three k classes on
16, 32, 64, 128, 135 and 197 strains of 2.1 Mbp (67 M to 827 M rows; the
last two near 0.95 of where the size rule sends k <= 32 and k > 32 to the
host), each call the rule keeps on the card finished, with its reserved
peak under the rule's where that is above 0.9 of what the card gives, and
their fit; with ``--parent DIR``, -s loose on 32 of those strains (where
the card route's slab passes 1 GiB), parent, here, here, parent.

``--profile DIR`` runs phase 1, then times each step of the port's k = 30
enumeration of the phase 4 input (a synchronise on each side of every
step, two repetitions after a warm-up) and a ``torch.profiler`` window over
one whole call; it prints the steps and writes the profiler's table to
DIR/prof_enum.txt.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260818
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")
MAIN_K, MAIN_MIN_BRANCH = 30, 150
MAIN_MIN_SIZE = 500  # a trim round's min_size: C-Sibelia's -m 500
# Peaks of one H100 SXM (NVIDIA's data sheet): device memory rate, and the
# float32 rate outside the tensor cores.  The data sheet lists no int32
# rate; the card's is lower, so a bound reckoned with this one still holds.
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12
ENUM_KS = (100, 5000)  # the first and last of the loose preset's k > 32
BIG_K = ENUM_KS[-1]
# supergenome rows of trim_blocks' per-block enumerations: one row (an
# empty block), C-Sibelia's median and p90 call (413, 1,093), the scan's
# tile edge, 2^16 and the largest calls of C-Sibelia (751,645) and of
# -s loose on 4 x 2 Mbp (2,838,317)
TRIM_ROWS = (1, 413, 1093, 4095, 4096, 4097, 65_536, 751_645, 2_838_317)
# the crossover table's sizes: TRIM_ROWS and odd sizes between the scan's
# tile and 2^16, where the host's numpy enumeration meets the card's
# fixed cost a call
CROSSOVER_ROWS = tuple(sorted(TRIM_ROWS + (6145, 8193, 12_289, 16_385,
                                           24_577, 32_769)))


def log(*parts) -> None:
    print(*parts, flush=True)


_PHASE_MARK = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Prints the seconds since the last phase ended (or the import)."""
    now = time.perf_counter()
    log(f"  phase {name} took {now - _PHASE_MARK[0]:.1f} s")
    _PHASE_MARK[0] = now


def make_strains(n_strains: int, size: int, seed: int) -> list[np.ndarray]:
    """The mutation mix of scripts/gen_strains.py, vectorised with numpy."""
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, size)]
    strains = []
    for _ in range(n_strains):
        s = base.copy()
        hit = np.flatnonzero(rng.random(size) < rng.uniform(0.005, 0.0075))
        s[hit] = ACGT[rng.integers(0, 4, hit.size)]
        for _ in range(int(rng.integers(20, 61))):
            pos, ln = int(rng.integers(len(s))), int(rng.integers(1, 31))
            if rng.random() < 0.5:
                s = np.concatenate([s[:pos], s[pos + ln:]])
            else:
                s = np.concatenate([s[:pos], ACGT[rng.integers(0, 4, ln)],
                                    s[pos:]])
        if len(s) > 200_000:
            for _ in range(int(rng.integers(1, 5))):
                a = int(rng.integers(len(s) - 50_000))
                b = a + int(rng.integers(10_000, 50_001))
                s[a:b] = COMP[s[a:b]][::-1]
            if rng.random() < 0.7:
                a = int(rng.integers(len(s) - 80_000))
                b = a + int(rng.integers(20_000, 60_001))
                chunk, rest = s[a:b], np.concatenate([s[:a], s[b:]])
                at = int(rng.integers(len(rest)))
                s = np.concatenate([rest[:at], chunk, rest[at:]])
        strains.append(s)
    return strains


def write_fasta(path: str, strains: list[np.ndarray],
                names: list[str] | None = None) -> None:
    with open(path, "w") as h:
        for i, s in enumerate(strains):
            h.write(f">{names[i] if names else f'strain_{i:02d}'}\n")
            text = s.tobytes().decode()
            for j in range(0, len(text), 80):
                h.write(text[j:j + 80] + "\n")


def timed(fn, device, reps: int, warm_s: float = 0.0) -> tuple[float, object]:
    """Mean milliseconds of fn() over reps runs after one warm-up (and as
    many more as fit into warm_s seconds: a card that sat idle through a
    host phase takes a while to clock up), with CUDA events on a card (host
    clock on the CPU), and the last result."""
    import torch
    t_warm = time.perf_counter()
    out = fn()
    while device.type == "cuda" and time.perf_counter() - t_warm < warm_s:
        out = fn()
        torch.cuda.synchronize()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / reps, out
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_graph(fn, reps: int = 20) -> float:
    """Mean device ms of fn() over reps calls captured into one CUDA graph
    and replayed: the calls run back to back on the card, so a kernel of a
    few microseconds is not hidden behind the host's time to enqueue it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2 --

def segment_columns(rng, n: int, lengths, device):
    """Sorted int32 columns with the given segment lengths (cycled)."""
    import torch
    reps = np.resize(np.asarray(lengths, dtype=np.int64), n)
    reps = reps[:np.searchsorted(np.cumsum(reps), n) + 1]
    reps[-1] -= reps.sum() - n
    key = np.repeat(np.arange(len(reps), dtype=np.int64), reps)[:n]
    cols = [key // 5, key, rng.integers(0, 64, n), rng.permutation(n)]
    return [torch.from_numpy(c.astype(np.int32)).to(device) for c in cols]


def nv_cases(sk1, sk2):
    """0, n, and a row inside a segment of several rows."""
    n = sk1.shape[0]
    same = ((sk1[1:] == sk1[:-1]) & (sk2[1:] == sk2[:-1])).nonzero()
    inner = int(same[same.shape[0] // 2, 0]) + 1 if same.shape[0] else n // 2
    return sorted({0, n, inner})


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least ms the card could take: each input read once and each
    output written once at the memory rate, or the operations at the
    plain float32 rate, whichever is larger; and which of the two."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PLAIN_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def scan_bound_ms(n: int) -> tuple[float, str]:
    """Four int32 columns read and two written, 24 B/row; about 20
    integer operations a row (two key compares, the verdict flag, three
    scan steps)."""
    return bound_ms(24 * n, 20 * n)


def gotoh_planes_bound_ms(B: int, T: int) -> tuple[float, str]:
    """The bound of the earlier kernel, which wrote planes: two uint8[B, T]
    code rows read, four int8[B, T, T] planes written; about 20 integer
    operations a cell."""
    return bound_ms(2 * B * T + 4 * B * T * T, 20 * B * T * T)


def gotoh_bound_ms(n, m, L, T: int, dirs: bool = False) -> tuple[float, str]:
    """n, m: each pair's lengths; L: its alignment length.  Read: n + m
    bytes and two int32 lengths a pair; written: two rows of L bytes and
    one int32 (and T * T bytes a pair by the plane-writing form); about 20
    integer operations a DP cell, n * m cells a pair
    (kernels/csrc/gotoh.cu)."""
    n, m, L = (np.asarray(x, dtype=np.int64) for x in (n, m, L))
    n_bytes = int((n + m + 2 * L + 12).sum()) + (n.size * T * T if dirs else 0)
    return bound_ms(n_bytes, 20 * int((n * m).sum()))


def pcie_bytes_a_pair(T: int) -> tuple[int, int]:
    """Bytes a pair that cross PCIe in one gap batch: (with the planes
    downloaded, as before; with the rows, as now).  Both upload the codes;
    the rows' form adds three int32 lengths."""
    return 2 * T + 4 * T * T, 2 * T + 8 + 4 * T + 4


QUIET = 9  # an aux value that sets no verdict flag when its neighbours agree


def scan_edge_cases(tile: int, seed: int = SEED):
    """The segment scan's edge cases around a tile of `tile` rows: a list of
    (name, [k1, k2, aux, order] int32 numpy columns, nv values).  `quiet`
    columns set the verdict flag on the listed rows only, so a verdict has
    to travel the length of its segment, across tiles, in either
    direction."""
    rng = np.random.default_rng(seed)

    def case(name, lengths, nvs, hits=None):
        lengths = np.asarray(lengths, dtype=np.int64)
        n = int(lengths.sum())
        key = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
        if hits is None:
            aux = rng.integers(0, 64, n)
        else:
            aux = np.full(n, QUIET)
            aux[np.asarray(hits, dtype=np.int64)] = 0
        cols = [key // 5, key, aux, rng.permutation(n)]
        return (name, [c.astype(np.int32) for c in cols],
                sorted({nv for nv in nvs if 0 <= nv <= n}))

    def random_lengths(n, longest):
        lengths = rng.integers(1, longest + 1, n)
        lengths = lengths[:np.searchsorted(np.cumsum(lengths), n) + 1]
        lengths[-1] -= lengths.sum() - n
        return lengths

    out = [case("n = 1", [1], (0, 1))]
    for n in (tile - 1, tile, tile + 1):
        out.append(case(f"n = {n}, lengths 1-7", random_lengths(n, 7),
                        (0, n, n // 2)))
    n = 2 * tile + 3
    out.append(case("n % 4 = 3, quiet, lengths 1-300", random_lengths(n, 300),
                    (0, n, tile, tile + 1),
                    hits=rng.integers(0, n, max(1, n // 500))))
    n = 3 * tile + 5
    for what, hits in (("no flag", []), ("flag on row 0", [0]),
                       ("flag on the last row", [n - 1]),
                       ("flag mid-way", [n // 2])):
        out.append(case(f"one segment of {n} rows, {what}", [n],
                        (0, n, tile, 2 * tile, n // 2), hits=hits))
    n = 2 * tile + 1
    out.append(case("every row its own segment", np.ones(n, np.int64),
                    (0, n, tile, 17)))
    for what, hits in (("middle", [tile + tile // 2]), ("first row", [tile]),
                       ("last row", [2 * tile - 1]),
                       ("rows either side", [tile - 1, 2 * tile])):
        out.append(case(f"segments of one tile, flag in the second: {what}",
                        [tile, tile, tile, 5],
                        (0, 3 * tile + 5, tile, 2 * tile), hits=hits))
    out.append(case("segments astride the tiles, quiet",
                    [tile // 2, tile, tile, 3],
                    (0, 2 * tile + tile // 2 + 3, tile, tile // 2),
                    hits=[tile // 2 + 1, 2 * tile + tile // 2 + 1]))
    return out


def off_boundary(t):
    """A contiguous copy of `t` whose first element lies 4 bytes past a
    16-byte boundary."""
    import torch
    padded = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    padded[1:] = t
    return padded[1:]


def trim_copies(rows: int, seed: int = SEED) -> list[np.ndarray]:
    """Two related copies (``make_strains``) whose supergenome has `rows`
    rows, or rows - 1 where `rows` is even (a supergenome, 1 + 2 (bases +
    copies) rows, never is); none below 7 rows."""
    if rows < 7:
        return []
    bases = (rows - 1) // 2 - 2
    a, b = make_strains(2, bases // 2 + 2000, seed)
    return [a[:bases // 2].copy(), b[:bases - bases // 2].copy()]


def trim_codes(rows: int) -> np.ndarray:
    """The codes of ``trim_copies(rows)``'s supergenome, with one more
    separator where `rows` is even: exactly `rows` rows."""
    from sibelia_tpu_torch.index.enumeration import build_supergenome
    copies = trim_copies(rows)
    codes = (build_supergenome(copies)[0] if copies
             else np.zeros(1, dtype=np.uint8))
    return np.concatenate([codes, np.zeros(rows - codes.shape[0], np.uint8)])


def compare_scan(name: str, cols, nv, device, reps: int) -> tuple[float, float, int]:
    """Kernel vs plain on one input: (kernel ms, plain ms, max |diff|);
    raises unless bit-equal."""
    from sibelia_tpu_torch.kernels.enum_scan import (enum_segment_scan,
                                                     enum_segment_scan_plain)
    n = cols[0].shape[0]
    ms, got = timed(lambda: enum_segment_scan(*cols, nv, n), device, reps)
    plain_ms, want = timed(lambda: enum_segment_scan_plain(*cols, nv, n),
                           device, reps)
    err = 0
    for a, b in zip(got, want):
        d = (a.to(dtype=b.dtype) - b).abs().max() if a.dim() else (a - b).abs()
        err = max(err, int(d))
    log(f"  {name}: n={n} nv={int(nv)} kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, max |diff| {err}")
    if err:
        raise RuntimeError(f"segment scan kernel disagrees with plain: {name}")
    return ms, plain_ms, err


def scan_breakdown(cols, nv, reps: int = 5) -> dict[str, float]:
    """Mean device ms of each CUDA kernel inside one segment scan call, from
    a torch.profiler window over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sibelia_tpu_torch.kernels.enum_scan import enum_segment_scan
    n = cols[0].shape[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            enum_segment_scan(*cols, nv, n)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and "::k_" in e.key:
            name = e.key.split("::")[-1].split("(")[0]
            out[name] = getattr(e, attr) / 1e3 / reps
    return out


def phase_kernel(device, main_codes, reps: int = 5) -> dict:
    """Kernel vs plain at every listed shape; the last timing row is the
    main path's shape."""
    import torch
    from sibelia_tpu_torch.index.enum_device import sorted_columns
    from sibelia_tpu_torch.index.enumeration import build_supergenome
    from sibelia_tpu_torch.kernels.enum_scan import TILE_ROWS
    rng = np.random.default_rng(SEED)
    max_err = 0
    for n in (1, 1000, 32768 + 7, (1 << 22) + 13):
        cols = segment_columns(rng, n, rng.integers(1, 301, n), device)
        for nv in nv_cases(cols[0], cols[1]):
            max_err = max(max_err, compare_scan("random 1-300", cols, nv,
                                                device, 1)[2])
    n = (1 << 20) + 1000
    cols = segment_columns(rng, n, [500, 1 << 20, 500], device)
    for nv in (0, n, 600 + (1 << 19)):
        max_err = max(max_err, compare_scan("one 2^20 segment", cols, nv,
                                            device, 1)[2])
    # k == 32: a real all-T window shares the invalid sentinel's keys
    chrom = np.concatenate([ACGT[rng.integers(0, 4, 5000)],
                            np.full(200, ord("T"), np.uint8),
                            ACGT[rng.integers(0, 4, 5000)]])
    codes, _ = build_supergenome([chrom, chrom[::-1].copy()])
    *cols, nv = sorted_columns(torch.from_numpy(codes).to(device), 32)
    max_err = max(max_err, compare_scan("k=32 all-T", cols, nv, device, 1)[2])
    for name, cols, nvs in scan_edge_cases(TILE_ROWS):
        cols = [torch.from_numpy(c).to(device) for c in cols]
        for at, cs in (("", cols),
                       (", off a 16-byte boundary",
                        [off_boundary(c) for c in cols])):
            if cs[0].data_ptr() % 16 != (4 if at else 0):
                raise RuntimeError("the columns are not placed as asked")
            for nv in nvs:
                max_err = max(max_err, compare_scan(name + at, cs, nv, device,
                                                    1)[2])
    from sibelia_tpu_torch.kernels.enum_scan import enum_segment_scan
    trim = {}
    for rows in TRIM_ROWS:
        *cols, nv = sorted_columns(torch.from_numpy(trim_codes(rows))
                                   .to(device), MAIN_K)
        ms, plain_ms, err = compare_scan(f"trim shape k={MAIN_K}", cols, nv,
                                         device, 5)
        max_err = max(max_err, err)
        graph_ms = timed_graph(lambda: enum_segment_scan(*cols, nv, rows))
        bound, bound_by = scan_bound_ms(rows)
        trim[rows] = {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}
        log(f"    replayed from a CUDA graph {graph_ms:.4f} ms; bound "
            f"{bound:.6f} ms by {bound_by}")
    *cols, nv = sorted_columns(main_codes, BIG_K)
    big_ms, big_plain_ms, big_err = compare_scan(
        f"main path k={BIG_K}", cols, nv, device, reps)
    del cols
    *cols, nv = sorted_columns(main_codes, MAIN_K)
    ms, plain_ms, err = compare_scan("main path k=30", cols, nv, device, reps)
    n = cols[0].shape[0]
    log("  inside one call at k=30 (torch.profiler, ms): " + ", ".join(
        f"{name} {t:.3f}" for name, t in scan_breakdown(cols, nv).items()))
    bound, bound_by = scan_bound_ms(n)
    log(f"  main path shape: n={n}, bound {bound:.3f} ms by {bound_by} "
        f"(24 B/row at {HBM_BYTES_PER_S / 1e12:g} TB/s), kernel at "
        f"{bound / ms:.0%} of it")
    return {"max_abs_err": max(max_err, err, big_err), "ms": ms,
            "plain_ms": plain_ms, "big_ms": big_ms,
            "big_plain_ms": big_plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "trim": trim}


# ---------------------------------------------------------------- phase 3 --

GOTOH_T = 128  # the fast aligner's batch width (DEVICE_BATCH_T)
# exact score ties between alignments: the traceback's tie order decides
TIES = [(b"AA", b"A"), (b"ACA", b"AA"), (b"TTTT", b"TT"),
        (b"GATTACA", b"GATACA"), (b"ACGTACGT", b"ACGT")]
MIXED = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)  # N and lowercase


def gotoh_pairs(rng, B: int, T: int) -> list[tuple[bytes, bytes]]:
    """B pairs of lengths 1..T: related (point mutations, deletions) and
    unrelated in turn; every fourth n = m = T, every fourth with N and
    lowercase bytes; the score ties first."""
    pairs = [(a[:T], b[:T]) for a, b in TIES][:B]
    for x in range(B - len(pairs)):
        kind = x % 4
        alpha = MIXED if kind == 3 else ACGT
        n = T if kind == 0 else int(rng.integers(1, T + 1))
        a = alpha[rng.integers(0, len(alpha), n)]
        if kind in (0, 1):
            b = a.copy()
            hit = rng.integers(0, n, max(1, n // 10))
            b[hit] = alpha[rng.integers(0, len(alpha), hit.size)]
            if kind == 1 and n > 1:
                b = np.delete(b, rng.integers(0, n, max(1, n // 20)))
        else:
            b = alpha[rng.integers(0, len(alpha), int(rng.integers(1, T + 1)))]
        pairs.append((a.tobytes(), b.tobytes()))
    return pairs


def gotoh_row_cases(rng, T: int) -> list[tuple[str, list]]:
    """Batches beside gotoh_pairs' mix: one byte against T bytes and the
    reverse, unrelated pairs (long gaps in both rows), and 1 x 1 pairs."""
    def seq(alpha, n):
        return alpha[rng.integers(0, len(alpha), n)].tobytes()

    return [
        ("1 x T and T x 1", [(seq(ACGT, 1), seq(ACGT, T)) for _ in range(9)]
         + [(seq(MIXED, T), seq(MIXED, 1)) for _ in range(9)]),
        ("unrelated pairs", [(seq(ACGT, int(rng.integers(1, T + 1))),
                              seq(ACGT, int(rng.integers(1, T + 1))))
                             for _ in range(300)]),
        ("every pair 1 x 1", [(seq(MIXED, 1), seq(MIXED, 1))
                              for _ in range(777)])]


def compare_gotoh(name: str, pairs, T: int, device, reps: int):
    """The kernel's plane-writing form vs the plain planes on one batch,
    every length taken as T: (launch ms, plain ms, max |diff|) over all
    four planes; raises unless bit-equal.  With reps > 1 the launch is
    timed by timed_graph."""
    import torch
    from sibelia_tpu_torch.kernels.gotoh import (batched_gotoh_dirs,
                                                 batched_gotoh_dirs_packed,
                                                 batched_gotoh_dirs_plain,
                                                 pack_codes)
    codes = torch.from_numpy(pack_codes(pairs, T)).to(device)
    a, b = codes[0], codes[1]
    ms, _ = timed(lambda: batched_gotoh_dirs_packed(a, b, T), device, reps)
    if reps > 1:
        ms = timed_graph(lambda: batched_gotoh_dirs_packed(a, b, T))
    got = batched_gotoh_dirs(a, b, T)
    plain_ms, want = timed(lambda: batched_gotoh_dirs_plain(a, b, T), device,
                           reps)
    if got.shape != (4, len(pairs), T, T) or got.dtype != torch.int8:
        raise RuntimeError(f"gotoh kernel output {got.dtype} {got.shape}")
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    log(f"  planes, {name}: B={len(pairs)} T={T} kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, max |diff| {err}")
    if err:
        raise RuntimeError(f"gotoh planes disagree with plain: {name}")
    return ms, plain_ms, err


def compare_gotoh_rows(name: str, pairs, T: int, device, reps: int) -> dict:
    """The kernel vs the plain version on one batch: both aligned rows up
    to each pair's alignment length, and the lengths; raises unless equal.
    Returns the times (with reps > 1 the kernel's by timed_graph), the
    largest difference and the kernel's bound for these pairs."""
    import torch
    from sibelia_tpu_torch.kernels.gotoh import (batch_align_rows,
                                                 batch_align_rows_plain,
                                                 pack_codes)
    B = len(pairs)
    codes = torch.from_numpy(pack_codes(pairs, T)).to(device)
    a, b = codes[0], codes[1]
    n = np.array([len(x) for x, _ in pairs])
    m = np.array([len(y) for _, y in pairs])
    lens = torch.from_numpy(np.stack([n, m]).astype(np.int32)).to(device)
    batch_align_rows(a, b, lens, T)  # once with the wrapper's length check
    ms, (rows, lengths) = timed(
        lambda: batch_align_rows(a, b, lens, T, check_lens=False), device,
        reps)
    plain_ms, (want, want_len) = timed(
        lambda: batch_align_rows_plain(a, b, lens, T), device, reps)
    if (rows.shape != (B, 2, 2 * T) or rows.dtype != torch.uint8
            or lengths.shape != (B,) or lengths.dtype != torch.int32):
        raise RuntimeError(f"gotoh kernel output {rows.dtype} {rows.shape}, "
                           f"{lengths.dtype} {lengths.shape}")
    upto = (torch.arange(2 * T, device=device)[None, :]
            < want_len[:, None])[:, None, :]
    err = max(int((lengths - want_len).abs().max()),
              int(((rows.to(torch.int32) - want.to(torch.int32)) * upto)
                  .abs().max()))
    L = want_len.cpu().numpy()
    bound, bound_by = gotoh_bound_ms(n, m, L, T)
    eager_ms = ms
    if reps > 1:
        # CUDA events around a few eager calls of so short a kernel show
        # the host's time to enqueue one; the graph's replay the card's
        ms = timed_graph(lambda: batch_align_rows(a, b, lens, T,
                                                  check_lens=False))
    log(f"  rows, {name}: B={B} T={T} kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, max |diff| {err}; cells {int((n * m).sum())}, "
        f"alignment columns {int(L.sum())}")
    if err:
        raise RuntimeError(f"gotoh rows disagree with plain: {name}")
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bound, "bound_by": bound_by}


def log_gotoh_times(name: str, B: int, T: int, rows: dict, dirs_ms: float,
                    gpu: str) -> None:
    """One batch's times beside its bounds: the kernel, its plane-writing
    form (every length and alignment length taken as T), the plain
    version; the earlier kernel's bound for the same B."""
    dirs_bound, dirs_by = gotoh_bound_ms(np.full(B, T), np.full(B, T),
                                         np.full(B, T), T, dirs=True)
    old_bound, old_by = gotoh_planes_bound_ms(B, T)
    before, now = pcie_bytes_a_pair(T)
    log(f"  {name}, B={B} T={T} ({gpu}): kernel {rows['ms']:.4f} ms a call "
        f"replayed from a CUDA graph ({rows['eager_ms']:.4f} ms a call "
        f"enqueued by the host), bound "
        f"{rows['bound_ms']:.6f} ms by {rows['bound_by']} "
        f"({rows['bound_ms'] / rows['ms']:.1%} of it; the row chain's "
        f"latency, which the bound does not see, decides); plane-writing "
        f"form {dirs_ms:.4f} ms, bound {dirs_bound:.6f} ms by {dirs_by} "
        f"({dirs_bound / dirs_ms:.0%}); plain {rows['plain_ms']:.3f} ms; the "
        f"earlier plane kernel's bound {old_bound:.4f} ms by {old_by}; "
        f"bytes a pair across PCIe {before} before, {now} now")


def phase_gotoh(device, gpu: str, reps: int = 5) -> dict:
    """Kernel vs plain, planes and rows, at every listed shape; the last is
    the reference."""
    rng = np.random.default_rng(SEED)
    max_err = 0
    for B, T in ((1, GOTOH_T), (7, GOTOH_T), (8, GOTOH_T), (1000, GOTOH_T),
                 (64, 16), (64, 37)):
        pairs = gotoh_pairs(rng, B, T)
        max_err = max(max_err,
                      compare_gotoh("random pairs", pairs, T, device, 1)[2],
                      compare_gotoh_rows("random pairs", pairs, T, device,
                                         1)["max_abs_err"])
    for T in (GOTOH_T, 16, 37):
        for name, pairs in gotoh_row_cases(rng, T):
            max_err = max(max_err, compare_gotoh_rows(
                name, pairs, T, device, 1)["max_abs_err"])
    # the longest chain a batch can hold, alone and on every warp
    full = [(ACGT[rng.integers(0, 4, GOTOH_T)].tobytes(),
             ACGT[rng.integers(0, 4, GOTOH_T)].tobytes()) for _ in range(1545)]
    for name, pairs in (("one unrelated 128 x 128 pair", full[:1]),
                        ("unrelated 128 x 128 pairs", full)):
        max_err = max(max_err, compare_gotoh_rows(
            name, pairs, GOTOH_T, device, reps)["max_abs_err"])
    pairs = gotoh_pairs(rng, 4096, GOTOH_T)
    dirs_ms, _, err = compare_gotoh("reference shape", pairs, GOTOH_T, device,
                                    reps)
    rows = compare_gotoh_rows("reference shape", pairs, GOTOH_T, device, reps)
    log_gotoh_times("reference shape", 4096, GOTOH_T, rows, dirs_ms, gpu)
    return {"max_abs_err": max(max_err, err, rows["max_abs_err"]),
            "ms": rows["ms"], "plain_ms": rows["plain_ms"],
            "dirs_ms": dirs_ms, "bound_ms": rows["bound_ms"],
            "bound_by": rows["bound_by"]}


# -------------------------------------------------------------- phase 3b --

ORDER_PLAIN_DIAGS = 6_000  # the plain version costs a Python step a diagonal


def related_pair(rng, n: int, middle: int = 0,
                 indel: int = 30) -> tuple[bytes, bytes]:
    """Two sequences of about n bases, 1 % of them substituted, an indel of
    1-`indel` bases about every 5,000; with `middle`, an unrelated stretch
    of that length in the middle of both (a wide square between anchors)."""
    a = ACGT[rng.integers(0, 4, n)]
    b = a.copy()
    hit = rng.integers(0, n, n // 100)
    b[hit] = ACGT[rng.integers(0, 4, hit.size)]
    for at in sorted(rng.integers(0, n, n // 5000).tolist(), reverse=True):
        b = np.delete(b, slice(at, at + int(rng.integers(1, indel + 1))))
    if middle:
        a = np.concatenate([a[:n // 2], ACGT[rng.integers(0, 4, middle)],
                            a[n // 2:]])
        b = np.concatenate([b[:n // 2], ACGT[rng.integers(0, 4, middle + 17)],
                            b[n // 2:]])
    return a.tobytes(), b.tobytes()


def order_jobs(pairs) -> list[tuple]:
    """(seq1, name1, seq2, name2, anchors) of each pair; anchors by the
    native rechaos, none for a pair given with its own."""
    from sibelia_tpu_torch.align.lagan_exact import rechaos
    return [(p[0], "x", p[1], "y",
             p[2] if len(p) > 2 else rechaos(p[0], "x", p[1], "y"))
            for p in pairs]


def pack_order_jobs(jobs, device):
    """The jobs' bands on the card: ([codes, params, init], table, band),
    params as the host makes them."""
    import torch
    from sibelia_tpu_torch.kernels import order_device
    from sibelia_tpu_torch.native import load_lagan
    lib = load_lagan()
    prepared = [order_device._prepare_job(lib, j[0], j[2], j[4], 8192)
                for j in jobs]
    for job in prepared:
        lib.le_order_release(job.handle)
    codes, params, init, table = order_device.pack_jobs(prepared)
    band = order_device.pack_bands(prepared)[1]
    return [torch.from_numpy(a).to(device) for a in (codes, params, init)], \
        table, torch.from_numpy(band).to(device)


def order_bound_ms(args, table) -> tuple[float, str, int, int]:
    """Read once: both sequences' codes, 36 B of params a diagonal and the
    init rows; written once: wmax pointer bytes a diagonal; about 40
    integer operations a lane inside the band (what the data need: the
    kernel computes every lane of a row).  Neither term sees the chain of
    dependent diagonals that binds the kernel.  Also the bytes of pointer
    rows and the lanes inside the band."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    rows = od.rows_bytes(table)
    lanes = 0
    for lo, n in table[:, [od.T_PARAMS, od.T_DIAGS]].tolist():
        lanes += int(args[1][lo:lo + n, 0].sum(dtype=torch.int64))
    n_bytes = (int(table[:, [od.T_N1, od.T_N2]].sum())
               + 36 * int(table[:, od.T_DIAGS].sum())
               + 12 * int(table[:, od.T_WMAX].sum()) + rows)
    return (*bound_ms(n_bytes, 40 * lanes), rows, lanes)


def inband_mask(args, table):
    """bool [rows_bytes(table)] on the card: the lanes inside the band."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    parts = []
    for lo, n, w in table[:, [od.T_PARAMS, od.T_DIAGS, od.T_WMAX]].tolist():
        lane = torch.arange(w, dtype=torch.int32, device=args[1].device)
        parts.append((lane[None, :] < args[1][lo:lo + n, 0:1]).reshape(-1))
    return torch.cat(parts)


def same_moves(table, a, b) -> int:
    """Largest difference of the counts or of a pair's moves between two
    (moves, counts) of one table."""
    from sibelia_tpu_torch.kernels import order_device as od
    (ma, ca), (mb, cb) = [(m.cpu().numpy().astype(np.int16), c.cpu().numpy())
                          for m, c in (a, b)]
    err = int(np.abs(ca.astype(np.int64) - cb).max(initial=0))
    for i in range(table.shape[0]):
        end = int(table[i, od.T_MOVES] + table[i, od.T_DIAGS] + 1)
        lo = end - int(cb[table[i, od.T_PAIR]])
        err = max(err, int(np.abs(ma[lo:end] - mb[lo:end]).max(initial=0)))
    return err


def compare_moves(name: str, args, table, rows, device, gpu: str,
                  reps: int) -> dict:
    """The traceback kernel on the pointer rows `rows` against
    order_moves_plain: counts and every pair's moves; raises on a
    difference.  Bound: a step reads one pointer byte, 12 B of params and
    at most two codes and writes one byte, about 20 integer operations."""
    from sibelia_tpu_torch.kernels import order_device as od
    ms, (moves, counts) = timed(
        lambda: od.band_moves(args[0], args[1], table, rows), device, reps)
    t0 = time.perf_counter()
    want, want_counts = od.order_moves_plain(args[0], args[1], table, rows)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = same_moves(table, (moves, counts), (want, want_counts))
    want_counts = want_counts.cpu().numpy()
    steps = int(want_counts.sum())
    bound, bound_by = bound_ms(16 * steps + 4 * table.shape[0], 20 * steps)
    log(f"  {name}, traceback: {steps} moves of {table.shape[0]} pairs "
        f"(the longest {int(want_counts.max())}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.0f} ms, bound {bound:.3g} ms by {bound_by}, max |diff| "
        f"{err} ({gpu})")
    if err:
        raise RuntimeError(f"traceback kernel disagrees with plain: {name}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": err, "moves": steps}


def compare_params(name: str, args, table, band, device, gpu: str,
                   reps: int) -> dict:
    """The params kernel against band_params_plain and against the params
    the host made; raises on a difference.  Bound: 12 B a diagonal read, 36
    written, about 30 integer operations."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    ms, got = timed(lambda: od.band_params(band, table), device, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = od.band_params_plain(band, table)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = got.shape[0]
    err = max(int((got - want).abs().max()),
              int((got - args[1][:n]).abs().max()))
    bound, bound_by = bound_ms(48 * n + 12 * table.shape[0], 30 * n)
    log(f"  {name}, params on the card: {n} diagonals: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.1f} ms, bound {bound:.3g} ms by {bound_by}, max "
        f"|diff| to plain and to the host's {err} ({gpu})")
    if err:
        raise RuntimeError(f"params kernel disagrees: {name}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": err}


def compare_order(name: str, args, table, device, gpu: str, reps: int = 3,
                  plain: bool = True, band=None, warm_s: float = 0.0) -> dict:
    """The order stage's kernels on one packed batch.  The band DP: its
    time, its bound and, with `plain`, the plain version's time and the
    largest difference of a pointer byte inside the band; raises unless
    that is 0.  Then the traceback on the kernel's rows (``moves``) and,
    given `band`, the params kernel (``params``)."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    ms, got = timed(lambda: od.band_rows(*args, table), device, reps, warm_s)
    bound, bound_by, rows, lanes = order_bound_ms(args, table)
    out = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
           "row_bytes": rows, "max_abs_err": 0, "plain_ms": None}
    text = ""
    if plain:
        t0 = time.perf_counter()
        want = od.order_band_rows_plain(*args, table)
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) * 1e3
        mask = inband_mask(args, table)
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs() * mask
        out["max_abs_err"] = int(diff.max())
        text = (f", plain {out['plain_ms']:.0f} ms, max |diff| inside the "
                f"band {out['max_abs_err']}")
    diags = int(table[:, od.T_DIAGS].max())
    log(f"  {name}: {table.shape[0]} pairs, wmax "
        f"{sorted(set(table[:, od.T_WMAX].tolist()))}, diagonals "
        f"{int(table[:, od.T_DIAGS].min())}-{diags}"
        f", {lanes} lanes inside the band, {rows} B of pointer rows: kernel "
        f"{ms:.3f} ms ({ms * 1e3 / diags:.3f} us a diagonal of the longest "
        f"pair), bound {bound:.4f} ms by {bound_by}{text} ({gpu})")
    if out["max_abs_err"]:
        raise RuntimeError(f"band DP kernel disagrees with plain: {name}")
    out["moves"] = compare_moves(name, args, table, got, device, gpu, reps)
    if band is not None:
        out["params"] = compare_params(name, args, table, band, device, gpu,
                                       reps)
    return out


def worst(a: dict, b: dict) -> dict:
    """`b`, its own and its parts' errors raised to those of `a`."""
    for part in (None, "moves", "params"):
        x, y = (a, b) if part is None else (a.get(part), b.get(part))
        if x and y:
            y["max_abs_err"] = max(x["max_abs_err"], y["max_abs_err"])
    return b


# the wide forms' timing pairs: a band the size of the matrix (no anchor,
# as a draft contig's wrong strand), seq1 3/4 of wmax long, seq2 8,000 bases
# (6,000 at 8192: the pointer rows stay under a pair's 256 MB)
WIDE_TIMES = (64, 1024, 2048, 4096, 8192)
WIDE_SIDE_BY_SIDE = 8  # pairs of wmax 4096 in one launch


def parent_order_lib(parent: str):
    """The band DP library of the tree at `parent`, built here with this
    tree's nvcc flags into a temp directory (ctypes; the band DP's launch
    with or, as before this tree, without the buffer of words)."""
    import ctypes
    from sibelia_tpu_torch.kernels import nvcc
    out = os.path.join(tempfile.mkdtemp(prefix="parent_order_"),
                       "liborder_band_parent.so")
    src = os.path.join(parent, "sibelia_tpu_torch", "kernels", "csrc",
                       "order_band.cu")
    nvcc.build(src, out)
    lib = ctypes.CDLL(out)
    void_p, c_int = ctypes.c_void_p, ctypes.c_int
    with open(src) as f:
        lib.takes_words = "words_base" in f.read()
    lib.order_band_launch.restype = c_int
    lib.order_band_launch.argtypes = (
        [void_p] * 5 + [c_int] * 6 + [void_p] * 2
        + ([ctypes.c_longlong, void_p] if lib.takes_words else []))
    lib.order_moves_launch.restype = c_int
    lib.order_moves_launch.argtypes = [void_p] * 4 + [c_int] * 2 + [void_p] * 3
    return lib


def parent_rows(lib, args, table):
    """band_rows through the parent's library: one launch a wmax class."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    dev = args[0].device
    sm = torch.from_numpy(od._SM.reshape(-1).copy()).to(dev)
    out = torch.empty(od.rows_bytes(table), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for wmax, sel, tab in od._classes(table, dev):
        words = []
        if lib.takes_words:
            buf, base = od.class_words(table, wmax, dev)
            words = [None if buf is None else buf.data_ptr(), base]
        err = lib.order_band_launch(
            args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
            tab.data_ptr(), sm.data_ptr(), len(sel), wmax, od.GAP_START,
            od.GAP_CONT, int(od.DUMMY), od._CB_CODE, out.data_ptr(), *words,
            stream)
        if err:
            raise RuntimeError(f"the parent's order_band_launch: error {err}")
    return out


def parent_moves(lib, args, table, rows):
    """band_moves through the parent's library."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    dev = args[0].device
    moves = torch.empty(od.moves_bytes(table), dtype=torch.uint8, device=dev)
    counts = torch.empty(table.shape[0], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for wmax, sel, tab in od._classes(table, dev):
        err = lib.order_moves_launch(
            args[0].data_ptr(), args[1].data_ptr(), tab.data_ptr(),
            rows.data_ptr(), len(sel), wmax, moves.data_ptr(),
            counts.data_ptr(), stream)
        if err:
            raise RuntimeError(f"the parent's order_moves_launch: error {err}")
    return moves, counts


def in_turns(device, here, parent, reps: int) -> dict:
    """ms of here() and, given `parent`, of parent() in turns (parent,
    here, here, parent): {"here": [...], "parent": [...]}."""
    order = ("parent", "here", "here", "parent") if parent else ("here",)
    runs: dict = {who: [] for who in order}
    for who in order:
        fn = here if who == "here" else parent
        runs[who].append(timed(fn, device, reps, 0.2)[0])
    return runs


# segment sizes of the narrow walk timed beside the default
WALK_SEGMENT_CHOICES = (256, 512, 1024, 2048)
# a shared-memory round trip, the least a dependent step can take, in
# cycles at the card's 1.98 GHz
ROUND_TRIP_CYCLES, CLOCK_HZ = 30, 1.98e9


def chain_floor_ms(steps: int) -> float:
    """The least time of `steps` dependent steps of one shared-memory round
    trip each: what a serial walk or sweep could reach at best."""
    return steps * ROUND_TRIP_CYCLES / CLOCK_HZ * 1e3


def narrow_walk_times(name: str, args, table, device, gpu: str, lib,
                      reps: int = 3) -> None:
    """The narrow walk on one batch's own pointer rows: this tree's at its
    segment size and, with the parent's library `lib`, the parent's in
    turns (parent, here, here, parent), moves equal; then each of
    WALK_SEGMENT_CHOICES once, and the three kernels of the default size
    alone (CUDA events around each, `reps` calls).  Logs the longest
    walk's steps and the serial walk's chain floor."""
    from sibelia_tpu_torch.kernels import order_device as od
    rows = od.band_rows(*args, table)
    walk = lambda: od.band_moves(args[0], args[1], table, rows)
    runs = in_turns(device, walk,
                    (lambda: parent_moves(lib, args, table, rows)) if lib
                    else None, reps)
    err = same_moves(table, walk(), parent_moves(lib, args, table, rows)
                     ) if lib else 0
    if err:
        raise RuntimeError(f"{name}: the walk differs from the parent's")
    steps = int(walk()[1].max())
    sizes, default = {}, od.WALK_SEGMENT_ROWS
    try:
        for s in WALK_SEGMENT_CHOICES:
            od.WALK_SEGMENT_ROWS = s
            sizes[s] = timed(walk, device, reps, 0.2)[0]
    finally:
        od.WALK_SEGMENT_ROWS = default
    split = np.zeros((reps, 3), np.float32)
    for rep in range(reps):
        od.band_moves(args[0], args[1], table, rows, split_ms=split[rep])
    log(f"  {name}, the narrow walk's kernels at {default}-row segments, ms "
        "(predicted tables 0.5-1.5, composition 0.1-0.3, replay 0.05-0.3 "
        "for the exact run's batch): " + ", ".join(
            f"{what} {split[:, i].min():.4f}-{split[:, i].max():.4f}"
            for i, what in enumerate(("k_walk_tables", "k_walk_compose",
                                      "k_walk_replay"))) + f" ({gpu})")
    log(f"  {name}, the narrow walk: {table.shape[0]} pairs, "
        f"{int(table[:, od.T_DIAGS].sum())} rows, the longest walk {steps} "
        "steps (a serial walk's chain floor "
        f"{chain_floor_ms(steps):.3f} ms); "
        + "; ".join(f"{who} " + ", ".join(f"{ms:.3f}" for ms in runs[who])
                    + " ms" for who in runs)
        + "; segments of " + ", ".join(f"{s} rows {ms:.3f}"
                                        for s, ms in sizes.items())
        + " ms; " + (f"max |diff| to the parent {err}" if lib
                     else "not compared with a parent") + f" ({gpu})")


def parent_anchors_lib(parent: str):
    """The sweep library of the tree at `parent`, built here with this
    tree's nvcc flags into a temp directory (ctypes; the block form with a
    byte of scratch a hit, as before this tree, or with the staircase's
    scratch)."""
    import ctypes
    from sibelia_tpu_torch.kernels import nvcc
    out = os.path.join(tempfile.mkdtemp(prefix="parent_anchors_"),
                       "libanchors_sweep_parent.so")
    nvcc.build(os.path.join(parent, "sibelia_tpu_torch", "kernels", "csrc",
                            "anchors_sweep.cu"), out)
    lib = ctypes.CDLL(out)
    void_p, c_int = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "anchors_sweep_scratch_bytes"):
        lib.anchors_sweep_scratch_bytes.restype = ctypes.c_longlong
        lib.anchors_sweep_scratch_bytes.argtypes = [ctypes.c_longlong, c_int]
    lib.anchors_sweep_launch.restype = c_int
    lib.anchors_sweep_launch.argtypes = ([void_p] * 6 + [c_int] * 3
                                         + [void_p] * 6)
    lib.anchors_sweep_warp_launch.restype = c_int
    lib.anchors_sweep_warp_launch.argtypes = ([void_p] * 6 + [c_int]
                                              + [void_p] * 5)
    return lib


def sweep_launcher(lib, args, offsets):
    """A function that launches the sweep kernels of `lib` (this tree's or
    a parent's) on the packed sets, its outputs and scratch made once:
    timed back to back, the kernels' device time without the wrapper's
    host work.  Returns (launch, outputs)."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    dev = args[0].device
    N, S = args[0].shape[0], len(offsets) - 1
    sizes = np.diff(offsets)
    small = np.flatnonzero(sizes <= ad.WARP_HITS)
    large = np.flatnonzero(sizes > ad.WARP_HITS)
    order = np.concatenate([small, large])
    spans = torch.from_numpy(np.stack(
        [offsets[order], offsets[order + 1], order], axis=1)).to(dev)
    outs = [torch.empty(n, dtype=dt, device=dev) for n, dt in (
        (N, torch.float32), (N, torch.int32), (S, torch.int32),
        (S, torch.float32))]
    ins = [t.data_ptr() for t in args]
    ptrs = [t.data_ptr() for t in outs]
    staircase = hasattr(lib, "anchors_sweep_scratch_bytes")
    scratch = torch.empty(
        lib.anchors_sweep_scratch_bytes(N, large.size) if staircase else N,
        dtype=torch.uint8, device=dev)

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        errs = []
        if small.size:
            errs.append(lib.anchors_sweep_warp_launch(
                *ins, spans.data_ptr(), small.size, *ptrs, stream))
        if large.size:
            head = [*ins, spans.data_ptr() + 24 * small.size, large.size,
                    int(sizes[large].max()), ad.SHARED_HITS]
            tail = ([scratch.data_ptr(), *ptrs] if staircase
                    else [*ptrs, scratch.data_ptr()])
            errs.append(lib.anchors_sweep_launch(*head, *tail, stream))
        if any(errs):
            raise RuntimeError(f"sweep launches: errors {errs}")

    return launch, outs


def parent_sweep(lib, args, offsets):
    """sweep_packed through the parent's library."""
    launch, outs = sweep_launcher(lib, args, offsets)
    launch()
    return tuple(outs)


def sweep_times(name: str, args, offsets, device, gpu: str, lib,
                reps: int = 3) -> None:
    """The sweep on one packed list of sets: this tree's and, with the
    parent's library `lib`, the parent's in turns (parent, here, here,
    parent), every output bit-equal.  Logs the bound and the chain floor
    of the largest set's 2n events."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    here = lambda: ad.sweep_packed(*args, offsets)
    runs = in_turns(device, here,
                    (lambda: parent_sweep(lib, args, offsets)) if lib
                    else None, reps)
    if lib and not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(here(), parent_sweep(lib, args,
                                                            offsets))):
        raise RuntimeError(f"{name}: the sweep differs from the parent's")
    # device time of the launches alone, back to back
    device = {}
    many = 10 if int(np.diff(offsets).max()) < 10_000 else 3
    for who, source in (("here", ad.build()), ("parent", lib)):
        if source is not None:
            device[who] = timed(sweep_launcher(source, args, offsets)[0],
                                args[0].device, many, 0.2)[0]
    sizes = np.diff(offsets)
    bound, bound_by = sweep_bound_ms(offsets)
    log(f"  {name}, timed: {len(sizes)} sets of {int(sizes.min())}-"
        f"{int(sizes.max())} hits; wrapper calls " + "; ".join(
            f"{who} " + ", ".join(f"{ms:.4f}" for ms in runs[who]) + " ms"
            for who in runs)
        + "; launches alone, back to back " + ", ".join(
            f"{who} {ms:.4f} ms" for who, ms in device.items())
        + f"; bound {bound:.3g} ms by {bound_by}, chain floor "
        f"{chain_floor_ms(2 * int(sizes.max())):.4f} ms; outputs "
        + ("equal to the parent's" if lib else "not compared") + f" ({gpu})")


def wide_times(device, gpu: str, lib, reps: int = 3) -> None:
    """The wide band DP (us a diagonal) and the wide walk (us a step) on
    bands the size of the matrix at each wmax of WIDE_TIMES, and a launch
    of WIDE_SIDE_BY_SIDE such pairs of wmax 4096; with the parent's
    library `lib`, the parent's forms on the same inputs in the same call,
    in turns, pointer bytes inside the band and moves equal (raises if
    not)."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    rng = np.random.default_rng(SEED + 9)
    cases = []
    for wmax in WIDE_TIMES:
        n1 = wmax * 3 // 4
        n2 = 6_000 if wmax == 8192 else 8_000
        cases.append((f"wmax {wmax}", [(bytes(ACGT[rng.integers(0, 4, n1)]),
                                        bytes(ACGT[rng.integers(0, 4, n2)]),
                                        "")]))
    cases.append((f"{WIDE_SIDE_BY_SIDE} pairs of wmax 4096 in one launch",
                  [(bytes(ACGT[rng.integers(0, 4, 3_000)]),
                    bytes(ACGT[rng.integers(0, 4, 8_000)]), "")
                   for _ in range(WIDE_SIDE_BY_SIDE)]))
    for name, pairs in cases:
        args, table, _ = pack_order_jobs(order_jobs(pairs), device)
        diags = int(table[:, od.T_DIAGS].max())
        bound, bound_by, _, lanes = order_bound_ms(args, table)
        runs = in_turns(device, lambda: od.band_rows(*args, table),
                        (lambda: parent_rows(lib, args, table)) if lib
                        else None, reps)
        rows = od.band_rows(*args, table)
        walk = lambda: od.band_moves(args[0], args[1], table, rows)
        wruns = in_turns(device, walk,
                         (lambda: parent_moves(lib, args, table, rows)) if lib
                         else None, reps)
        err = 0
        if lib:
            old = parent_rows(lib, args, table)
            err = max(int(((rows.to(torch.int16) - old.to(torch.int16)).abs()
                           * inband_mask(args, table)).max()),
                      same_moves(table, walk(),
                                 parent_moves(lib, args, table, rows)))
        steps = int(walk()[1].max())
        moves_bound, _ = bound_ms(16 * steps, 20 * steps)
        text = "; ".join(
            f"{who}: band DP " + ", ".join(f"{ms:.3f}" for ms in runs[who])
            + f" ms ({min(runs[who]) * 1e3 / diags:.4f} us a diagonal), walk "
            + ", ".join(f"{ms:.3f}" for ms in wruns[who])
            + f" ms ({min(wruns[who]) * 1e3 / steps:.4f} us a step)"
            for who in runs)
        log(f"  {name}: {table.shape[0]} pair(s), {diags} diagonals, {lanes} "
            f"lanes inside the band, {steps} steps of the longest walk; "
            f"{text}; bounds {bound:.4f} ms by {bound_by} (band), "
            f"{moves_bound:.5f} ms (walk); max |diff| to the parent {err} "
            f"({gpu})")
        if err:
            raise RuntimeError(f"{name}: the wide forms differ from the "
                               "parent's")


def phase_order(device, gpu: str, parent: str | None = None) -> dict:
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    from sibelia_tpu_torch.native import lagan_order
    # The 200 kbp pair comes off the first stream after the draws the small
    # cases once made from it (replayed here, unused), so that it stays the
    # pair every earlier measurement was taken on.  The small cases draw
    # from a second stream: a plain DP costs about 2 ms a diagonal; the
    # cases of the wide forms added later from a third.
    rng = np.random.default_rng(SEED)
    for n, middle in ((3000, 0), (3000, 0), (2000, 12), (2000, 600),
                      (2000, 5000)):
        related_pair(rng, n, middle)
    rng2 = np.random.default_rng(SEED + 1)
    with_codes = list(related_pair(rng2, 1500))
    with_codes[0] = (with_codes[0][:400] + b"N" * 30 + with_codes[0][430:900]
                     + b"." + with_codes[0][900:])
    ragged = [related_pair(rng2, int(n))
              for n in rng2.integers(300, 1500, 11)]
    cases = [
        ("nd = 2, 3, 9 (wmax 16)", [(b"", b"A", ""), (b"A", b"A", ""),
                                    (b"ACGT", b"ACGT", "")], 16),
        ("unrelated 40 x 300, no anchors",
         [(bytes(ACGT[rng2.integers(0, 4, 40)]),
           bytes(ACGT[rng2.integers(0, 4, 300)]), "")], 64),
        ("1.5 kbp pairs, one with N and '.'",
         [related_pair(rng2, 1500), tuple(with_codes)], 32),
        ("11 ragged pairs, more than a block's warps", ragged, 32),
        ("a square of 12", [related_pair(rng2, 1000, 12)], 64),
        ("a square of 600", [related_pair(rng2, 500, 600)], 1024),
        ("a square of 5000", [related_pair(rng2, 300, 5000)], 8192)]
    rng3 = np.random.default_rng(SEED + 8)
    cases += [
        ("a square of 90", [related_pair(rng3, 1000, 90)], 128),
        ("a square of 1500", [related_pair(rng3, 300, 1500)], 2048),
        ("a square of 3000", [related_pair(rng3, 300, 3000)], 4096),
        ("three squares of 600-900 side by side",
         [related_pair(rng3, 400, m) for m in (600, 750, 900)], 1024),
        ("a square of 200 (one warp)", [related_pair(rng3, 600, 200)], 256)]
    res = {"max_abs_err": 0, "moves": {"max_abs_err": 0},
           "params": {"max_abs_err": 0}}
    every, narrower = [], []
    for name, pairs, wmax in cases:
        jobs = order_jobs(pairs)
        every += jobs
        narrower += jobs if wmax < 8192 else []
        args, table, band = pack_order_jobs(jobs, device)
        if int(table[:, od.T_WMAX].max()) != wmax:
            raise RuntimeError(f"{name}: wmax {table[:, od.T_WMAX]}")
        res = worst(res, compare_order(name, args, table, device, gpu, 1,
                                       band=band))
    # all of them in one call; the plain DP pads every pair to the widest,
    # so it is held to the batch without the 8192-wide pair
    args, table, band = pack_order_jobs(narrower, device)
    res = worst(res, compare_order("all but the 8192-wide in one call", args,
                                   table, device, gpu, 1, band=band))
    args, table, band = pack_order_jobs(every, device)
    res = worst(res, compare_order("all of them in one call", args, table,
                                   device, gpu, 1, plain=False, band=band))
    necks = int((args[1][:, 6] == 1).sum())
    if necks < 10:
        raise RuntimeError(f"only {necks} neck diagonals in the cases")
    # pointer bytes no DP wrote: walks that wander and stop off the band
    wild = rng2.integers(0, 3, od.rows_bytes(table)) | (
        rng2.integers(0, 4, od.rows_bytes(table)) << 2)
    res["moves"] = worst({"max_abs_err": res["moves"]["max_abs_err"]},
                         compare_moves(
        "random pointer bytes", args, table,
        torch.from_numpy(wild.astype(np.uint8)).to(device), device, gpu, 1))
    # two 200 kbp pairs, one of each stream, no plain DP (400,000 Python
    # steps); with these seeds both have wmax 32 (a warp a pair, as every
    # pair of the exact run)
    long = order_jobs([related_pair(rng, 200_000),
                       related_pair(rng2, 200_000)])
    lib = parent_order_lib(parent) if parent else None
    for job in long:
        args, table, band = pack_order_jobs([job], device)
        name = f"a 200 kbp pair of wmax {int(table[0, od.T_WMAX])}"
        res = worst(res, compare_order(name, args, table, device, gpu,
                                       plain=False, band=band))
        narrow_walk_times(name, args, table, device, gpu, lib)
    jobs = every + long
    got = od.order_mfa_device_batch(jobs, device)
    for job, text in zip(jobs, got):
        if text is None or text != lagan_order(*job):
            raise RuntimeError("-mfa text of the card's band DP differs from "
                               f"native lagan_order: {len(job[0])} bases")
    log(f"  -mfa text of {len(jobs)} pairs through order_mfa_device_batch on "
        f"the card equals native lagan_order; {necks} neck diagonals in the "
        "small cases")
    log("  the wide forms on bands the size of the matrix"
        + (f", beside the parent's at {parent} (parent, here, here, parent)"
           if parent else ""))
    wide_times(device, gpu, lib)
    res["jobs"], res["texts"] = jobs, got
    return res


# -------------------------------------------------------------- phase 3c --

def hit_set(rng, n: int, tie_heavy: bool = False):
    """(a_s, a_e, score, ev_hit, ev_isstart) of n random hits along a
    diagonal band, as chaos gives them; tie_heavy: on a coarse grid with
    three scores, so that coordinates and scores tie."""
    from sibelia_tpu_torch.align.anchors_device import event_order
    span = max(500, 8 * n)
    a_s = rng.integers(0, span, n)
    b_s = np.clip(a_s + rng.integers(-200, 201, n), 0, None)
    ln = rng.integers(1, 40, n)
    score = rng.integers(-5, 80, n).astype(np.float32)
    if tie_heavy:
        a_s, b_s, ln = (a_s // 25) * 25, (b_s // 25) * 25, np.full(n, 20)
        score = (rng.integers(1, 4, n) * 10).astype(np.float32)
    ev_h, ev_st = event_order(b_s, b_s + ln)
    return (a_s.astype(np.int32), (a_s + ln).astype(np.int32), score, ev_h,
            ev_st)


def pack_hit_sets(sets, device):
    import torch
    offsets = np.zeros(len(sets) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s[0]) for s in sets])
    return [torch.from_numpy(np.concatenate([s[c] for s in sets])).to(device)
            for c in range(5)], offsets


def sweep_bound_ms(offsets) -> tuple[float, str]:
    """Read: a_s, a_e, score and the two event columns, 28 B a hit;
    written: sofar and bk, 8 B a hit, best and best_val, 8 B a set.  The
    function's least work: the hits ranked, n log2 n compares, then about
    4 operations an event (the key's predecessor, the chain's sum, the
    kill's compare, the running maximum)."""
    n = np.diff(offsets).astype(np.float64)
    return bound_ms(36 * float(n.sum()) + 8 * len(n),
                    float((n * np.log2(np.maximum(n, 2)) + 8 * n).sum()))


def compare_sweep(name: str, args, offsets, device, gpu: str,
                  reps: int = 3) -> dict:
    """The sweep kernel vs the plain version on one packed list of hit
    sets: times, bound and the largest difference over sofar, bk, best and
    best_val; raises unless every bit is equal."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    ms, got = timed(lambda: ad.sweep_packed(*args, offsets), device, reps)
    t0 = time.perf_counter()
    want = ad.sweep_plain(*args, offsets)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"sweep kernel output {g.dtype} {g.shape}")
        same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        err = max(err, float((g.double() - w.double()).abs().max()),
                  0.0 if same else 1.0)
    bound, bound_by = sweep_bound_ms(offsets)
    sizes = np.diff(offsets)
    log(f"  {name}: {len(sizes)} sets of {int(sizes.min())}-"
        f"{int(sizes.max())} hits: kernel {ms:.3f} ms, plain {plain_ms:.0f} "
        f"ms, bound {bound:.3g} ms by {bound_by}, max |diff| {err:g} ({gpu})")
    if err:
        raise RuntimeError(f"sweep kernel disagrees with plain: {name}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": err}


def timed_host(fn, reps: int = 3) -> tuple[float, object]:
    """Mean ms of fn() on the host's clock over reps calls after one."""
    out = fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def compare_anchors_text(name: str, hits: str, device, gpu: str) -> None:
    """anchors_text_device on the card against native lagan_anchors on one
    chaos output, with and without the chunk expansion; both timed on the
    host's clock (the parsers included)."""
    from sibelia_tpu_torch.align.anchors_device import anchors_text_device
    from sibelia_tpu_torch.native import lagan_anchors
    for gfc in (False, True):
        ms, got = timed_host(lambda: anchors_text_device(hits, gfc, device))
        native_ms, want = timed_host(lambda: lagan_anchors(hits, gfc=gfc))
        if got != want or not want:
            raise RuntimeError(f"anchors text differs from native: {name}")
        log(f"  {name}, gfc={gfc}: {got.count(chr(10))} anchor lines equal "
            f"to native lagan_anchors; the stage on the card {ms:.2f} ms "
            f"(Python parsers, upload, kernel, download), native "
            f"{native_ms:.2f} ms ({gpu})")


def sweep_graph_ms(args, offsets) -> float:
    """Device ms of one launch of the warp-a-set kernel over all of the
    list's sets (each of at most WARP_HITS hits), replayed from a CUDA
    graph: the kernel without the host's time to enqueue it."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    dev = args[0].device
    S = len(offsets) - 1
    lib = ad.build()
    spans = torch.from_numpy(np.stack(
        [offsets[:-1], offsets[1:], np.arange(S)], axis=1)).to(dev)
    outs = [torch.empty(n, dtype=dt, device=dev) for n, dt in (
        (args[0].shape[0], torch.float32), (args[0].shape[0], torch.int32),
        (S, torch.int32), (S, torch.float32))]

    def launch():
        err = lib.anchors_sweep_warp_launch(
            *[t.data_ptr() for t in args], spans.data_ptr(), S,
            *[t.data_ptr() for t in outs],
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"anchors_sweep_warp_launch: CUDA error {err}")

    return timed_graph(launch)


def phase_anchors(device, gpu: str, parent: str | None = None) -> dict:
    from sibelia_tpu_torch.align.anchors_device import SHARED_HITS, WARP_HITS
    from sibelia_tpu_torch.native import lagan_chaos
    rng = np.random.default_rng(SEED)
    err = 0.0
    sets = []
    for n, tie in ((1, False), (2, False), (2, True), (13, False),
                   (WARP_HITS, False), (WARP_HITS, True),
                   (WARP_HITS + 1, False), (60, False), (60, True),
                   (1000, True)):
        s = hit_set(rng, n, tie)
        sets.append(s)
        err = max(err, compare_sweep(
            f"n = {n}{', tie-heavy' if tie else ''}", *pack_hit_sets(
                [s], device), device, gpu, 1)["max_abs_err"])
    err = max(err, compare_sweep("a mixed list of small and large sets in "
                                 "one call", *pack_hit_sets(sets, device),
                                 device, gpu, 1)["max_abs_err"])
    level = [hit_set(rng, int(n), bool(n % 5 == 0))
             for n in rng.integers(1, 14, 200)]
    args, offsets = pack_hit_sets(level, device)
    err = max(err, compare_sweep("200 sets of 1-13 hits in one launch", args,
                                 offsets, device, gpu)["max_abs_err"])
    log(f"  those 200 sets, the warp-a-set kernel replayed from a CUDA "
        f"graph: {sweep_graph_ms(args, offsets):.4f} ms; one set of 13: "
        f"{sweep_graph_ms(*pack_hit_sets([sets[3]], device)):.4f} ms ({gpu})")
    ref = compare_sweep("n = 1000", *pack_hit_sets(
        [hit_set(rng, 1000)], device), device, gpu)
    big_set = hit_set(rng, SHARED_HITS + 1)
    big = compare_sweep(f"n = {SHARED_HITS + 1} (in device memory)",
                        *pack_hit_sets([big_set], device), device, gpu, 1)
    # the block form at each size, beside the parent's
    rng4 = np.random.default_rng(SEED + 10)
    lib = parent_anchors_lib(parent) if parent else None
    timing = [(n, hit_set(rng4, n)) for n in (33, 60, 256, 1000)]
    timing += [(SHARED_HITS + 1, big_set)]
    for n, s in timing:
        if n == 256:
            err = max(err, compare_sweep("n = 256", *pack_hit_sets(
                [s], device), device, gpu, 1)["max_abs_err"])
        sweep_times(f"n = {n}", *pack_hit_sets([s], device), device, gpu, lib)
    a, b = related_pair(rng, 50_000)
    hits = lagan_chaos(a, "x", b, "y",
                       f"-s1 1 {len(a)} -s2 1 {len(b)}\n", 12, 0, 25, 0,
                       gfc=True, ext=True)
    compare_anchors_text("chaos hits of a 50 kbp pair", hits, device, gpu)
    ref["max_abs_err"] = max(err, ref["max_abs_err"], big["max_abs_err"])
    return ref


# ---------------------------------------------------------------- phase 4 --

def same_enumeration(got, want, same_dtypes: bool = True) -> None:
    """Raises unless two BifEnumerations agree in every field (in value
    only, without same_dtypes)."""
    if got.count != want.count:
        raise RuntimeError(f"enumeration count {got.count} != {want.count}")
    for s in (0, 1):
        for field in ("chr", "pos", "bif_id"):
            a, b = getattr(got, field)[s], getattr(want, field)[s]
            if ((same_dtypes and a.dtype != b.dtype)
                    or not np.array_equal(a, b)):
                raise RuntimeError(f"enumeration differs: {field}[{s}]")
    if (got.candidates is None) != (want.candidates is None) or (
            got.candidates is not None
            and not np.array_equal(got.candidates, want.candidates)):
        raise RuntimeError("candidate bitmaps differ")


def phase_enumeration(device, strains) -> dict:
    import torch
    from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations
    enumerate_bifurcations(strains[:1], MAIN_K, MAIN_MIN_BRANCH, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = enumerate_bifurcations(strains, MAIN_K, MAIN_MIN_BRANCH, device)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = enumerate_bifurcations(strains, MAIN_K, MAIN_MIN_BRANCH,
                                  torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    if got.candidates is None:
        raise RuntimeError("no candidate bitmap at k = 30")
    same_enumeration(got, want)
    log(f"  count={got.count} instances={got.pos[0].size + got.pos[1].size} "
        f"candidates={int(got.candidates.sum())}: card {t_card:.3f} s, CPU "
        f"plain {t_cpu:.3f} s; identical")
    return {"card_s": t_card, "cpu_s": t_cpu}


# --------------------------------------------------------------- phase 4b --

@contextlib.contextmanager
def ranking_rounds(marks: list[float]):
    """Appends a synchronised host time to `marks` as the k > 32 ranking
    starts and as each of its doubling rounds ends, by wrapping
    ``kmer_ranks`` where ``enum_device`` calls it and ``dense_ranks``
    where ``ranking_device`` calls it."""
    import torch
    from sibelia_tpu_torch.index import enum_device, ranking_device
    kmer_ranks, dense_ranks = enum_device.kmer_ranks, ranking_device.dense_ranks

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def marked_kmer_ranks(*args):
        mark()
        return kmer_ranks(*args)

    def marked_dense_ranks(*args):
        out = dense_ranks(*args)
        mark()
        return out

    enum_device.kmer_ranks = marked_kmer_ranks
    ranking_device.dense_ranks = marked_dense_ranks
    try:
        yield
    finally:
        enum_device.kmer_ranks = kmer_ranks
        ranking_device.dense_ranks = dense_ranks


def phase_enum_k(device, strains, gpu: str) -> dict:
    """The port's k > 32 enumeration on the card against the host native
    enumeration, at each of ENUM_KS; then one step run each."""
    import torch
    from sibelia_tpu_torch.index import enumeration as port_enum
    out = {}
    for k in ENUM_KS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = port_enum.enumerate_bifurcations(strains, k, None, device)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        want = port_enum.enumerate_bifurcations_host(strains, k)
        t_host = time.perf_counter() - t0
        # the device path returns chr and pos as int64, the native host
        # path as int32
        same_enumeration(got, want, same_dtypes=False)
        if got.count <= 0:
            raise RuntimeError(f"no bifurcations at k = {k}")
        rows: dict[str, list[float]] = {}
        marks: list[float] = []
        with ranking_rounds(marks):
            enumeration_steps(device, strains, k, None, rows)
        round_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        log(f"  k={k}: count={got.count} instances="
            f"{got.pos[0].size + got.pos[1].size}: card {t_card:.3f} s "
            f"(peak {peak_gb:.2f} GB allocated), host native {t_host:.3f} "
            f"s; identical ({gpu})")
        log(f"  k={k} doubling rounds (ms, the first with the packed keys): "
            + ", ".join(f"{t:.1f}" for t in round_ms) + f" ({gpu})")
        for name, ms in rows.items():
            log(f"  k={k} step {name}: {ms[0]:.1f} ms")
        out[k] = {"card_s": t_card, "host_s": t_host, "round_ms": round_ms}
    return out


# --------------------------------------------------------------- phase 4c --

SHARDED_KS = (MAIN_K, ENUM_KS[0])


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_call(strains, k: int, mesh, want) -> dict:
    """One timed ``enumerate_bifurcations_sharded`` call, held to `want` in
    every field and dtype: its seconds, scan launches, exchanged bytes and
    blocking copies."""
    import torch
    from sibelia_tpu_torch.core import timings
    from sibelia_tpu_torch.core.platform import LAUNCHES
    from sibelia_tpu_torch.parallel.sharded_enum import \
        enumerate_bifurcations_sharded
    launches = LAUNCHES.get("enum_segment_scan", 0)
    syncs = dict(timings._ACC)
    mesh.exchanged_bytes = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = enumerate_bifurcations_sharded(strains, k, mesh)
    torch.cuda.synchronize()
    out = {"s": time.perf_counter() - t0,
           "launches": LAUNCHES.get("enum_segment_scan", 0) - launches,
           "bytes": mesh.exchanged_bytes,
           "syncs": {key[6:]: n - syncs.get(key, 0)
                     for key, n in timings._ACC.items()
                     if key.startswith("syncs_") and n != syncs.get(key, 0)},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    same_enumeration(got, want)
    return out


def sharded_instances(strains, k: int, device, n_dev: int):
    """(codes, pos, ids, m, count, exact) of the port's enumeration of
    `strains` on the card: the instance table sorted by position, padded
    to a multiple of n_dev, and the single-device candidate bitmap."""
    from sibelia_tpu_torch.index.enumeration import (build_supergenome,
                                                     enumerate_bifurcations)
    enum = enumerate_bifurcations(strains, k, MAIN_MIN_BRANCH, device)
    codes, starts = build_supergenome(strains)
    sg = np.concatenate([starts[(0 if s == 0 else len(strains)) + enum.chr[s]]
                         + enum.pos[s] for s in (0, 1)])
    ids = np.concatenate(enum.bif_id).astype(np.int64)
    order = np.argsort(sg, kind="stable")
    m = sg.size
    B = -(-max(m, enum.count) // n_dev) * n_dev
    pos_p = np.full(B, codes.size, dtype=np.int64)
    ids_p = np.full(B, B, dtype=np.int64)
    pos_p[:m], ids_p[:m] = sg[order], ids[order]
    return codes, pos_p, ids_p, m, enum.count, enum.candidates.astype(bool)


def sharded_cli_runs(strains, work: str, gpu: str) -> None:
    """(d): the -s loose CLI under SIBELIA_TPU_SHARDED=<cards> in this
    process and as two NCCL processes, each byte-identical to the
    single-card run."""
    import torch
    count = torch.cuda.device_count()
    # warm-up on a small input: the native host engines' build is no run's
    small = os.path.join(work, "small.fasta")
    write_fasta(small, [s[:300_000] for s in strains[:2]])
    run_cli("cuda", small, os.path.join(work, "warm"),
            os.path.join(work, "warm.json"))
    fasta = os.path.join(work, "strains.fasta")
    write_fasta(fasta, strains)
    t_one = run_cli("cuda", fasta, os.path.join(work, "one"),
                    os.path.join(work, "one.json"))
    t_mesh = run_cli("cuda", fasta, os.path.join(work, "mesh"),
                     os.path.join(work, "mesh.json"),
                     env={"SIBELIA_TPU_SHARDED": str(count)})
    same_trees(os.path.join(work, "mesh"), os.path.join(work, "one"),
               f"SIBELIA_TPU_SHARDED={count}")
    port = free_port()
    t0 = time.perf_counter()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SIBELIA_TPU_TORCH_DEVICE="cuda",
                   SIBELIA_TPU_COORD=f"127.0.0.1:{port}",
                   SIBELIA_TPU_NPROCS="2", SIBELIA_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sibelia_tpu_torch.cli.sibelia", *LOOSE,
             "-o", os.path.join(work, f"nccl{rank}"), fasta], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            err = p.communicate(timeout=300)[1]
            if p.returncode != 0:
                raise RuntimeError(f"two-process NCCL CLI: exit "
                                   f"{p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    t_nccl = time.perf_counter() - t0
    same_trees(os.path.join(work, "nccl0"), os.path.join(work, "one"),
               "two NCCL processes")
    if os.path.exists(os.path.join(work, "nccl1")):
        raise RuntimeError("process 1 of the NCCL run wrote files")
    log(f"  (d) -s loose, 4 x 2 Mbp: one card {t_one:.3f} s, "
        f"SIBELIA_TPU_SHARDED={count} {t_mesh:.3f} s, two NCCL processes "
        f"{t_nccl:.3f} s (start-up included); identical ({gpu})")


def phase_sharded(device, strains, gpu: str, order: dict) -> dict:
    """(a) the sharded enumeration on meshes of one and four shards of the
    card against the single-card enumeration, at SHARDED_KS; (b) the
    sharded prefilter on four shards of the card against four CPU shards
    and the single-device bitmap; (c) (a) at k = 30 through an NCCL group
    of one rank; (d) the CLI over cards, where there are two or more; and
    the pair mesh of order_mfa_device_batch on phase 3b's jobs."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations
    from sibelia_tpu_torch.kernels.order_device import order_mfa_device_batch
    from sibelia_tpu_torch.parallel.runtime import seq_mesh
    from sibelia_tpu_torch.parallel.sharded import Mesh
    from sibelia_tpu_torch.parallel.sharded_sweep import \
        sharded_candidate_scan
    card = torch.device("cuda", 0)
    out: dict = {}
    wants = {}
    for k in SHARDED_KS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wants[k] = want = enumerate_bifurcations(strains, k, None, device)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        row = {"single_s": t_single}
        for n in (1, 4):
            got = sharded_call(strains, k, Mesh([card] * n), want)
            if got["launches"] != n:
                raise RuntimeError(f"k={k}, {n} shards: {got['launches']} "
                                   "segment scan launches, one a shard "
                                   "expected")
            row[n] = got
            log(f"  (a) k={k}, {n} shard(s) on cuda:0: {got['s'] * 1e3:.1f} "
                f"ms (single-card route {t_single * 1e3:.1f} ms), "
                f"{got['launches']} scan launches, {got['bytes']:,} bytes "
                f"between shards, syncs {got['syncs']}, peak "
                f"{got['peak_gb']:.2f} GB; identical ({gpu})")
        out[k] = row
    # where a call's time goes: the card's kernels in a profiler window
    for n in (1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = sharded_call(strains, MAIN_K, Mesh([card] * n),
                               wants[MAIN_K])
        kernels, device_ms, scan_ms = device_events(prof)
        log(f"  (a) k={MAIN_K}, {n} shard(s), profiled: {kernels} CUDA "
            f"kernels, {device_ms:.1f} ms of device time (the scan's "
            f"{scan_ms:.2f} ms), copies and memsets "
            f"{device_copy_ms(prof):.1f} ms, in a {got['s'] * 1e3:.1f} ms "
            f"call ({gpu})")
    # (b) the prefilter over four shards, card against CPU
    sub = strains[:4]
    codes, pos, ids, m, count, exact = sharded_instances(sub, MAIN_K, device,
                                                         4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sharded_candidate_scan(codes, pos, ids, MAIN_K, MAIN_MIN_BRANCH, m,
                                 Mesh([card] * 4)).cpu().numpy()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = sharded_candidate_scan(codes, pos, ids, MAIN_K, MAIN_MIN_BRANCH,
                                  m, Mesh([torch.device("cpu")] * 4)).numpy()
    t_cpu = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise RuntimeError("sharded prefilter: the card's bitmap differs "
                           "from the CPU shards'")
    if not np.all(got[:count][exact]):
        raise RuntimeError("sharded prefilter dropped a candidate of "
                           "candidate_scan")
    log(f"  (b) sharded_candidate_scan, 4 x 2 Mbp at k={MAIN_K}, {m:,} "
        f"instances on 4 shards: card {t_card * 1e3:.1f} ms, 4 CPU shards "
        f"{t_cpu * 1e3:.1f} ms; identical; {int(got[:count].sum()):,} "
        f"candidates, a superset of candidate_scan's {int(exact.sum()):,} "
        f"({gpu})")
    # (c) one NCCL rank over a tcp store on this host
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = seq_mesh()
        # the first collective sets up the communicator: not the call's
        t0 = time.perf_counter()
        mesh.psum([torch.ones(1, device=card)])
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        got = sharded_call(strains, MAIN_K, mesh, wants[MAIN_K])
    finally:
        dist.destroy_process_group()
    if got["launches"] != 1:
        raise RuntimeError(f"NCCL rank: {got['launches']} scan launches")
    log(f"  (c) k={MAIN_K} through an NCCL group of one rank (seq_mesh): "
        f"{got['s'] * 1e3:.1f} ms (the communicator's set-up before it "
        f"{t_init * 1e3:.1f} ms), syncs {got['syncs']}; identical ({gpu})")
    # (d) the CLI over cards
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            sharded_cli_runs(strains[:4], work, gpu)
    else:
        log("  (d) the CLI under SIBELIA_TPU_SHARDED and two NCCL processes "
            "need two cards; this machine has "
            f"{torch.cuda.device_count()}")
    # the pair mesh: phase 3b's jobs over two shards of the card
    t0 = time.perf_counter()
    texts = order_mfa_device_batch(order["jobs"], device,
                                   mesh=Mesh([card] * 2))
    if texts != order["texts"]:
        raise RuntimeError("order_mfa_device_batch over a pair mesh of two "
                           "differs from the unsharded call")
    log(f"  order_mfa_device_batch over [cuda:0] * 2, {len(texts)} pairs: "
        f"the unsharded call's text ({time.perf_counter() - t0:.2f} s)")
    return out


# --------------------------------------------------------------- phase 4d --

def device_events(prof) -> tuple[int, float, float]:
    """(CUDA kernels launched, their device ms, the segment scan's device
    ms) in a torch.profiler window."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    cuda = [e for e in events if e.device_type == DeviceType.CUDA
            and "memcpy" not in e.key.lower() and "memset" not in e.key.lower()]
    scan = [e for e in cuda if any(k in e.key for k in
                                   ("k_flags", "k_carries", "k_write"))]
    return (sum(e.count for e in cuda),
            sum(getattr(e, attr) for e in cuda) / 1e3,
            sum(getattr(e, attr) for e in scan) / 1e3)


def device_copy_ms(prof) -> float:
    """The device ms of copies and memsets in a torch.profiler window."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    return sum(getattr(e, attr) for e in events
               if e.device_type == DeviceType.CUDA
               and ("memcpy" in e.key.lower()
                    or "memset" in e.key.lower())) / 1e3


def phase_trim(device, gpu: str) -> dict:
    """The crossover of trim_blocks' rounds: ms a round (the enumeration of
    two related copies at k = MAIN_K and the walk) by each route, at each
    of CROSSOVER_ROWS: the numpy route (``SIBELIA_TPU_NATIVE=0``'s), the
    native round (the host route, ``native.trim_round``) and the card (the
    port's device enumeration, the route of ``trim_enumeration`` from
    TRIM_CARD_MIN_ROWS rows on, walked by ``native.trim_walk``), with
    identical enumerations and walks; and the kernels a card call launches,
    with their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sibelia_tpu_torch import native
    from sibelia_tpu_torch.blocks import synteny
    from sibelia_tpu_torch.index import enumeration as port_enum
    table = {}
    log(f"  rows: numpy, native and card ms a round, CUDA kernels a card "
        f"call, their device ms, the segment scan's ({gpu}; "
        f"TRIM_CARD_MIN_ROWS = {synteny.TRIM_CARD_MIN_ROWS})")
    for rows in CROSSOVER_ROWS:
        copies = trim_copies(rows)
        n = 1 + 2 * sum(len(c) + 1 for c in copies) if copies else 0
        reps = max(3, min(200, 400_000 // max(n, 1)))
        chars = (np.concatenate(copies) if copies
                 else np.zeros(0, dtype=np.uint8))
        lens = np.array([len(c) for c in copies], dtype=np.int64)
        dirs = np.array([0, 1][:len(copies)], dtype=np.int8)

        def numpy_round():
            enum = port_enum.enumerate_numpy(
                *port_enum.build_supergenome(copies), len(copies), MAIN_K)
            return enum, synteny._trim_walk(lens, dirs, enum, MAIN_K,
                                            MAIN_MIN_SIZE)

        def card_round():
            enum = port_enum.enumerate_bifurcations(copies, MAIN_K, None,
                                                    device)
            return enum, native.trim_walk(enum, lens, dirs, MAIN_K,
                                          MAIN_MIN_SIZE)

        numpy_ms, (want, want_walk) = timed_host(numpy_round, reps)
        native_ms, got_walk = timed_host(lambda: native.trim_round(
            chars, lens, dirs, MAIN_K, MAIN_MIN_SIZE), reps)
        card_ms, (got, card_walk) = timed_host(card_round, reps)
        same_enumeration(got, want, same_dtypes=False)
        same_enumeration(port_enum.enumerate_bifurcations_host(
            copies, MAIN_K), want, same_dtypes=False)
        for walk in (got_walk, card_walk):
            if walk[0] != want_walk[0] or not np.array_equal(walk[1],
                                                             want_walk[1]):
                raise RuntimeError(f"trim walks differ at {rows} rows")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            port_enum.enumerate_bifurcations(copies, MAIN_K, None, device)
            torch.cuda.synchronize()
        launches, device_ms, scan_ms = (device_events(prof) if n
                                        else (0, 0.0, 0.0))
        table[rows] = {"n": n, "numpy_ms": numpy_ms, "native_ms": native_ms,
                       "card_ms": card_ms, "kernels": launches,
                       "device_ms": device_ms}
        fastest = min(("numpy", numpy_ms), ("native", native_ms),
                      ("card", card_ms), key=lambda t: t[1])[0]
        log(f"  {rows} ({n} rows): numpy {numpy_ms:.4f}, native "
            f"{native_ms:.4f}, card {card_ms:.4f} ({fastest} ahead), "
            f"{launches} kernels, {device_ms:.3f} device ms, the scan's "
            f"{scan_ms:.4f}; {got.pos[0].size + got.pos[1].size} "
            "instances, identical")
    ahead = [t["n"] for t in table.values()
             if t["n"] and t["native_ms"] <= t["card_ms"]]
    log(f"  native round ahead of the card at {ahead or 'no size'}: a size "
        f"rule may send rounds below {max(ahead) + 1 if ahead else 0} rows "
        "to the host")
    return table


# ----------------------------------------------------------- phase memory --

# the three k classes of the card's enumeration: k <= 32 with the
# candidate scan (min_branch as the loose preset's first stage sets it),
# prefix doubling at the loose preset's first and last k > 32
MEMORY_KS = ((MAIN_K, MAIN_MIN_BRANCH), (ENUM_KS[0], None), (BIG_K, None))
# --memory: strains of MEMORY_STRAIN bases, up to 128 of them, then near
# 0.95 of where the size rule turns each class to the host on an empty
# H100 80GB (597 M rows at k <= 32, 871 M above): 135 and 197 strains
MEMORY_STRAIN = 2_100_000
MEMORY_COUNTS = (16, 32, 64, 128, 135, 197)
# --memory --parent: -s loose on this many of those strains, where the
# card route's slab (5 B a base a stage) passes 1 GiB
SLAB_STRAINS = 32


@contextlib.contextmanager
def card_left_with(device, n_bytes: int | None):
    """Fill the card with one ballast tensor so that ``card_free_bytes``
    gives `n_bytes` (to its 2 MiB rounding); nothing for None.  Yields the
    ballast's bytes."""
    import torch
    from sibelia_tpu_torch.index.enum_device import card_free_bytes
    torch.cuda.empty_cache()
    fill = 0 if n_bytes is None else max(
        card_free_bytes(device) - n_bytes, 0)
    ballast = torch.empty(fill, dtype=torch.uint8, device=device)
    try:
        yield fill
    finally:
        del ballast
        torch.cuda.empty_cache()


def card_peak(device, codes, block_starts, n_chr: int, k: int,
              min_branch, room: int | None = None) -> dict:
    """One call of the single-card route over a built supergenome, from an
    emptied allocator (and with the card filled to leave `room` bytes, if
    given): its peak allocated and peak reserved bytes, seconds and count
    (None when the card ran out of memory)."""
    import torch
    from sibelia_tpu_torch.core import timings
    from sibelia_tpu_torch.index.enum_device import card_free_bytes
    from sibelia_tpu_torch.index.enumeration import enumerate_on_device
    torch.cuda.synchronize()
    with card_left_with(device, room):
        free = card_free_bytes(device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        ranges0 = timings._ACC.get("syncs_candidate_ranges", 0)
        t0 = time.perf_counter()
        try:
            count = enumerate_on_device(codes, block_starts, n_chr, k,
                                        min_branch, device).count
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            count = None
        cuts = timings._ACC.get("syncs_candidate_ranges", 0) - ranges0
        out = {"rows": int(codes.shape[0]), "k": k, "count": count,
               "s": time.perf_counter() - t0, "free": free,
               # the prefilter's owner ranges, two copies a cut
               "ranges": cuts // 2 + 1,
               "allocated": torch.cuda.max_memory_allocated() - base,
               "reserved": torch.cuda.max_memory_reserved() - base_reserved}
    return out


def log_peak(p: dict, what: str = "") -> None:
    log(f"  {p['rows']}, k={p['k']}{what}: "
        + ("out of memory at " if p["count"] is None else "")
        + f"{p['allocated'] / 1e9:.3f}, {p['reserved'] / 1e9:.3f}, "
          f"{p['s']:.2f} (count {p['count']}"
        + (f", {p['ranges']} prefilter ranges)" if p["k"] <= 32 else ")"))


def fit_peaks(points: list[dict], key: str) -> tuple[float, float]:
    """(bytes a row, constant bytes) of a least-squares line through the
    calls that finished."""
    done = [p for p in points if p["count"] is not None]
    if len(done) < 2:
        return float("nan"), float("nan")
    a, b = np.polyfit([p["rows"] for p in done], [p[key] for p in done], 1)
    return float(a), float(b)


def memory_table(device, sets, gpu: str) -> dict:
    """card_peak of every k class on every supergenome of `sets` (a list
    of strain lists) that the size rule keeps on the card, on the card as
    it is; prints each call, the fitted lines and their extrapolation to
    2^30 - 1 rows against the card's memory.  Every call must finish, and
    where the rule's fitted peak is above 0.9 of what the card gives its
    reserved peak must be under it."""
    import torch
    from sibelia_tpu_torch.index.enum_device import card_free_bytes
    from sibelia_tpu_torch.index.enumeration import (build_supergenome,
                                                     card_peak_bytes,
                                                     host_route)
    total = torch.cuda.get_device_properties(0).total_memory
    points: dict[int, list[dict]] = {k: [] for k, _ in MEMORY_KS}
    log(f"  rows, k: peak allocated GB, peak reserved GB, s ({gpu}; "
        f"{total / 1e9:.2f} GB on the card)")
    for strains in sets:
        codes, block_starts = build_supergenome(strains)
        for k, min_branch in MEMORY_KS:
            torch.cuda.empty_cache()
            why = host_route(codes.shape[0], k, device)
            if why is not None:
                log(f"  {codes.shape[0]}, k={k}: the host route ({why})")
                continue
            p = card_peak(device, codes, block_starts, len(strains), k,
                          min_branch)
            points[k].append(p)
            rule = card_peak_bytes(p["rows"], k)
            near = rule > 0.9 * p["free"]
            log_peak(p, f" (the rule's {rule / 1e9:.3f} of "
                        f"{p['free'] / 1e9:.3f} GB free)")
            if p["count"] is None or (near and p["reserved"] > rule):
                raise RuntimeError(
                    f"k={k}, {p['rows']} rows, kept on the card by the size "
                    f"rule ({rule} B of {p['free']} B): reserved "
                    f"{p['reserved']} B, count {p['count']}")
        del codes
    fits = {}
    top = (1 << 30) - 1
    for k, _ in MEMORY_KS:
        fits[k] = {key: fit_peaks(points[k], key)
                   for key in ("allocated", "reserved")}
        (a, b), (ra, rb) = fits[k]["allocated"], fits[k]["reserved"]
        log(f"  k={k}: allocated {a:.2f} B/row + {b / 1e6:.1f} MB, reserved "
            f"{ra:.2f} B/row + {rb / 1e6:.1f} MB; at {top} rows "
            f"{(a * top + b) / 1e9:.2f} / {(ra * top + rb) / 1e9:.2f} GB "
            f"against {total / 1e9:.2f} GB")
    return {"points": points, "fits": fits}


def rule_at_its_budget(device, sets) -> None:
    """Each k class on each supergenome of `sets` with the card filled to
    leave the size rule's fitted peak and no more: every call finishes,
    its reserved peak under the rule's."""
    from sibelia_tpu_torch.index.enumeration import (build_supergenome,
                                                     card_peak_bytes)
    for strains in sets:
        codes, block_starts = build_supergenome(strains)
        for k, min_branch in MEMORY_KS:
            rule = card_peak_bytes(codes.shape[0], k)
            p = card_peak(device, codes, block_starts, len(strains), k,
                          min_branch, room=rule)
            log_peak(p, f" with {p['free'] / 1e9:.3f} GB left, the rule's "
                        f"{rule / 1e9:.3f}")
            if p["count"] is None or p["reserved"] > rule:
                raise RuntimeError(
                    f"k={k}, {p['rows']} rows at the rule's budget "
                    f"{rule} B: reserved {p['reserved']} B, count "
                    f"{p['count']}")


# the -s loose CLI in a process of its own, from the tree `root`: a warm-up
# run on a small input (CUDA, the kernels and native libraries load; no
# slab below 1 GiB), then the timed run; prints its wall seconds
CLI_RUN = r"""
import json, os, sys, time
root, small, fasta, out, tpath = sys.argv[1:6]
sys.path.insert(0, root)
from sibelia_tpu_torch.cli.sibelia import run
flags = ["-s", "loose", "-m", "5000"]
assert run(flags + ["-o", out + "_warm", small]) == 0
os.environ["SIBELIA_TPU_TIMINGS"] = tpath
t0 = time.perf_counter()
rc = run(flags + ["-o", out, fasta])
print(json.dumps({"rc": rc, "wall": time.perf_counter() - t0}))
"""


def slab_runs(device, work: str, fasta: str, small: str, want: str | None,
              parent: str | None, gpu: str, rounds: int = 2) -> None:
    """-s loose on `fasta` on `device`, each run a process of its own: the
    port here, or with a `parent` tree the two in turns (parent, here,
    here, parent, `rounds` times).  Prints each run's wall, slab_reserve,
    engine_sweep and slab bytes mapped and carved; every run's files equal
    `want`'s (or the first run's)."""
    here = os.path.dirname(os.path.abspath(__file__))
    order = ([("parent", parent), ("here", here), ("here", here),
              ("parent", parent)] * rounds if parent else [("here", here)])
    for i, (what, root) in enumerate(order):
        out = os.path.join(work, f"slab{i}")
        tpath = out + ".json"
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("SIBELIA_TPU_")}
        env["SIBELIA_TPU_TORCH_DEVICE"] = device.type
        proc = subprocess.run(
            [sys.executable, "-c", CLI_RUN, root, small, fasta, out, tpath],
            capture_output=True, text=True, env=env, cwd=root, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"-s loose at {root} failed:\n"
                               + proc.stderr[-3000:])
        wall = json.loads(proc.stdout.strip().splitlines()[-1])["wall"]
        want = want or out
        same_trees(out, want, f"-s loose at {root}")
        with open(tpath) as h:
            ph = json.load(h)
        log(f"  {what} ({root}): wall {wall:.3f} s, slab_reserve "
            f"{ph.get('slab_reserve', 0):g} s, engine_sweep "
            f"{ph.get('engine_sweep', 0):g} s, slab "
            f"{ph.get('slab_bytes', 0) / 1e9:.3f} GB mapped, "
            f"{ph.get('slab_used', 0) / 1e9:.3f} GB carved; files "
            f"identical ({gpu})")


# -s loose with an 8 GiB slab mapped first, in a process of its own: what
# each stage's engine carves from it, against the card route's slab size
CARVE_RUN = r"""
import json, sys
root, fasta, out = sys.argv[1:4]
sys.path.insert(0, root)
from sibelia_tpu_torch import native
from sibelia_tpu_torch.blocks import finder
from sibelia_tpu_torch.cli.sibelia import run
native.slab_reserve(8 << 30)
stages, simplify = [], finder.simplify
def carving(seq, enum, k, *args, **kwargs):
    before = native.slab_stats()[1]
    n = int(sum(len(c) for c in enum.chr))
    ret = simplify(seq, enum, k, *args, **kwargs)
    stages.append([k, n, native.slab_stats()[1] - before])
    return ret
finder.simplify = carving
assert run(["-s", "loose", "-m", "5000", "-o", out, fasta]) == 0
print(json.dumps({"stages": stages, "used": native.slab_stats()[1]}))
"""


def carve_runs(device, work: str, sets, gpu: str) -> None:
    """-s loose on each strain list of `sets` with a slab larger than the
    run carves (``CARVE_RUN``): each stage's carved bytes and instances,
    and the run's carve at least the card route's slab (``slab_bytes``
    before its 1 GiB floor)."""
    from sibelia_tpu_torch.cli.sibelia import ENGINE_BYTES_A_BASE
    from sibelia_tpu_torch.core.config import PRESETS
    here = os.path.dirname(os.path.abspath(__file__))
    n_stages = len(PRESETS["loose"])
    for strains in sets:
        total = sum(len(s) for s in strains)
        fasta = os.path.join(work, f"carve{len(strains)}.fasta")
        write_fasta(fasta, strains)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("SIBELIA_TPU_")}
        env["SIBELIA_TPU_TORCH_DEVICE"] = device.type
        proc = subprocess.run(
            [sys.executable, "-c", CARVE_RUN, here, fasta, fasta + "_out"],
            capture_output=True, text=True, env=env, cwd=here, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("-s loose with a slab failed:\n"
                               + proc.stderr[-3000:])
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        floor = n_stages * ENGINE_BYTES_A_BASE * total
        log(f"  {len(strains)} strains, {total} bases: carved "
            f"{got['used'] / 1e9:.3f} GB ({got['used'] / total:.1f} B a "
            f"base), the card route's slab {floor / 1e9:.3f} GB; by stage "
            "(k, instances, MB, B a base): "
            + "; ".join(f"{k}, {n}, {c / 1e6:.1f}, {c / total:.1f}"
                        for k, n, c in got["stages"]) + f" ({gpu})")
        if got["used"] < floor:
            raise RuntimeError(f"the run carved {got['used']} B, under the "
                               f"card route's slab of {floor} B")


# the k = 30 enumeration of phase 4 in a process of its own, from the tree
# `root`: a warm-up call, then three timed calls
ENUM_RUN = r"""
import json, sys, time
root, path = sys.argv[1:3]
sys.path.insert(0, root)
import numpy as np, torch
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations
with np.load(path) as z:
    strains = [z[f"s{i}"] for i in range(len(z.files))]
device = torch.device("cuda")
enumerate_bifurcations(strains[:1], 30, 150, device)
seconds = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = enumerate_bifurcations(strains, 30, 150, device)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
print(json.dumps({"s": seconds, "count": got.count,
                  "candidates": int(got.candidates.sum())}))
"""


def enum_runs(work: str, strains, parent: str, gpu: str) -> None:
    """Phase 4's k = 30 enumeration, here and at `parent` in turns (parent,
    here, here, parent), each a process of its own: three calls' seconds
    each, the same count and candidates."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(work, "strains.npz")
    np.savez(path, **{f"s{i}": s for i, s in enumerate(strains)})
    seen = set()
    for what, root in (("parent", parent), ("here", here), ("here", here),
                       ("parent", parent)):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("SIBELIA_TPU_")}
        proc = subprocess.run([sys.executable, "-c", ENUM_RUN, root, path],
                              capture_output=True, text=True, env=env,
                              cwd=root, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the enumeration at {root} failed:\n"
                               + proc.stderr[-3000:])
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        seen.add((got["count"], got["candidates"]))
        log(f"  {what} ({root}): k=30 min_branch=150 on "
            f"{len(strains)} strains, s "
            + ", ".join(f"{t:.3f}" for t in got["s"]) + f" ({gpu})")
    if len(seen) != 1:
        raise RuntimeError(f"the trees' enumerations differ: {seen}")


def phase_memory(device, strains, work: str, want: str,
                 parent: str | None, gpu: str) -> dict:
    """The card's peak against rows for the three k classes on 4, 8 and 16
    of the strains, as the card is and with it filled to leave the size
    rule's fitted peak (``rule_at_its_budget``); the route the rule picks
    at 2^30 - 1 rows; the rule's host route on the card (filled to leave
    1 GiB) equal to the card's result; what the engines carve on 4 and 8
    strains against the card route's slab; then the -s loose runs of
    ``slab_runs`` and, with a `parent`, phase 4's enumeration beside the
    parent's.  Returns the launches of the enumerations."""
    import warnings
    import torch
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    from sibelia_tpu_torch.index import enumeration as port_enum
    reset_counts()
    sets = [strains[:c] for c in (4, 8, 16)]
    memory_table(device, sets, gpu)
    log("  the same with the card filled to leave the rule's fitted peak:")
    rule_at_its_budget(device, sets)
    free = port_enum.card_free_bytes(device)
    top = (1 << 30) - 1
    for k, _ in MEMORY_KS:
        log(f"  k={k}: the rule's peak at {top} rows "
            f"{port_enum.card_peak_bytes(top, k) / 1e9:.2f} GB, the card "
            f"gives {free / 1e9:.2f} GB: the "
            f"{'card' if port_enum.fits_on_card(top, k, free) else 'host'}"
            " route")
    small = strains[:4]
    got = port_enum.enumerate_bifurcations(small, MAIN_K, MAIN_MIN_BRANCH,
                                           device)
    with warnings.catch_warnings(record=True) as caught, \
            card_left_with(device, 1 << 30):
        warnings.simplefilter("always")
        host = port_enum.enumerate_bifurcations(
            small, MAIN_K, MAIN_MIN_BRANCH, device)
    if not any(issubclass(w.category, RuntimeWarning)
               and "falling back to the host" in str(w.message)
               for w in caught):
        raise RuntimeError("the size rule sent no warning with the host route")
    got.candidates = None
    same_enumeration(got, host, same_dtypes=False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches.get("enum_segment_scan", 0) < 19:
        raise RuntimeError(f"phase memory launched {launches}")
    log(f"  4 strains, 1 GiB left on the card: the host route, a "
        f"RuntimeWarning, the card's enumeration; launches {launches}")
    log("  -s loose with an 8 GiB slab, what the engines carve:")
    carve_runs(device, work, [strains[:4], strains[:8]], gpu)
    small_fasta = os.path.join(work, "memory_small.fasta")
    write_fasta(small_fasta, [s[:300_000] for s in strains[:2]])
    fasta = os.path.join(work, "strains.fasta")
    slab_runs(device, work, fasta, small_fasta, want, parent, gpu)
    if parent:
        log("  phase 4's enumeration, here and at the parent in turns:")
        enum_runs(work, strains, parent, gpu)
    return {"launches": launches}


# ---------------------------------------------------------------- phase 5 --

def read_tree(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as h:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = h.read()
    return out


LOOSE = ("-s", "loose", "-m", "5000")


def run_cli(device_name: str, fasta: str, outdir: str, tpath: str,
            flags=LOOSE, env: dict[str, str] | None = None) -> float:
    """The port CLI, in process, on one device, with `flags` and the
    environment `env` added; its wall seconds."""
    from sibelia_tpu_torch.cli.sibelia import run
    env = {"SIBELIA_TPU_TORCH_DEVICE": device_name,
           "SIBELIA_TPU_TIMINGS": tpath, **(env or {})}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        rc = run([*flags, "-o", outdir, fasta])
    finally:
        for var in env:
            del os.environ[var]
        os.environ["SIBELIA_TPU_TORCH_DEVICE"] = "cuda"
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"port CLI on {device_name} exited {rc}")
    return seconds


def same_trees(got: str, want: str, what: str) -> dict[str, bytes]:
    """Raises unless the two directories hold the same files, byte for
    byte; returns the second's."""
    a, b = read_tree(got), read_tree(want)
    if sorted(a) != sorted(b):
        raise RuntimeError(f"{what}: output files differ: {sorted(a)} vs "
                           f"{sorted(b)}")
    for name in b:
        if a[name] != b[name]:
            raise RuntimeError(f"{what}: output file differs: {name}")
    return b


TRIM_KEYS = ("trim_resolve", "trim_native", "trim_enum", "trim_walk",
             "trim_calls", "trim_rows", "trim_card_calls", "trim_host_calls",
             "trim_native_calls")


def log_trim(what: str, phases: dict) -> None:
    """The block_trim split and the trim enumerations' route counts."""
    log(f"  {what}: block_trim {phases.get('block_trim', 0):g} s = "
        + ", ".join(f"{key} {phases.get(key, 0):.10g}" for key in TRIM_KEYS))


def trace_busy(path: str) -> tuple[float, float, float]:
    """(kernel s, copy and memset s, window s) of a Chrome trace that
    torch.profiler wrote: the card's events summed, over the span of every
    event."""
    with open(path) as h:
        events = [e for e in json.load(h)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    kernel = sum(e["dur"] for e in events if e.get("cat") == "kernel")
    copies = sum(e["dur"] for e in events
                 if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    return kernel / 1e6, copies / 1e6, (hi - lo) / 1e6


def check_graph_and_checkpoint(strains, work: str) -> None:
    """-g --allstages with --checkpoint on two 100 kbp strains: the card's
    .dot files and outputs equal the CPU's; then the last checkpoint is
    dropped and the resumed card run gives the same files again (but the
    .dot files of the three stages it skips)."""
    fasta = os.path.join(work, "graph.fasta")
    write_fasta(fasta, [s[:100_000] for s in strains[:2]])
    flags = (*LOOSE, "-g", "--allstages")
    ck = os.path.join(work, "ck")
    tpath = os.path.join(work, "graph.json")
    t_card = run_cli("cuda", fasta, os.path.join(work, "graph_card"), tpath,
                     (*flags, "--checkpoint", ck))
    t_cpu = run_cli("cpu", fasta, os.path.join(work, "graph_cpu"), tpath,
                    flags)
    files = same_trees(os.path.join(work, "graph_card"),
                       os.path.join(work, "graph_cpu"), "-g --allstages")
    dots = sorted(name for name in files if name.endswith(".dot"))
    if len(dots) != 5:
        raise RuntimeError(f"-g --allstages wrote {dots}")
    ckpts = sorted(f for f in os.listdir(ck) if f.endswith(".ckpt"))
    if len(ckpts) != 4:
        raise RuntimeError(f"--checkpoint wrote {ckpts}")
    for name in (ckpts[-1], ckpts[-1] + ".hist"):
        os.remove(os.path.join(ck, name))
    t_resumed = run_cli("cuda", fasta, os.path.join(work, "graph_resumed"),
                        tpath, (*flags, "--checkpoint", ck))
    # the stages it skips write no .dot file
    resumed = read_tree(os.path.join(work, "graph_resumed"))
    if sorted(set(files) - set(resumed)) != dots[:3] or any(
            resumed[name] != files.get(name) for name in resumed):
        raise RuntimeError("--checkpoint resume: output files differ")
    log(f"  -g --allstages --checkpoint, 2 x 100 kbp: {len(files)} files "
        f"({len(dots)} .dot) identical on the card ({t_card:.2f} s) and the "
        f"CPU ({t_cpu:.2f} s); resumed after stage 3 from {ckpts[-2]}: "
        f"identical ({t_resumed:.2f} s)")


def phase_e2e(strains, work: str, gpu: str) -> dict:
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    # warm-up on a small input: builds the port's native host engines
    # (g++) so that no timed run below pays for a build
    small = os.path.join(work, "small.fasta")
    write_fasta(small, [s[:300_000] for s in strains[:2]])
    t0 = time.perf_counter()
    run_cli("cuda", small, os.path.join(work, "warm"),
            os.path.join(work, "warm.json"))
    log(f"  warm-up run (native engine builds included) "
        f"{time.perf_counter() - t0:.2f} s")
    fasta = os.path.join(work, "strains.fasta")
    write_fasta(fasta, strains)
    tpath = os.path.join(work, "timings.json")
    reset_counts()
    t_card = run_cli("cuda", fasta, os.path.join(work, "card"), tpath)
    launches = dict(LAUNCHES)
    with open(tpath) as h:
        phases = json.load(h)
    t_cpu = run_cli("cpu", fasta, os.path.join(work, "cpu"),
                    os.path.join(work, "cpu.json"))
    want = same_trees(os.path.join(work, "card"), os.path.join(work, "cpu"),
                      "-s loose")
    if "blocks_coords.txt" not in want:
        raise RuntimeError("-s loose wrote no blocks_coords.txt")
    reprefilter = phases.get("reprefilter_calls", 0)
    log(f"  {len(want)} output files identical; card {t_card:.3f} s, CPU "
        f"plain {t_cpu:.3f} s; launches {launches}; re-prefilter calls "
        f"{reprefilter:g}")
    log("  card run phases (s): " + json.dumps(phases, sort_keys=True))
    log_trim("card run", phases)
    with open(os.path.join(work, "cpu.json")) as h:
        log_trim("CPU run", json.load(h))
    card_trims = int(phases.get("trim_card_calls", 0))
    if (launches.get("enum_segment_scan", 0) < 5 + card_trims
            or card_trims <= 0 or reprefilter <= 0):
        raise RuntimeError("the main path did not go through the card: "
                           "fewer than 5 + trim_card_calls segment scan "
                           "launches (4 stages, the final block generation "
                           "and the trim enumerations), or none of those")
    check_graph_and_checkpoint(strains, work)
    prof_dir = os.path.join(work, "prof")
    run_cli("cuda", fasta, os.path.join(work, "card_prof"),
            os.path.join(work, "prof.json"),
            env={"SIBELIA_TPU_PROFILE_DIR": prof_dir})
    same_trees(os.path.join(work, "card_prof"), os.path.join(work, "card"),
               "SIBELIA_TPU_PROFILE_DIR")
    kernel_s, copy_s, window_s = trace_busy(
        os.path.join(prof_dir, "sibelia.pt.trace.json"))
    log(f"  profiled -s loose run (untimed; files identical): the card busy "
        f"{kernel_s / window_s:.2%} of the {window_s:.3f} s window with "
        f"kernels ({kernel_s:.4f} s), {copy_s / window_s:.2%} with copies "
        f"and memsets ({copy_s:.4f} s) ({gpu})")
    return {"launches": launches, "card_s": t_card, "cpu_s": t_cpu}


# ---------------------------------------------------------------- phase 6 --

CSIB_SIZE = 2_800_000  # C-Sibelia's S. aureus example, one strain
CSIB_FAST_SIZE = 1_400_000  # the fast-mode run: half of it


def write_csibelia_pair(work: str, size: int) -> tuple[str, str]:
    """ref_<size>.fasta: one strain of `size` bases; asm_<size>.fasta: a
    second strain of the same base cut into contigs of 20-200 kbp."""
    ref, asm = make_strains(2, size, SEED)
    rng = np.random.default_rng(SEED + 1)
    cuts = [0]
    while len(asm) - cuts[-1] > 200_000:
        cuts.append(cuts[-1] + int(rng.integers(20_000, 200_001)))
    cuts.append(len(asm))
    paths = (os.path.join(work, f"ref_{size}.fasta"),
             os.path.join(work, f"asm_{size}.fasta"))
    write_fasta(paths[0], [ref], ["reference"])
    write_fasta(paths[1], [asm[lo:hi] for lo, hi in zip(cuts, cuts[1:])],
                [f"contig_{i:03d}" for i in range(len(cuts) - 1)])
    return paths


FAST = {"SIBELIA_TPU_ALIGNER": "fast", "SIBELIA_TPU_DEVICE_ALIGN": "1"}


def run_csibelia(device_name: str, ref: str, asm: str, outdir: str,
                 tpath: str, switches: dict[str, str]) -> float:
    """The port's C-Sibelia CLI, in process, on one device, under the
    aligner `switches` (FAST: the fast aligner with device gap batching;
    none: the default exact mode); its wall seconds."""
    from sibelia_tpu_torch.cli.csibelia import run
    env = {"SIBELIA_TPU_TORCH_DEVICE": device_name,
           "SIBELIA_TPU_TIMINGS": tpath, **switches}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        rc = run([ref, asm, "-o", outdir, "--maf", "alignment.maf"])
    finally:
        for var in env:
            del os.environ[var]
        os.environ["SIBELIA_TPU_TORCH_DEVICE"] = "cuda"
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"port C-Sibelia on {device_name} exited {rc}")
    return seconds


def check_csibelia_scans(launches: dict, phases: dict) -> None:
    """Raises unless the segment scan ran for C-Sibelia's three stages,
    their three block generations, the final one and every trim
    enumeration that took the card's route, and some did."""
    card_trims = int(phases.get("trim_card_calls", 0))
    if card_trims <= 0 or launches.get("enum_segment_scan", 0) < 7 + card_trims:
        raise RuntimeError("the C-Sibelia run did not go through the card: "
                           "fewer than 7 + trim_card_calls segment scan "
                           "launches (3 stages, 3 stage block generations, "
                           "the final one and the trim enumerations), or no "
                           "trim enumeration on the card")


def log_gap_sizes(sizes: np.ndarray) -> None:
    """The (n, m) histogram of a run's gap pairs, by the larger side's
    size class and by the kernel's column classes (m alone)."""
    n, m = sizes[:, 0], sizes[:, 1]
    edges = [0, 1, 2, 4, 8, 16, 32, 64, 128]
    longer = np.histogram(np.maximum(n, m), bins=np.array(edges) + 0.5)[0]
    log(f"  gap pairs: {len(sizes)}; max(n, m) in "
        + ", ".join(f"{lo + 1}-{hi}: {c}" for lo, hi, c in
                    zip(edges, edges[1:], longer))
        + f"; 1 x 1: {int(((n == 1) & (m == 1)).sum())}; n == m: "
        f"{int((n == m).sum())}; m <= 32: {int((m <= 32).sum())}, 33-64: "
        f"{int(((m > 32) & (m <= 64)).sum())}, above: {int((m > 64).sum())}; "
        f"cells {int((n * m).sum())}, bytes {int((n + m).sum())}; longest "
        f"n {int(n.max())}, m {int(m.max())}")


def phase_csibelia(device, work: str, gpu: str, ref: str, asm: str) -> dict:
    import sibelia_tpu_torch.variants.aligner as port_aligner
    from sibelia_tpu_torch.core.platform import (GOTOH_FLUSHES, LAUNCHES,
                                                 reset_counts)
    largest: list = []
    sizes: list[tuple[int, int]] = []
    flush_s: list[float] = []
    batch_align = port_aligner.batch_align

    def recording(pairs, T, dev):
        if len(pairs) > len(largest):
            largest[:] = pairs
        sizes.extend((len(a), len(b)) for a, b in pairs)
        t0 = time.perf_counter()
        out = batch_align(pairs, T, dev)
        flush_s.append(time.perf_counter() - t0)
        return out

    tpath = os.path.join(work, "csib_timings.json")
    port_aligner.batch_align = recording
    reset_counts()
    try:
        t_card = run_csibelia("cuda", ref, asm,
                              os.path.join(work, "csib_card"), tpath, FAST)
    finally:
        port_aligner.batch_align = batch_align
    launches, flushes = dict(LAUNCHES), list(GOTOH_FLUSHES)
    with open(tpath) as h:
        phases = json.load(h)
    cpu_tpath = os.path.join(work, "csib_cpu.json")
    reset_counts()  # the CPU run's dump counts only its own flushes
    t_cpu = run_csibelia("cpu", ref, asm, os.path.join(work, "csib_cpu"),
                         cpu_tpath, FAST)
    for name in ("variant.vcf", "alignment.maf"):
        with open(os.path.join(work, "csib_card", name), "rb") as h:
            got = h.read()
        with open(os.path.join(work, "csib_cpu", name), "rb") as h:
            want = h.read()
        if got != want:
            raise RuntimeError(f"C-Sibelia output differs: {name}")
    with open(os.path.join(work, "csib_card", "variant.vcf")) as h:
        records = sum(1 for ln in h if not ln.startswith("#"))
    log(f"  variant.vcf ({records} records) and alignment.maf identical; "
        f"card {t_card:.3f} s, CPU plain {t_cpu:.3f} s; launches {launches}")
    log(f"  gap batches: {len(flushes)} flushes, {sum(flushes)} pairs, "
        f"pairs per flush min {min(flushes, default=0)} median "
        f"{float(np.median(flushes)) if flushes else 0:g} max "
        f"{max(flushes, default=0)}")
    log("  card run phases (s): " + json.dumps(phases, sort_keys=True))
    with open(cpu_tpath) as h:
        cpu_phases = json.load(h)
    log("  CPU run phases (s): " + json.dumps(cpu_phases, sort_keys=True))
    log_trim("card run", phases)
    log_trim("CPU run", cpu_phases)
    log_gap_sizes(np.array(sizes, dtype=np.int64).reshape(-1, 2))
    log(f"  batch_align on the card (pack, upload, kernel, download, "
        f"decode): {sum(flush_s):.4f} s in {len(flush_s)} calls, the first "
        f"{flush_s[0]:.4f} s, the longest of the rest "
        f"{max(flush_s[1:], default=0.0):.4f} s")
    check_csibelia_scans(launches, phases)
    if launches.get("gotoh_align", 0) <= 0 or records <= 0:
        raise RuntimeError("the C-Sibelia run did not go through the card: "
                           "no Gotoh launch")
    name = "largest gap batch of the run"
    dirs_ms, _, err = compare_gotoh(name, largest, GOTOH_T, device, 5)
    rows = compare_gotoh_rows(name, largest, GOTOH_T, device, 5)
    log_gotoh_times(name, len(largest), GOTOH_T, rows, dirs_ms, gpu)
    return {"launches": launches, "card_s": t_card, "cpu_s": t_cpu,
            "max_abs_err": max(err, rows["max_abs_err"])}


# ---------------------------------------------------------------- phase 7 --

def log_classes(what: str, values, edges) -> None:
    counts = np.histogram(np.asarray(values), bins=np.array(edges) + 0.5)[0]
    log(f"  {what}: " + ", ".join(
        f"{lo + 1}-{hi}: {c}" for lo, hi, c in zip(edges, edges[1:], counts)))


def phase_csibelia_exact(device, work: str, gpu: str, ref: str,
                         asm: str, parent: str | None = None) -> dict:
    """The default mode of C-Sibelia on the card against the same CLI on
    the CPU (native anchors and order stages); then the exact aligner's
    kernels again on what the run gave them, the walk of its largest batch
    also beside the parent's (`parent`)."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    from sibelia_tpu_torch.align.lagan_exact import RECURSION_LEVELS
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    from sibelia_tpu_torch.kernels import order_device as od
    from sibelia_tpu_torch.native import lagan_anchors, lagan_order
    batches: list = []   # (args, table) of every band_rows call
    bands: list = []     # the band of every band_params call
    texts: list = []     # (jobs, -mfa texts) of every order_mfa_device_batch
    largest: dict = {}   # the sweep and the anchors text with the most hits
    sweep_s: list[float] = []
    real = (od.band_rows, od.band_params, od.order_mfa_device_batch,
            ad.sweep_packed, ad.anchors_text_device_batch)

    def recording_band_rows(*args):
        batches.append((list(args[:3]), args[3]))
        return real[0](*args)

    def recording_band_params(band, table):
        bands.append(band)
        return real[1](band, table)

    def recording_mfa(jobs, *args):
        out = real[2](jobs, *args)
        texts.append((jobs, out))
        return out

    def recording_sweep(*args):
        if args[0].shape[0] > largest.get("n", 0):
            largest.update(n=args[0].shape[0], sweep=args)
        t0 = time.perf_counter()
        out = real[3](*args)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        return out

    def recording_texts(hits_texts, gfc, dev):
        for text in hits_texts:
            if len(text) > len(largest.get("text", "")):
                largest.update(text=text, gfc=gfc)
        return real[4](hits_texts, gfc, dev)

    (od.band_rows, od.band_params, od.order_mfa_device_batch,
     ad.sweep_packed, ad.anchors_text_device_batch) = (
        recording_band_rows, recording_band_params, recording_mfa,
        recording_sweep, recording_texts)
    hits_before = len(ad.HITS_PER_SWEEP)
    tpath = os.path.join(work, "exact_timings.json")
    reset_counts()
    try:
        t_card = run_csibelia("cuda", ref, asm,
                              os.path.join(work, "exact_card"), tpath, {})
    finally:
        (od.band_rows, od.band_params, od.order_mfa_device_batch,
         ad.sweep_packed, ad.anchors_text_device_batch) = real
    launches = dict(LAUNCHES)
    hits = ad.HITS_PER_SWEEP[hits_before:]
    with open(tpath) as h:
        phases = json.load(h)
    cpu_tpath = os.path.join(work, "exact_cpu.json")
    reset_counts()
    t_cpu = run_csibelia("cpu", ref, asm, os.path.join(work, "exact_cpu"),
                         cpu_tpath, {})
    for name in ("variant.vcf", "alignment.maf"):
        with open(os.path.join(work, "exact_card", name), "rb") as h:
            got = h.read()
        with open(os.path.join(work, "exact_cpu", name), "rb") as h:
            want = h.read()
        if got != want:
            raise RuntimeError(f"exact C-Sibelia output differs: {name}")
    with open(os.path.join(work, "exact_card", "variant.vcf")) as h:
        records = sum(1 for ln in h if not ln.startswith("#"))
    log(f"  variant.vcf ({records} records) and alignment.maf identical; "
        f"card {t_card:.3f} s, CPU (native stages) {t_cpu:.3f} s; launches "
        f"{launches}")
    log("  card run phases (s): " + json.dumps(phases, sort_keys=True))
    with open(cpu_tpath) as h:
        cpu_phases = json.load(h)
    log("  CPU run phases (s): " + json.dumps(cpu_phases, sort_keys=True))
    log_trim("card run", phases)
    log_trim("CPU run", cpu_phases)
    check_csibelia_scans(launches, phases)
    tables = np.concatenate([t for _, t in batches])
    row_bytes = sum(od.rows_bytes(t) for _, t in batches)
    log(f"  band DPs: {phases['order_device_jobs']} on the card in "
        f"{len(batches)} batches, {phases['order_host_fallback']} kept by "
        f"the native engine (order_host_fallback); {row_bytes} B of pointer "
        f"rows stayed on the card, order_row_bytes = "
        f"{phases['order_row_bytes']} B of moves and counts came back")
    log_classes("diagonals a pair", tables[:, od.T_DIAGS],
                [0, 1000, 4000, 16_000, 64_000, 256_000, 1_024_000])
    log("  wmax: " + ", ".join(
        f"{w}: {int((tables[:, od.T_WMAX] == w).sum())}"
        for w in np.unique(tables[:, od.T_WMAX]).tolist()))
    log(f"  sweeps: {len(hits)} sets in {len(sweep_s)} calls, "
        f"{sum(sweep_s):.4f} s in sweep_packed (the launches and a "
        f"synchronise; the longest {max(sweep_s):.4f} s)")
    log_classes("hits a sweep", hits,
                [0, 1, 4, 16, 64, 256, 1024, 4096, 16_384, 1 << 20])
    for name in ("order_band", "order_moves", "band_params", "anchors_sweep"):
        if launches.get(name, 0) <= 0:
            raise RuntimeError("the exact run did not go through the card: "
                               f"no {name} launch")
    if launches["anchors_sweep"] > 2 * len(RECURSION_LEVELS):
        raise RuntimeError(f"{launches['anchors_sweep']} sweep launches for "
                           f"{len(RECURSION_LEVELS)} levels: not in lockstep")
    if (phases["order_device_jobs"] <= 0 or phases["order_host_fallback"]
            or records <= 0 or phases["order_row_bytes"] * 10 > row_bytes):
        raise RuntimeError("the exact run's band DPs: none on the card, a "
                           "host fallback, or pointer rows that came back")
    t0 = time.perf_counter()
    n_texts = 0
    for jobs, out in texts:
        for job, text in zip(jobs, out):
            n_texts += 1
            if text != lagan_order(*job):
                raise RuntimeError("-mfa text of a pair of the run differs "
                                   "from native lagan_order")
    log(f"  -mfa text of the run's {n_texts} pairs equals native lagan_order "
        f"({time.perf_counter() - t0:.1f} s of native order)")

    # the order kernels on the run's largest batch (moves and params against
    # their plain versions), and the band DP against the plain version on
    # that batch's pairs of up to ORDER_PLAIN_DIAGS diagonals
    at = max(range(len(batches)), key=lambda i: od.rows_bytes(batches[i][1]))
    args, table = batches[at]
    whole = compare_order("the run's largest batch", args, table, device,
                          gpu, plain=False, band=bands[at], warm_s=0.5)
    narrow_walk_times("the run's largest batch", args, table, device, gpu,
                      parent_order_lib(parent) if parent else None)
    alone = od.sub_table(table, np.array([int(table[:, od.T_DIAGS]
                                              .argmax())]))
    ms, _ = timed(lambda: od.band_rows(*args, alone), device, 3)
    log(f"  that batch's longest pair alone: {int(alone[0, od.T_DIAGS])} "
        f"diagonals, band DP {ms:.3f} ms ({gpu})")
    keep = np.flatnonzero((table[:, od.T_DIAGS] <= ORDER_PLAIN_DIAGS)
                          & (table[:, od.T_WMAX] <= 256))[:48]
    if keep.size == 0:  # then the pair with the fewest diagonals
        keep = np.array([int(table[:, od.T_DIAGS].argmin())])
    order = compare_order(
        f"its pairs of at most {ORDER_PLAIN_DIAGS} diagonals",
        args, od.sub_table(table, keep), device, gpu)
    order["batch_ms"] = whole["ms"]
    sweep = compare_sweep("the run's level with the most hits",
                          largest["sweep"][:5], largest["sweep"][5], device,
                          gpu)
    native_ms, _ = timed_host(lambda: lagan_anchors(largest["text"],
                                                    gfc=largest["gfc"]))
    stage_ms, _ = timed_host(lambda: ad.anchors_text_device(
        largest["text"], largest["gfc"], device))
    log(f"  the anchors stage on the run's longest text alone: on the card "
        f"{stage_ms:.2f} ms (parsers, upload, kernel, download), native "
        f"lagan_anchors {native_ms:.2f} ms ({gpu})")
    return {"launches": launches, "card_s": t_card, "cpu_s": t_cpu,
            "order": order, "whole": whole, "sweep": sweep}


# ------------------------------------------------------------ phase tools --

PY_ENGINE_SIZE = 200_000  # (a): two strains of this many bases
CHECK_SIZE = 5_000        # (b): the invariant check is O(genome) a collapse
# (c): the draft flow aligns both strands of every contig against the whole
# finished sequence, and the wrong strand has no anchor: its band is the
# whole matrix, min(finished, contig) lanes wide.  So contigs stay under
# 4,096 bases (wmax 4,096) and the finished strain at 40 kbp, which keeps
# every pair's pointer rows under the card's 256 MB budget a pair (no host
# fallback) and the CPU's native DP of the wrong strands (about 40 s) in
# the phase's time
DRAFT_FINISHED = 40_000
DRAFT_CONTIGS = 10
DRAFT_CONTIG_LEN = (1_500, 3_000)
DRAFT_RC = (1, 4, 7)      # contigs reverse-complemented
SLAGAN_SIZE = 200_000     # (d): a pair with an inversion and a translocation
PROLAGAN_SIZE = 20_000    # (e): two profiles of two sequences each


def need_launches(launches: dict, names, what: str,
                  at_least: int = 1) -> None:
    for name in names:
        if launches.get(name, 0) < at_least:
            raise RuntimeError(f"{what} did not go through the card: fewer "
                               f"than {at_least} {name} launches "
                               f"({launches})")


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def tools_python_engine(work: str, gpu: str, total: dict) -> None:
    """(a) -s loose under SIBELIA_TPU_NATIVE=0 on the card and on the CPU,
    identical to each other and to the card's native-engine run."""
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    fasta = os.path.join(work, "py_engine.fasta")
    write_fasta(fasta, make_strains(2, PY_ENGINE_SIZE, SEED + 2))
    off = {"SIBELIA_TPU_NATIVE": "0"}
    runs = {}
    for name, dev, env in (("native", "cuda", None), ("python_cpu", "cpu", off),
                           ("python_card", "cuda", off)):
        tpath = os.path.join(work, f"{name}.json")
        reset_counts()
        seconds = run_cli(dev, fasta, os.path.join(work, name), tpath,
                          env=env)
        with open(tpath) as h:
            runs[name] = (seconds, json.load(h), dict(LAUNCHES))
    launches = runs["python_card"][2]
    add_launches(total, launches)
    files = same_trees(os.path.join(work, "python_card"),
                       os.path.join(work, "python_cpu"), "NATIVE=0 card/CPU")
    same_trees(os.path.join(work, "python_card"),
               os.path.join(work, "native"), "NATIVE=0 against native")
    if "blocks_coords.txt" not in files:
        raise RuntimeError("the Python engine's run wrote no blocks")
    log(f"  (a) -s loose -m 5000, 2 x {PY_ENGINE_SIZE:,} bp, "
        f"SIBELIA_TPU_NATIVE=0: {len(files)} files identical on the card, "
        f"the CPU and the card's native engine; " + "; ".join(
            f"{name} {sec:.3f} s (simplification {ph.get('simplification')}"
            f" s, enumeration {ph.get('enumeration')} s)"
            for name, (sec, ph, _) in runs.items())
        + f"; launches of the card's Python-engine run {launches} ({gpu})")
    # the four stages' enumerations and the final block generation's
    need_launches(launches, ("enum_segment_scan",),
                  "the Python engine's run", 5)


def tools_check(work: str, gpu: str, total: dict) -> None:
    """(b) SIBELIA_TPU_CHECK=1 on 2 x 5 kbp, card against CPU."""
    from sibelia_tpu_torch.blocks import finder
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    fasta = os.path.join(work, "check.fasta")
    write_fasta(fasta, make_strains(2, CHECK_SIZE, SEED + 2))
    checks = [0]
    real = finder.check_invariants

    def counting(*args):
        checks[0] += 1
        return real(*args)

    finder.check_invariants = counting
    try:
        reset_counts()
        t_card = run_cli("cuda", fasta, os.path.join(work, "check_card"),
                         os.path.join(work, "check_card.json"),
                         ("-s", "loose", "-m", "500"),
                         {"SIBELIA_TPU_CHECK": "1"})
        launches = dict(LAUNCHES)
        n_card = checks[0]
        t_cpu = run_cli("cpu", fasta, os.path.join(work, "check_cpu"),
                        os.path.join(work, "check_cpu.json"),
                        ("-s", "loose", "-m", "500"),
                        {"SIBELIA_TPU_CHECK": "1"})
    finally:
        finder.check_invariants = real
    add_launches(total, launches)
    files = same_trees(os.path.join(work, "check_card"),
                       os.path.join(work, "check_cpu"), "SIBELIA_TPU_CHECK=1")
    if n_card <= 4 or checks[0] != 2 * n_card:
        raise RuntimeError(f"SIBELIA_TPU_CHECK=1: {n_card} checks on the "
                           f"card, {checks[0] - n_card} on the CPU")
    need_launches(launches, ("enum_segment_scan",), "SIBELIA_TPU_CHECK=1")
    log(f"  (b) SIBELIA_TPU_CHECK=1, 2 x {CHECK_SIZE:,} bp, -s loose -m 500: "
        f"{len(files)} files identical, {n_card} invariant checks a run, no "
        f"violation; card {t_card:.3f} s, CPU {t_cpu:.3f} s ({gpu})")


def draft_input() -> tuple[str, str]:
    """A finished strain and DRAFT_CONTIGS contigs cut from a related one,
    DRAFT_RC of them reverse-complemented, as FASTA texts."""
    from sibelia_tpu_torch.align.toolkit import reverse_complement_fasta
    finished, other = make_strains(2, DRAFT_FINISHED, SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(*DRAFT_CONTIG_LEN, DRAFT_CONTIGS)
    spare = len(other) - int(lens.sum())
    gaps = np.diff(np.sort(rng.integers(0, spare, DRAFT_CONTIGS + 1)))
    texts, at = [], 0
    for i, (ln, gap) in enumerate(zip(lens.tolist(), gaps.tolist())):
        at += gap
        text = f">contig{i}\n{other[at:at + ln].tobytes().decode()}\n"
        texts.append(reverse_complement_fasta(text) if i in DRAFT_RC
                     else text)
        at += ln
    return f">finished\n{finished.tobytes().decode()}\n", "".join(texts)


def exact_stats() -> tuple[int, int]:
    from sibelia_tpu_torch.kernels import order_device as od
    return od.STATS["device_jobs"], od.STATS["host_fallback"]


# the phases of the exact aligner's stages (core/timings), split card / CPU
EXACT_PHASES = ("rechaos", "anchors_parse", "anchors_device", "order_prepare",
                "order_device", "order_finish")


def card_and_cpu(fn, what: str, gpu: str, total: dict):
    """fn(device) on the card (counts from 0) and on the CPU; raises unless
    the results are equal or a band DP fell back to the host on the card.
    Returns (result, launches, band DPs on the card, card s, CPU s, record):
    the record holds each side's exact-aligner phases (``card``, ``cpu``),
    the table of every band_rows call on the card (``tables``), the
    arguments of every sweep_packed call there (``sweeps``) and the hits
    of every sweep set there (``hits``)."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    from sibelia_tpu_torch.core import timings
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    from sibelia_tpu_torch.kernels import order_device as od
    jobs0, fallback0 = exact_stats()
    rec = {"tables": [], "sweeps": []}
    real = od.band_rows, ad.sweep_packed

    def recording(*args):
        rec["tables"].append(args[3])
        return real[0](*args)

    def recording_sweep(*args):
        rec["sweeps"].append(args)
        return real[1](*args)

    reset_counts()
    timings.reset()
    hits0 = len(ad.HITS_PER_SWEEP)
    od.band_rows, ad.sweep_packed = recording, recording_sweep
    try:
        t0 = time.perf_counter()
        got = fn(torch.device("cuda"))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
    finally:
        od.band_rows, ad.sweep_packed = real
    rec["hits"] = ad.HITS_PER_SWEEP[hits0:]
    rec["card"] = timings.snapshot()
    launches = dict(LAUNCHES)
    jobs, fallback = exact_stats()
    timings.reset()
    t0 = time.perf_counter()
    want = fn(torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    rec["cpu"] = timings.snapshot()
    add_launches(total, launches)
    if got != want:
        raise RuntimeError(f"{what}: the card's result differs from the CPU's")
    if fallback != fallback0:
        raise RuntimeError(f"{what}: {fallback - fallback0} band DPs fell "
                           "back to the host")
    return got, launches, jobs - jobs0, t_card, t_cpu, rec


def log_exact_record(what: str, rec: dict) -> None:
    """The exact aligner's phases card / CPU, the band DPs' (nd, wmax) and
    the launches of each form, the sweep's sets by hits, for one tool."""
    from sibelia_tpu_torch.kernels import order_device as od
    log(f"  {what}: phases card / CPU (s): " + ", ".join(
        f"{name} {rec['card'].get(name, 0)} / {rec['cpu'].get(name, 0)}"
        for name in EXACT_PHASES))
    tables = rec["tables"]
    if tables:
        every = np.concatenate(tables)
        classes = [int(w) for t in tables
                   for w in np.unique(t[:, od.T_WMAX]).tolist()]
        narrow = sum(w <= 32 for w in classes)
        log(f"  {what}: {every.shape[0]} band DPs in {len(tables)} batches; "
            f"band and traceback launches: warp form (wmax <= 32) {narrow}, "
            f"wide form {len(classes) - narrow}; (diagonals, wmax) of each: "
            + ", ".join(f"({d}, {w})" for d, w in sorted(
                every[:, [od.T_DIAGS, od.T_WMAX]].tolist())))
    hits = np.asarray(rec["hits"], dtype=np.int64)
    wide = int((hits > 32).sum())
    log_classes(f"{what}: hits a sweep set ({hits.size} sets, {wide} of "
                "more than 32: the sweep's block form)", hits,
                [0, 1, 4, 16, 32, 64, 256, 1024, 4096, 1 << 20])


# (c)'s draft_assemble or (d)'s slagan_pairwise on the card in a process of
# its own, from the tree `root`: a warm-up call, then two timed calls, with
# the exact aligner's phases and the launches of the last, and a digest of
# what it returned
TREE_RUN = r"""
import hashlib, json, sys, time
root, tool, first, second = sys.argv[1:5]
sys.path.insert(0, root)
import torch
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
with open(first, "rb") as h, open(second, "rb") as g:
    first, second = h.read(), g.read()
device = torch.device("cuda")
if tool == "draft":
    from sibelia_tpu_torch.align.draft import draft_assemble
    call = lambda: draft_assemble(first.decode(), second.decode(),
                                  device=device)["merged"]
else:
    from sibelia_tpu_torch.align.glocal import slagan_pairwise
    call = lambda: slagan_pairwise(first, "strainA", second, "strainB",
                                   device=device)
call()
seconds = []
for _ in range(2):
    reset_counts()
    timings.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
print(json.dumps({"s": seconds, "phases": timings.snapshot(),
                  "launches": dict(LAUNCHES),
                  "digest": hashlib.sha256(repr(got).encode()).hexdigest()}))
"""


def tree_runs(tool: str, parent: str, gpu: str) -> None:
    """(c)'s draft_assemble (`tool` "draft") or (d)'s slagan_pairwise
    ("slagan") here and at `parent` in turns (parent, here, here, parent),
    each a process of its own: two calls' seconds, the exact aligner's
    phases and launches; the same result."""
    here = os.path.dirname(os.path.abspath(__file__))
    what = {"draft": "(c)", "slagan": "(d)"}[tool]
    seen = set()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as work:
        paths = [os.path.join(work, name) for name in ("first", "second")]
        texts = draft_input() if tool == "draft" else slagan_input()
        for path, text in zip(paths, texts):
            with open(path, "wb") as h:
                h.write(text.encode() if isinstance(text, str) else text)
        for who, root in (("parent", parent), ("here", here),
                          ("here", here), ("parent", parent)):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("SIBELIA_TPU_")}
            proc = subprocess.run([sys.executable, "-c", TREE_RUN, root, tool,
                                   *paths], capture_output=True, text=True,
                                  env=env, cwd=root, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"{what} at {root} failed:\n"
                                   + proc.stderr[-3000:])
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            seen.add(got["digest"])
            log(f"  {what} {who} ({root}): s " + ", ".join(
                f"{t:.3f}" for t in got["s"]) + "; " + ", ".join(
                f"{name} {got['phases'].get(name, 0)}"
                for name in EXACT_PHASES) + f"; launches {got['launches']} "
                f"({gpu})")
    if len(seen) != 1:
        raise RuntimeError(f"the trees' {what} results differ")


def tools_draft(gpu: str, total: dict) -> None:
    """(c) draft_assemble, card against CPU (native stages)."""
    from sibelia_tpu_torch.align.draft import draft_assemble
    finished, contigs = draft_input()
    res, launches, jobs, t_card, t_cpu, rec = card_and_cpu(
        lambda dev: draft_assemble(finished, contigs, device=dev),
        "draft_assemble", gpu, total)
    need_launches(launches, ("anchors_sweep", "band_params", "order_band",
                             "order_moves"), "draft_assemble")
    if res["merged"] is None or jobs != 2 * DRAFT_CONTIGS:
        raise RuntimeError(f"draft_assemble: {jobs} band DPs on the card, "
                           f"merged {res['merged'] is not None}")
    log(f"  (c) draft_assemble, {DRAFT_FINISHED:,} bp finished, "
        f"{DRAFT_CONTIGS} contigs of {DRAFT_CONTIG_LEN[0]:,}-"
        f"{DRAFT_CONTIG_LEN[1]:,} bp ({len(DRAFT_RC)} reverse-complemented): "
        f"merged text ({len(res['merged']):,} chars), minfo, "
        f"{len(res['draft_lines'])} draft lines and skipped "
        f"{res['skipped']} identical; {jobs} band DPs on the card, no host "
        f"fallback; card {t_card:.3f} s, CPU {t_cpu:.3f} s; launches "
        f"{launches} ({gpu})")
    log_exact_record("(c)", rec)


def slagan_input() -> tuple[bytes, bytes]:
    """Two related 200 kbp strains, the second with a 20 kbp inversion and
    a 15 kbp segment moved 35 kbp downstream."""
    a, b = make_strains(2, SLAGAN_SIZE, SEED + 4)
    n = len(b)
    inv = slice(3 * n // 10, 3 * n // 10 + 20_000)
    b = b.copy()
    b[inv] = COMP[b[inv]][::-1]
    lo = 6 * n // 10
    seg, rest = b[lo:lo + 15_000], np.concatenate([b[:lo], b[lo + 15_000:]])
    at = lo + 35_000
    b = np.concatenate([rest[:at], seg, rest[at:]])
    return a.tobytes(), b.tobytes()


def tools_slagan(gpu: str, total: dict) -> None:
    """(d) slagan_pairwise, card against CPU."""
    from sibelia_tpu_torch.align.glocal import slagan_pairwise
    a, b = slagan_input()
    regions, launches, jobs, t_card, t_cpu, rec = card_and_cpu(
        lambda dev: slagan_pairwise(a, "strainA", b, "strainB", device=dev),
        "slagan_pairwise", gpu, total)
    need_launches(launches, ("anchors_sweep", "band_params", "order_band",
                             "order_moves"), "slagan_pairwise")
    strands = "".join(r["strand"] for r in regions)
    if "-" not in strands or jobs != len(regions):
        raise RuntimeError(f"slagan_pairwise: regions {strands}, {jobs} band "
                           "DPs on the card")
    log(f"  (d) slagan_pairwise, 2 x {SLAGAN_SIZE:,} bp, a 20 kbp inversion "
        f"and a 15 kbp translocation: {len(regions)} regions ({strands}; "
        + ", ".join(f"{r['type']} {r['s1'][0]}-{r['s1'][1]}"
                    for r in regions)
        + f") and rows identical; {launches.get('order_band', 0)} band "
        f"launches for the map; card {t_card:.3f} s, CPU {t_cpu:.3f} s; "
        f"launches {launches} ({gpu})")
    log_exact_record("(d)", rec)


def tools_prolagan(gpu: str, total: dict, parent: str | None = None
                   ) -> None:
    """(e) prolagan_fasta on two profiles of two 20 kbp sequences; then
    each of its sweep calls (a recursion level's sets) timed, beside the
    parent's (`parent`)."""
    import torch
    from sibelia_tpu_torch.align.lagan_exact import RECURSION_LEVELS
    from sibelia_tpu_torch.align.mlagan_exact import align_multiple_exact
    from sibelia_tpu_torch.align.prolagan import prolagan_fasta
    seqs = [s.tobytes() for s in make_strains(4, PROLAGAN_SIZE, SEED + 5)]
    names = [f"seq{i}" for i in range(4)]
    pro1 = list(zip(names[:2], align_multiple_exact(seqs[:2], names[:2])))
    pro2 = list(zip(names[2:], align_multiple_exact(seqs[2:], names[2:])))
    tree = f"(({names[0]} {names[1]}) ({names[2]} {names[3]}))"
    fasta, launches, _, t_card, t_cpu, rec = card_and_cpu(
        lambda dev: prolagan_fasta(seqs, names, pro1, pro2, tree, dev),
        "prolagan_fasta", gpu, total)
    sweeps = launches.get("anchors_sweep", 0)
    if not 0 < sweeps <= 2 * len(RECURSION_LEVELS):
        raise RuntimeError(f"prolagan_fasta: {sweeps} sweep launches for "
                           f"{len(RECURSION_LEVELS)} levels")
    log(f"  (e) prolagan_fasta, two profiles of two {PROLAGAN_SIZE:,} bp "
        f"sequences: FASTA identical ({len(fasta):,} chars); {sweeps} sweep "
        f"launches for the 4 pairs' {len(RECURSION_LEVELS)} levels; card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s ({gpu})")
    log_exact_record("(e)", rec)
    lib = parent_anchors_lib(parent) if parent else None
    for level, args in enumerate(rec["sweeps"]):
        sweep_times(f"(e) sweep call {level + 1}", list(args[:5]), args[5],
                    torch.device("cuda"), gpu, lib)


def phase_tools(work: str, gpu: str, parent: str | None = None) -> dict:
    """The modules no port CLI reaches before this phase, each card against
    CPU: the Python engine (a, b), draft_assemble (c), slagan_pairwise (d)
    (each, with `parent`, also beside the parent's in turns) and
    prolagan_fasta (e).  Returns the launches of all card runs."""
    total: dict = {}
    steps = [lambda: tools_python_engine(work, gpu, total),
             lambda: tools_check(work, gpu, total),
             lambda: tools_draft(gpu, total),
             lambda: tools_slagan(gpu, total),
             lambda: tools_prolagan(gpu, total, parent)]
    if parent:
        steps[3:3] = [lambda: tree_runs("draft", parent, gpu),
                      lambda: tree_runs("slagan", parent, gpu)]
    for step in steps:
        t0 = time.perf_counter()
        step()
        log(f"    {time.perf_counter() - t0:.1f} s")
    return {"launches": total}


# ---------------------------------------------------------------- profile --

def enumeration_steps(device, strains, k: int, min_branch: int | None,
                      rows: dict[str, list[float]]) -> int:
    """One port enumeration (the steps of
    sibelia_tpu_torch/index/enumeration.py) with a synchronise on each side
    of every step; appends each step's wall ms to rows and returns the row
    count.  The candidate scan runs for k <= 32 with min_branch, as there."""
    import torch
    from sibelia_tpu_torch.core.convert import to_numpy, to_tensor
    from sibelia_tpu_torch.index import enumeration as port_enum
    from sibelia_tpu_torch.index.enum_device import (candidate_scan,
                                                     sorted_columns)
    from sibelia_tpu_torch.kernels.enum_scan import enum_segment_scan

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rows.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    t_all = time.perf_counter()
    codes, block_starts = step("build_supergenome (host)",
                               lambda: port_enum.build_supergenome(strains))
    n = codes.shape[0]
    codes_d = step("upload of the codes (H2D)",
                   lambda: to_tensor(codes, device))
    *cols, nv = step("keys or ranks + sort (sorted_columns)",
                     lambda: sorted_columns(codes_d, k))
    ids, poskey, n_groups, n_sel = step(
        "segment scan kernel", lambda: enum_segment_scan(*cols, nv, n))
    del cols
    pos_d, perm = step("final position sort", lambda: torch.sort(poskey))
    ns, count = int(n_sel), int(n_groups)
    id_d = ids[perm]
    fetch = [pos_d[:ns], id_d[:ns]]
    if k <= 32 and min_branch is not None:
        fetch.append(step("candidate_scan", lambda: candidate_scan(
            codes_d, pos_d[:ns], id_d[:ns], k, min_branch, ns))[:count])
    sel, sel_ids, *_ = step("download of the selected rows (D2H)",
                            lambda: [to_numpy(t) for t in fetch])
    step("_map_selected (host)", lambda: port_enum._map_selected(
        sel.astype(np.int64), sel_ids.astype(np.uint32), count,
        block_starts, len(strains)))
    rows.setdefault("whole call", []).append(
        (time.perf_counter() - t_all) * 1e3)
    return n


def profile_enumeration(device, strains, out_dir: str, reps: int = 2) -> None:
    """Per-step wall ms of the port's k = 30 enumeration, and a
    torch.profiler window over one whole call, its table written to
    out_dir/prof_enum.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sibelia_tpu_torch.index import enumeration as port_enum

    enumeration_steps(device, strains, MAIN_K, MAIN_MIN_BRANCH, {})
    rows: dict[str, list[float]] = {}
    for _ in range(reps):
        n = enumeration_steps(device, strains, MAIN_K, MAIN_MIN_BRANCH, rows)
    log(f"  rows={n} (ms, {reps} repetitions after a warm-up)")
    for name, ms in rows.items():
        log(f"  {name}: " + ", ".join(f"{t:.1f}" for t in ms))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        port_enum.enumerate_bifurcations(strains, MAIN_K, MAIN_MIN_BRANCH,
                                         device)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    # the card's own events only: an aten op's device time repeats its
    # kernels'
    total = sum(getattr(e, attr) for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    log(f"  torch.profiler: {total:.1f} ms of device time in one call")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "prof_enum.txt")
    with open(path, "w") as h:
        h.write(events.table(sort_by=attr, row_limit=40))
    log(f"  profiler table: {path}")


# ------------------------------------------------------------------- main --

def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (phases 1-3c)")
    ap.add_argument("--profile", metavar="DIR",
                    help="time the steps of the phase 4 enumeration only")
    ap.add_argument("--cards", action="store_true",
                    help="phase sharded's CLI runs over cards only (d): "
                         "needs two cards or more")
    ap.add_argument("--parent", metavar="DIR",
                    help="the port of the tree at DIR (the parent commit) "
                         "beside this one: phases order, anchors and "
                         "csibelia_exact time its band DP, walks and sweep, "
                         "phase tools its draft_assemble and sweep, "
                         "phase memory its -s loose and phase 4's "
                         "enumeration; with --memory, -s loose on "
                         f"{SLAB_STRAINS} strains")
    ap.add_argument("--memory", action="store_true",
                    help="the card's peak memory of an enumeration against "
                         "rows, up to the 2^30-row gate, only")
    ap.add_argument("--trim", action="store_true",
                    help="phase 4d only: the trim rounds' crossover")
    args = ap.parse_args()
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        from sibelia_tpu_torch.core.platform import resolve_device
        from sibelia_tpu_torch.index.enumeration import build_supergenome
        from sibelia_tpu_torch.align import anchors_device
        from sibelia_tpu_torch.kernels import (enum_scan, gotoh, nvcc,
                                               order_device)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    os.environ["SIBELIA_TPU_TORCH_DEVICE"] = "cuda"
    device = resolve_device()
    gpu = gpu_line()
    log(f"[build] torch {torch.__version__} CUDA {torch.version.cuda}; {gpu}")
    t0 = time.perf_counter()
    built = nvcc.build_all(["enum_scan", "gotoh", "order_band",
                            "anchors_sweep"])
    for module in (enum_scan, gotoh, order_device, anchors_device):
        module.build()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s, one nvcc "
        "each, in parallel: " + ", ".join(f"{nvcc.source(name)} done at "
                                          f"{t:.2f} s" for name, t in
                                          built.items()))
    for name in ("gotoh", "order_band", "anchors_sweep"):
        for line in nvcc.BUILD_LOG.get(name, "").splitlines():
            log(f"  {name}.cu: {line}")

    if args.trim:
        log(f"[trim] trim_blocks' rounds at k={MAIN_K}: numpy, native and "
            "card a round, two related copies of 1 to 2,838,317 rows")
        phase_trim(device, gpu)
        log(f"  took {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.memory:
        t0 = time.perf_counter()
        strains = make_strains(MEMORY_COUNTS[-1], MEMORY_STRAIN, SEED)
        log(f"[memory] the card's peak, {MEMORY_COUNTS} strains x "
            f"{MEMORY_STRAIN} bases (made in "
            f"{time.perf_counter() - t0:.1f} s)")
        memory_table(device, [strains[:c] for c in MEMORY_COUNTS], gpu)
        if args.parent:
            log(f"[memory] -s loose on {SLAB_STRAINS} of them, here with "
                f"its arena slab and at {args.parent}")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
                fasta = os.path.join(work, "strains.fasta")
                write_fasta(fasta, strains[:SLAB_STRAINS])
                small = os.path.join(work, "small.fasta")
                write_fasta(small, [s[:300_000] for s in strains[:2]])
                slab_runs(device, work, fasta, small, None, args.parent,
                          gpu, rounds=1)
        log(f"  took {time.perf_counter() - t_run:.1f} s")
        return 0
    t0 = time.perf_counter()
    strains = make_strains(16, 2_000_000, SEED)
    log(f"[data] 16 strains x 2 Mbp, {time.perf_counter() - t0:.2f} s")
    if args.profile:
        log("[profile] k=30 min_branch=150 enumeration, step by step")
        profile_enumeration(device, strains, args.profile)
        return 0
    if args.cards:
        if torch.cuda.device_count() < 2:
            print("chip_smoke: --cards needs two cards or more",
                  file=sys.stderr)
            return 2
        log(f"[cards] -s loose over {torch.cuda.device_count()} cards and as "
            "two NCCL processes, against one card")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            sharded_cli_runs(strains[:4], work, gpu.replace("\n", "; "))
        log(f"  took {time.perf_counter() - t_run:.1f} s")
        return 0
    codes, _ = build_supergenome(strains)
    codes_d = torch.from_numpy(codes).to(device)

    phase_done("build and data")
    log("[kernel] segment scan kernel vs plain PyTorch, bit-equal")
    scan = phase_kernel(device, codes_d)
    del codes_d
    phase_done("kernel")
    log("[gotoh] Gotoh kernel vs plain PyTorch: aligned rows and lengths "
        "equal, and all four planes of its plane-writing form bit-equal")
    dirs = phase_gotoh(device, gpu)
    phase_done("gotoh")
    log("[order] band DP, traceback and params kernels vs their plain "
        "versions, pointer bytes inside the band, moves and params equal; "
        "-mfa text vs native lagan_order")
    order = phase_order(device, gpu, args.parent)
    phase_done("order")
    log("[anchors] sweep kernels (a warp a set, a block a set) vs plain "
        "PyTorch, sofar, bk, best and best_val bit-equal; anchors text vs "
        "native lagan_anchors")
    sweep = phase_anchors(device, gpu, args.parent)
    phase_done("anchors")
    if args.kernels:
        log(f"  {gpu}; took {time.perf_counter() - t_run:.1f} s")
        return 0
    log("[enum] k=30 min_branch=150 enumeration, card vs CPU")
    phase_enumeration(device, strains)
    phase_done("enum")
    log(f"[enum_k] k in {ENUM_KS} enumeration by prefix doubling, card vs "
        "host native")
    phase_enum_k(device, strains, gpu)
    phase_done("enum_k")
    log("[sharded] sharded enumeration on 1 and 4 shards of the card, the "
        "sharded prefilter, an NCCL rank, the pair mesh; each against the "
        "single-card result")
    phase_sharded(device, strains, gpu, order)
    phase_done("sharded")
    log(f"[trim] trim_blocks' rounds at k={MAIN_K}: numpy, native and card "
        "a round, two related copies of 1 to 2,838,317 rows")
    phase_trim(device, gpu)
    phase_done("trim")
    log("[e2e] sibelia_tpu_torch.cli.sibelia -s loose -m 5000, 4 x 2 Mbp, "
        "card vs CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        e2e = phase_e2e(strains[:4], work, gpu)
        phase_done("e2e")
        log("[memory] the card's peak against rows for k in "
            f"{[k for k, _ in MEMORY_KS]}, the size rule, and -s loose with "
            "its arena slab" + (f" against {args.parent}" if args.parent
                                else ""))
        memory = phase_memory(device, strains, work,
                              os.path.join(work, "cpu"), args.parent, gpu)
    phase_done("memory")
    del strains
    log("[csibelia] sibelia_tpu_torch.cli.csibelia, fast aligner with device "
        "gap batching, 1.4 Mbp reference vs contigs, card vs CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        csib = phase_csibelia(device, work, gpu,
                              *write_csibelia_pair(work, CSIB_FAST_SIZE))
        phase_done("csibelia")
        log("[csibelia_exact] sibelia_tpu_torch.cli.csibelia, no aligner "
            "switch set (exact LAGAN: anchors sweeps, band DPs and "
            "tracebacks on the card), 2.8 Mbp reference vs contigs, card vs "
            "CPU")
        exact = phase_csibelia_exact(device, work, gpu,
                                     *write_csibelia_pair(work, CSIB_SIZE),
                                     args.parent)
        phase_done("csibelia_exact")
    log("[tools] the Python engine (SIBELIA_TPU_NATIVE=0, "
        "SIBELIA_TPU_CHECK=1), draft_assemble, slagan_pairwise and "
        "prolagan_fasta, card vs CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        tools = phase_tools(work, gpu, args.parent)["launches"]
    phase_done("tools")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"jax", "jaxlib", "sibelia_tpu"})
    if loaded:
        raise RuntimeError(f"the run imported {loaded}: the port stands alone")
    kernels = [{
        "name": "enum_segment_scan", "route": "cuda",
        "source": "sibelia_tpu_torch/kernels/csrc/enum_scan.cu",
        "replaces": "sibelia_tpu/kernels/enum_scan.py:276",
        "launches": (e2e["launches"]["enum_segment_scan"]
                     + memory["launches"]["enum_segment_scan"]
                     + tools.get("enum_segment_scan", 0)),
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None}, {
        "name": "gotoh_align", "route": "cuda",
        "source": "sibelia_tpu_torch/kernels/csrc/gotoh.cu",
        "replaces": "sibelia_tpu/kernels/gotoh_pallas.py:122",
        "launches": (csib["launches"]["gotoh_align"]
                     + tools.get("gotoh_align", 0)),
        "max_abs_err": max(dirs["max_abs_err"], csib["max_abs_err"]),
        "ms": dirs["ms"], "plain_ms": dirs["plain_ms"],
        "bound_ms": dirs["bound_ms"], "bound_by": dirs["bound_by"],
        "library_ms": None}]
    # the kernels of the exact aligner: errors over phases 3b, 3c and 7;
    # times, bounds and plain times on what the exact run gave them (the
    # band DP's plain time on the run's short pairs, its other numbers and
    # the traceback's and the params' on the run's largest batch)
    band = dict(exact["whole"], plain_ms=exact["order"]["plain_ms"],
                max_abs_err=exact["order"]["max_abs_err"])
    for name, source, replaces, alone, run in (
            ("order_band", "kernels/csrc/order_band.cu",
             "sibelia_tpu/kernels/order_device.py:171", order, band),
            ("order_moves", "kernels/csrc/order_band.cu",
             "sibelia_tpu/native/lagan_order.cpp:486", order["moves"],
             exact["whole"]["moves"]),
            ("band_params", "kernels/csrc/order_band.cu",
             "sibelia_tpu/kernels/order_device.py:142", order["params"],
             exact["whole"]["params"]),
            ("anchors_sweep", "kernels/csrc/anchors_sweep.cu",
             "sibelia_tpu/align/anchors_device.py:251", sweep,
             exact["sweep"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sibelia_tpu_torch/" + source, "replaces": replaces,
            "launches": exact["launches"][name] + tools.get(name, 0),
            "max_abs_err": max(alone["max_abs_err"], run["max_abs_err"]),
            "ms": run["ms"], "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
            "library_ms": None})
    log("  launches count wrapper calls: order_moves is three kernels at "
        "wmax <= 32 (k_walk_tables, k_walk_compose, k_walk_replay) and one "
        "above (k_order_moves_wide); order_band one at wmax <= 32 "
        "(k_order_band_warp) and two above (k_band_words, then "
        "k_order_band_reg or, at 8192, k_order_band)")
    log(f"[done] k={BIG_K} shape: segment scan kernel {scan['big_ms']:.3f} "
        f"ms, plain {scan['big_plain_ms']:.3f} ms; chip_smoke took "
        f"{time.perf_counter() - t_run:.1f} s")
    log(gpu_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
