#!/usr/bin/env python3
"""Drive the PyTorch port (sibelia_tpu_torch) on one CUDA card and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # the smoke run below
    python3 chip_smoke.py --kernels        # phases 1-3c only: build and check
    python3 chip_smoke.py --profile DIR    # step breakdown of phase 4 only

It imports the port alone: the run fails if ``jax``, ``jaxlib`` or the JAX
package ``sibelia_tpu`` was imported by the end.  The port builds its CUDA
kernels (nvcc) and its native C++ host libraries (g++) from its own sources.

Phases, each of which fails the run:
  1. build    torch/CUDA versions, the card's name and power limit, and the
              four kernels built from kernels/csrc/*.cu, one nvcc each,
              started together;
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
              16-byte boundary; kernel and plain times beside each other,
              and the kernel's bound (24 B/row at 3.35 TB/s);
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
  3b. order   the order stage's band DP kernel against its plain PyTorch
              version, pointer bytes inside the band bit-equal, at wmax in
              {16, 32, 64, 1024, 8192 (several lanes a thread)}, nd from 2
              up, necks, '.' and N codes, and a ragged batch of all of them
              in one call; the -mfa text of ``order_mfa_device_batch`` on
              the card equal to native ``lagan_order`` on every pair and on
              a 200 kbp pair, whose kernel time is printed (no plain run:
              it costs a Python step a diagonal); kernel and plain times,
              bounds and bytes of pointer rows of every case;
  3c. anchors the anchors stage's sweep kernel against its plain PyTorch
              version, sofar, bk, best and best_val bit-equal, at n in {1,
              2, 60, 1000, one above the shared-memory limit}, tie-heavy
              sets, a list of sets in one launch; ``anchors_text_device`` on
              the card equal to native ``lagan_anchors`` on real chaos
              hits; times of the kernel, the plain version and the native
              sweep on the same set, and the bound;
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
  5. e2e      ``sibelia_tpu_torch.cli.sibelia -s loose -m 5000`` on 4 strains
              x 2 Mbp on the card against the same CLI on the CPU
              (``SIBELIA_TPU_TORCH_DEVICE=cpu``): every output file
              byte-identical, with the re-prefilter call count of the
              card's run above 0 and at least 5 segment scan launches (the
              four stages and the final block generation);
  6. csibelia ``sibelia_tpu_torch.cli.csibelia ref.fasta asm.fasta --maf``
              with the fast aligner and device gap batching
              (``SIBELIA_TPU_ALIGNER=fast SIBELIA_TPU_DEVICE_ALIGN=1``) and
              the CLI's defaults (-s fine -m 500 -i 4) on a 1.4 Mbp
              reference strain against a second strain of the same base cut
              into contigs of 20-200 kbp (half the size of C-Sibelia's S.
              aureus example; phase 7 runs the whole size): on the card and
              on the CPU, variant.vcf and
              alignment.maf byte-identical, both kernels launched on the
              card, the segment scan at least 7 times (three stages, their
              three block generations and the final one); the histogram of
              the run's gap lengths; then the Gotoh kernel against its plain
              versions on the run's largest gap batch, rows and planes;
  7. csibelia_exact  the same CLI on a 2.8 Mbp pair made the same way (the
              size of C-Sibelia's S. aureus example) with NO aligner switch
              set: the default, exact LAGAN mode, which on the card means
              the anchors sweep and every band DP there.  On the card and
              with ``SIBELIA_TPU_TORCH_DEVICE=cpu`` (the native stages):
              variant.vcf and alignment.maf byte-identical, both new
              kernels launched, ``order_device_jobs`` above 0; the run's
              (nd, wmax) and hits-a-sweep histograms, the phase seconds of
              both runs, the bytes of pointer rows; then both kernels
              again on what the run gave them: the band DP on its largest
              batch (timed) and, against the plain version, on that
              batch's pairs of at most 6,000 diagonals; the sweep on the
              run's largest hit set against the plain version, with the
              native sweep's time beside it.

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
# Peaks of one H100 SXM (NVIDIA's data sheet): device memory rate, and the
# float32 rate outside the tensor cores.  The data sheet lists no int32
# rate; the card's is lower, so a bound reckoned with this one still holds.
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12
ENUM_KS = (100, 5000)  # the first and last of the loose preset's k > 32
BIG_K = ENUM_KS[-1]


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


def timed(fn, device, reps: int) -> tuple[float, object]:
    """Mean milliseconds of fn() over reps runs after one warm-up, with
    CUDA events on a card (host clock on the CPU), and the last result."""
    import torch
    out = fn()
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
            "bound_by": bound_by}


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


def related_pair(rng, n: int, middle: int = 0) -> tuple[bytes, bytes]:
    """Two sequences of about n bases, 1 % of them substituted, an indel of
    1-30 bases about every 5,000; with `middle`, an unrelated stretch of
    that length in the middle of both (a wide square between anchors)."""
    a = ACGT[rng.integers(0, 4, n)]
    b = a.copy()
    hit = rng.integers(0, n, n // 100)
    b[hit] = ACGT[rng.integers(0, 4, hit.size)]
    for at in sorted(rng.integers(0, n, n // 5000).tolist(), reverse=True):
        b = np.delete(b, slice(at, at + int(rng.integers(1, 31))))
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
    """The jobs' bands on the card: ([codes, params, init], table)."""
    import torch
    from sibelia_tpu_torch.kernels import order_device
    from sibelia_tpu_torch.native import load_lagan
    lib = load_lagan()
    prepared = [order_device._prepare_job(lib, j[0], j[2], j[4], 8192)
                for j in jobs]
    for job in prepared:
        lib.le_order_release(job.handle)
    codes, params, init, table = order_device.pack_jobs(prepared)
    return [torch.from_numpy(a).to(device) for a in (codes, params, init)], \
        table


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


def compare_order(name: str, args, table, device, gpu: str, reps: int = 3,
                  plain: bool = True) -> dict:
    """The band DP kernel on one packed batch: its time, its bound and,
    with `plain`, the plain version's time and the largest difference of a
    pointer byte inside the band; raises unless that is 0."""
    import torch
    from sibelia_tpu_torch.kernels import order_device as od
    ms, got = timed(lambda: od.band_rows(*args, table), device, reps)
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
    log(f"  {name}: {table.shape[0]} pairs, wmax "
        f"{sorted(set(table[:, od.T_WMAX].tolist()))}, diagonals "
        f"{int(table[:, od.T_DIAGS].min())}-{int(table[:, od.T_DIAGS].max())}"
        f", {lanes} lanes inside the band, {rows} B of pointer rows: kernel "
        f"{ms:.3f} ms, bound {bound:.4f} ms by {bound_by}{text} ({gpu})")
    if out["max_abs_err"]:
        raise RuntimeError(f"band DP kernel disagrees with plain: {name}")
    return out


def phase_order(device, gpu: str) -> dict:
    from sibelia_tpu_torch.kernels import order_device as od
    from sibelia_tpu_torch.native import lagan_order
    rng = np.random.default_rng(SEED)
    with_codes = list(related_pair(rng, 3000))
    with_codes[0] = (with_codes[0][:400] + b"N" * 30 + with_codes[0][430:900]
                     + b"." + with_codes[0][900:])
    cases = [
        ("nd = 2, 3, 9 (wmax 16)", [(b"", b"A", ""), (b"A", b"A", ""),
                                    (b"ACGT", b"ACGT", "")], 16),
        ("3 kbp pairs, one with N and '.'",
         [related_pair(rng, 3000), tuple(with_codes)], 32),
        ("a square of 12", [related_pair(rng, 2000, 12)], 64),
        ("a square of 600", [related_pair(rng, 2000, 600)], 1024),
        ("a square of 5000", [related_pair(rng, 2000, 5000)], 8192)]
    err = 0
    every = []
    for name, pairs, wmax in cases:
        jobs = order_jobs(pairs)
        every += jobs
        args, table = pack_order_jobs(jobs, device)
        if int(table[:, od.T_WMAX].max()) != wmax:
            raise RuntimeError(f"{name}: wmax {table[:, od.T_WMAX]}")
        err = max(err, compare_order(name, args, table, device, gpu,
                                     1)["max_abs_err"])
    args, table = pack_order_jobs(every, device)
    err = max(err, compare_order("all of them in one call", args, table,
                                 device, gpu, 1)["max_abs_err"])
    necks = int((args[1][:, 6] == 1).sum())
    if necks < 10:
        raise RuntimeError(f"only {necks} neck diagonals in the cases")
    long = order_jobs([related_pair(rng, 200_000)])
    args, table = pack_order_jobs(long, device)
    compare_order("a 200 kbp pair (no plain run: 400,000 Python steps)",
                  args, table, device, gpu, plain=False)
    jobs = every + long
    got = od.order_mfa_device_batch(jobs, device)
    for job, text in zip(jobs, got):
        if text is None or text != lagan_order(*job):
            raise RuntimeError("-mfa text of the card's band DP differs from "
                               f"native lagan_order: {len(job[0])} bases")
    log(f"  -mfa text of {len(jobs)} pairs through order_mfa_device_batch on "
        f"the card equals native lagan_order; {necks} neck diagonals in the "
        "small cases")
    return {"max_abs_err": err}


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
    """2n events of n lanes, about 6 operations a lane (two compares of
    the key, the alive test, three of the running maximum); read: a_s,
    a_e, score and the two event columns, 28 B a hit; written: sofar and
    bk, 8 B a hit."""
    n = np.diff(offsets).astype(np.float64)
    return bound_ms(36 * float(n.sum()) + 8 * len(n),
                    float((2 * n * n * 6).sum()))


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
        f"ms, bound {bound:.5f} ms by {bound_by}, max |diff| {err:g} ({gpu})")
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


def phase_anchors(device, gpu: str) -> dict:
    from sibelia_tpu_torch.align.anchors_device import SHARED_HITS
    from sibelia_tpu_torch.native import lagan_chaos
    rng = np.random.default_rng(SEED)
    err = 0.0
    sets = []
    for n, tie in ((1, False), (2, False), (2, True), (60, False),
                   (60, True), (1000, True)):
        s = hit_set(rng, n, tie)
        sets.append(s)
        err = max(err, compare_sweep(
            f"n = {n}{', tie-heavy' if tie else ''}", *pack_hit_sets(
                [s], device), device, gpu, 1)["max_abs_err"])
    err = max(err, compare_sweep("a list of sets in one launch",
                                 *pack_hit_sets(sets, device), device, gpu,
                                 1)["max_abs_err"])
    ref = compare_sweep("n = 1000", *pack_hit_sets(
        [hit_set(rng, 1000)], device), device, gpu)
    big = compare_sweep(
        f"n = {SHARED_HITS + 1} (in device memory)",
        *pack_hit_sets([hit_set(rng, SHARED_HITS + 1)], device), device, gpu,
        1)
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


# ---------------------------------------------------------------- phase 5 --

def read_tree(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as h:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = h.read()
    return out


def run_cli(device_name: str, fasta: str, outdir: str, tpath: str) -> float:
    """The port CLI, in process, on one device; its wall seconds."""
    from sibelia_tpu_torch.cli.sibelia import run
    os.environ["SIBELIA_TPU_TORCH_DEVICE"] = device_name
    os.environ["SIBELIA_TPU_TIMINGS"] = tpath
    t0 = time.perf_counter()
    rc = run(["-s", "loose", "-m", "5000", "-o", outdir, fasta])
    seconds = time.perf_counter() - t0
    del os.environ["SIBELIA_TPU_TIMINGS"]
    os.environ["SIBELIA_TPU_TORCH_DEVICE"] = "cuda"
    if rc != 0:
        raise RuntimeError(f"port CLI on {device_name} exited {rc}")
    return seconds


def phase_e2e(strains, work: str) -> dict:
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
    got, want = read_tree(os.path.join(work, "card")), \
        read_tree(os.path.join(work, "cpu"))
    if sorted(got) != sorted(want) or "blocks_coords.txt" not in want:
        raise RuntimeError(f"output files differ: {sorted(got)} vs "
                           f"{sorted(want)}")
    for name in want:
        if got[name] != want[name]:
            raise RuntimeError(f"output file differs: {name}")
    reprefilter = phases.get("reprefilter_calls", 0)
    log(f"  {len(want)} output files identical; card {t_card:.3f} s, CPU "
        f"plain {t_cpu:.3f} s; launches {launches}; re-prefilter calls "
        f"{reprefilter:g}")
    log("  card run phases (s): " + json.dumps(phases, sort_keys=True))
    if launches.get("enum_segment_scan", 0) < 5 or reprefilter <= 0:
        raise RuntimeError("the main path did not go through the card: "
                           "fewer than 5 segment scan launches (4 stages "
                           "and the final block generation)")
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
        log("  CPU run phases (s): " + json.dumps(json.load(h),
                                                  sort_keys=True))
    log_gap_sizes(np.array(sizes, dtype=np.int64).reshape(-1, 2))
    log(f"  batch_align on the card (pack, upload, kernel, download, "
        f"decode): {sum(flush_s):.4f} s in {len(flush_s)} calls, the first "
        f"{flush_s[0]:.4f} s, the longest of the rest "
        f"{max(flush_s[1:], default=0.0):.4f} s")
    if (launches.get("gotoh_align", 0) <= 0
            or launches.get("enum_segment_scan", 0) < 7 or records <= 0):
        raise RuntimeError("the C-Sibelia run did not go through the card: "
                           "no Gotoh launch or fewer than 7 segment scan "
                           "launches (3 stages, 3 stage block generations "
                           "and the final one)")
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
                         asm: str) -> dict:
    """The default mode of C-Sibelia on the card against the same CLI on
    the CPU (native anchors and order stages); then both of the exact
    aligner's kernels again on what the run gave them."""
    import torch
    from sibelia_tpu_torch.align import anchors_device as ad
    from sibelia_tpu_torch.core.platform import LAUNCHES, reset_counts
    from sibelia_tpu_torch.kernels import order_device as od
    from sibelia_tpu_torch.native import lagan_anchors
    batches: list = []   # (args, table) of every band_rows call
    largest: dict = {}   # the sweep and the anchors text with the most hits
    sweep_s: list[float] = []
    band_rows, sweep_packed = od.band_rows, ad.sweep_packed
    anchors_text_device = ad.anchors_text_device

    def recording_band_rows(*args):
        batches.append((list(args[:3]), args[3]))
        return band_rows(*args)

    def recording_sweep(*args):
        if args[0].shape[0] > largest.get("n", 0):
            largest.update(n=args[0].shape[0], sweep=args)
        t0 = time.perf_counter()
        out = sweep_packed(*args)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        return out

    def recording_text(hits_text, gfc, dev):
        if len(hits_text) > len(largest.get("text", "")):
            largest.update(text=hits_text, gfc=gfc)
        return anchors_text_device(hits_text, gfc, dev)

    od.band_rows, ad.sweep_packed = recording_band_rows, recording_sweep
    ad.anchors_text_device = recording_text
    hits_before = len(ad.HITS_PER_SWEEP)
    tpath = os.path.join(work, "exact_timings.json")
    reset_counts()
    try:
        t_card = run_csibelia("cuda", ref, asm,
                              os.path.join(work, "exact_card"), tpath, {})
    finally:
        od.band_rows, ad.sweep_packed = band_rows, sweep_packed
        ad.anchors_text_device = anchors_text_device
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
        log("  CPU run phases (s): " + json.dumps(json.load(h),
                                                  sort_keys=True))
    tables = np.concatenate([t for _, t in batches])
    log(f"  band DPs: {phases['order_device_jobs']} on the card in "
        f"{len(batches)} batches, {phases['order_host_fallback']} kept by "
        f"the native engine (order_host_fallback); "
        f"{phases['order_row_bytes']} B of pointer rows came back")
    log_classes("diagonals a pair", tables[:, od.T_DIAGS],
                [0, 1000, 4000, 16_000, 64_000, 256_000, 1_024_000])
    log("  wmax: " + ", ".join(
        f"{w}: {int((tables[:, od.T_WMAX] == w).sum())}"
        for w in np.unique(tables[:, od.T_WMAX]).tolist()))
    log(f"  sweeps: {len(hits)}, {sum(sweep_s):.3f} s in sweep_packed (the "
        f"launch and a synchronise; the longest {max(sweep_s):.4f} s)")
    log_classes("hits a sweep", hits,
                [0, 1, 4, 16, 64, 256, 1024, 4096, 16_384, 1 << 20])
    if (launches.get("order_band", 0) <= 0
            or launches.get("anchors_sweep", 0) <= 0
            or phases["order_device_jobs"] <= 0 or records <= 0):
        raise RuntimeError("the exact run did not go through the card: no "
                           "band DP or no sweep launch")

    # the band DP on the run's largest batch, and against the plain version
    # on that batch's pairs of up to ORDER_PLAIN_DIAGS diagonals
    args, table = max(batches, key=lambda b: od.rows_bytes(b[1]))
    whole = compare_order("the run's largest batch", args, table, device,
                          gpu, plain=False)
    keep = np.flatnonzero((table[:, od.T_DIAGS] <= ORDER_PLAIN_DIAGS)
                          & (table[:, od.T_WMAX] <= 256))[:48]
    if keep.size == 0:  # then the pair with the fewest diagonals
        keep = np.array([int(table[:, od.T_DIAGS].argmin())])
    order = compare_order(
        f"its pairs of at most {ORDER_PLAIN_DIAGS} diagonals",
        args, od.sub_table(table, keep), device, gpu)
    order["batch_ms"] = whole["ms"]
    sweep = compare_sweep("the run's largest hit set", largest["sweep"][:5],
                          largest["sweep"][5], device, gpu)
    native_ms, _ = timed_host(lambda: lagan_anchors(largest["text"],
                                                    gfc=largest["gfc"]))
    stage_ms, _ = timed_host(lambda: anchors_text_device(
        largest["text"], largest["gfc"], device))
    log(f"  the anchors stage on that set's text ({largest['n']} hits): on "
        f"the card {stage_ms:.2f} ms (Python parsers, upload, kernel, "
        f"download), native lagan_anchors {native_ms:.2f} ms ({gpu})")
    return {"launches": launches, "card_s": t_card, "cpu_s": t_cpu,
            "order": order, "sweep": sweep}


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
                    help="build and check the four kernels only (phases "
                    "1-3c)")
    ap.add_argument("--profile", metavar="DIR",
                    help="time the steps of the phase 4 enumeration only")
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

    t0 = time.perf_counter()
    strains = make_strains(16, 2_000_000, SEED)
    log(f"[data] 16 strains x 2 Mbp, {time.perf_counter() - t0:.2f} s")
    if args.profile:
        log("[profile] k=30 min_branch=150 enumeration, step by step")
        profile_enumeration(device, strains, args.profile)
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
    log("[order] band DP kernel vs plain PyTorch, pointer bytes inside the "
        "band bit-equal; -mfa text vs native lagan_order")
    order = phase_order(device, gpu)
    phase_done("order")
    log("[anchors] sweep kernel vs plain PyTorch, sofar, bk, best and "
        "best_val bit-equal; anchors text vs native lagan_anchors")
    sweep = phase_anchors(device, gpu)
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
    log("[e2e] sibelia_tpu_torch.cli.sibelia -s loose -m 5000, 4 x 2 Mbp, "
        "card vs CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        e2e = phase_e2e(strains[:4], work)
    phase_done("e2e")
    del strains
    log("[csibelia] sibelia_tpu_torch.cli.csibelia, fast aligner with device "
        "gap batching, 1.4 Mbp reference vs contigs, card vs CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        csib = phase_csibelia(device, work, gpu,
                              *write_csibelia_pair(work, CSIB_FAST_SIZE))
        phase_done("csibelia")
        log("[csibelia_exact] sibelia_tpu_torch.cli.csibelia, no aligner "
            "switch set (exact LAGAN: anchors sweeps and band DPs on the "
            "card), 2.8 Mbp reference vs contigs, card vs CPU")
        exact = phase_csibelia_exact(device, work, gpu,
                                     *write_csibelia_pair(work, CSIB_SIZE))
        phase_done("csibelia_exact")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"jax", "jaxlib", "sibelia_tpu"})
    if loaded:
        raise RuntimeError(f"the run imported {loaded}: the port stands alone")
    kernels = [{
        "name": "enum_segment_scan", "route": "cuda",
        "source": "sibelia_tpu_torch/kernels/csrc/enum_scan.cu",
        "replaces": "sibelia_tpu/kernels/enum_scan.py:276",
        "launches": e2e["launches"]["enum_segment_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None}, {
        "name": "gotoh_align", "route": "cuda",
        "source": "sibelia_tpu_torch/kernels/csrc/gotoh.cu",
        "replaces": "sibelia_tpu/kernels/gotoh_pallas.py:122",
        "launches": csib["launches"]["gotoh_align"],
        "max_abs_err": max(dirs["max_abs_err"], csib["max_abs_err"]),
        "ms": dirs["ms"], "plain_ms": dirs["plain_ms"],
        "bound_ms": dirs["bound_ms"], "bound_by": dirs["bound_by"],
        "library_ms": None}]
    # the two kernels of the exact aligner: times, bounds and plain times
    # on what the exact run gave them; errors over phases 3b, 3c and 7
    for name, source, replaces, alone, run in (
            ("order_band", "kernels/csrc/order_band.cu",
             "sibelia_tpu/kernels/order_device.py:171", order,
             exact["order"]),
            ("anchors_sweep", "kernels/csrc/anchors_sweep.cu",
             "sibelia_tpu/align/anchors_device.py:251", sweep,
             exact["sweep"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sibelia_tpu_torch/" + source, "replaces": replaces,
            "launches": exact["launches"][name],
            "max_abs_err": max(alone["max_abs_err"], run["max_abs_err"]),
            "ms": run["ms"], "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
            "library_ms": None})
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
