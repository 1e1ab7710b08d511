#!/usr/bin/env python3
"""Hold the fast aligner's rows to its plain reference at a cell's size.

    python3 scripts/fast_maf_check.py --seed N [--workload CELL]
        [--seconds S] [--device cuda|cpu] [--out FILE]

Runs one cell of the port's benchmark (default
``csibelia_fast.saureus_half_pair``) through ``portbench/run.py``'s own
``bench`` (set-up, the warm job, the window), keeps the output of the
window's first job, and compares the ``alignment.maf`` rows of every
unique pair of its final blocks with the rows that
``portbench/reference/anchored.py`` gives for the same two instance
sequences, taken from the benchmark's genomes.  Prints (and writes to
FILE) the count of pairs, of pairs whose rows differ, the first
differences, and the harness's own verdict.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as bench  # noqa: E402
from portbench.reference.anchored import anchored  # noqa: E402
from portbench.reference.blocks import parse_coords  # noqa: E402
from portbench.reference.variants import (_forward, parse_maf,  # noqa: E402
                                          revcomp, stage_files)


@contextmanager
def keep_first_job(into: str):
    """The window's first job's output directory copied to `into`."""
    original = bench.run_job

    def wrapped(*a, **k):
        job = original(*a, **k)
        if not os.path.exists(into):
            shutil.copytree(job.out, into)
        return job
    bench.run_job = wrapped
    try:
        yield
    finally:
        bench.run_job = original


def unique_pairs(out: str, inputs, min_size: int):
    """(reference row, assembly row, reference bases, assembly bases) of
    every unique pair of the final blocks, as the judge picks them."""
    table, blocks = parse_coords(stage_files(out)[-1])
    name = {sid: desc for sid, _, desc in table}
    text = {n: s.seq.tobytes().decode() for n, s in zip(inputs.names, inputs.seqs)}
    groups = {}
    for g in parse_maf(os.path.join(out, "alignment.maf")):
        groups[frozenset((r[0],) + _forward(r)[1:] + (r[3],) for r in g)] = g
    ref = inputs.names[0]
    for b in blocks:
        inst = [(name[sid], strand, start, end) for sid, strand, start, end, _ in b]
        refs = [x for x in inst if x[0] == ref]
        asms = [x for x in inst if x[0] != ref]
        if not (len(inst) == 2 and len(refs) == 1 and len(asms) == 1
                and min(abs(x[3] - x[2]) + 1 for x in inst) >= min_size):
            continue
        key = frozenset((c, min(s, e) - 1, max(s, e), st) for c, st, s, e in inst)
        rows = {r[0]: r[5] for r in groups[key]}
        bases = []
        for c, st, s, e in (refs[0], asms[0]):
            seq = text[c][min(s, e) - 1:max(s, e)]
            bases.append(seq if st == "+" else revcomp(seq))
        yield rows[ref], rows[asms[0][0]], bases[0], bases[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="csibelia_fast.saureus_half_pair")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args()
    cell = bench.load_cell(args.workload)
    keep = tempfile.mkdtemp(prefix="fast-maf-check-")
    first = os.path.join(keep, "job")
    try:
        result, checks = bench.bench(cell, args.seed, args.seconds, False,
                                     args.device,
                                     plant=lambda: keep_first_job(first))
        from portbench.genomes import make_inputs
        inputs = make_inputs(cell.traffic, args.seed, keep)
        t0 = time.perf_counter()
        pairs, differ, columns, examples = 0, 0, 0, []
        for r0, r1, a, b in unique_pairs(first, inputs,
                                         cell.config["min_block_size"]):
            want = anchored(a.encode(), b.encode())
            pairs += 1
            columns += len(r0)
            if (r0, r1) != want:
                differ += 1
                at = next((i for i, (x, y) in enumerate(zip(r0 + r1, want[0] + want[1]))
                           if x != y), None)
                examples.append({"length": [len(a), len(b)], "first_diff": at})
        report = {"workload": args.workload, "seed": args.seed,
                  "device": result["device"]["kind"],
                  "correct": result["correct"], "checks": checks,
                  "unique_pairs": pairs, "pairs_differing": differ,
                  "columns": columns, "examples": examples[:5],
                  "reference_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if differ == 0 and pairs > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
