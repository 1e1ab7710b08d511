#!/usr/bin/env python3
"""Readings that set the limits of a cell's comparison, on the card at the
cell's own size: the program's numbers on many seeds, and the control's
and each planted fault's (``faults.py``) on a few, in one process (one
set-up).  Each reading is a run of the harness itself (``run.bench``)
without its warm job and with a window of one job, the fault planted
under it, so that its verdict is the harness's own.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--faults none overlap_unresolved ...] [--device cuda]

Prints one JSON line per seed and fault with every number the comparison
holds and the harness's verdict, then, per fault and number, the largest
reading of the sound runs and the smallest of each fault.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import faults  # noqa: E402
from portbench import run as bench  # noqa: E402


def readings(cell, seeds, names, device: str = "cuda") -> list[dict]:
    table = faults.for_config(cell.config)
    rows = []
    for seed in seeds:
        for name in names:
            plant = None if name == "none" else table[name]
            result, checks = bench.bench(cell, seed, 0.0, False, device,
                                         plant=plant, warm=False)
            row = {"seed": seed, "fault": name,
                   "correct": result["correct"],
                   "failed": result["failed"], "numbers": checks}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def summary(rows: list[dict]) -> dict:
    """Per fault, per number: the largest reading (sound runs) or the
    smallest (a fault), over its seeds."""
    out: dict[str, dict] = {}
    for r in rows:
        pick = max if r["fault"] == "none" else min
        slot = out.setdefault(r["fault"], {})
        for k, v in r["numbers"].items():
            slot[k] = v if k not in slot else pick(slot[k], v)
        slot["correct_runs"] = slot.get("correct_runs", 0) + r["correct"]
        slot["runs"] = slot.get("runs", 0) + 1
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=["none"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = bench.load_cell(args.workload)
    rows = readings(cell, args.seeds, args.faults, args.device)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
