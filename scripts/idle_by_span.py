#!/usr/bin/env python3
"""Where the card waits, by program span.

    python3 scripts/idle_by_span.py <cell> --seed N --seconds S [--out FILE]

Runs one cell of the port's benchmark (``portbench/``) on the card twice in
one process, untraced and then traced, and prints (and writes to FILE as
JSON): both runs' job seconds, result lines and record (``core/timings``)
a job, the span log's records a job, and the card-idle seconds of a job
put down to the innermost program span open at the time, from the log
against the profiler's device events over the traced run's jobs; idle
time inside a job with no program span open is ``(none)``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def idle_by_span(records, events, windows) -> dict[str, float]:
    """Seconds of card idle time inside `windows` ((start, end) ns), each
    stretch put down to the innermost span of `records` ((name, start, end,
    ...) ns) open over it: the open span that started last."""
    from portbench.trace import idle_gaps
    busy = [(s, e) for _, s, e in events]
    gaps = sorted(g for lo, hi in windows for g in idle_gaps(busy, lo, hi))
    marks = sorted([(r[1], 1, i) for i, r in enumerate(records)]
                   + [(r[2], 0, i) for i, r in enumerate(records)])
    out: dict[str, float] = {}
    stack: list[int] = []
    m = 0
    for a, b in gaps:
        t = a
        while t < b:
            # open and close every span up to t (ends first at a tie)
            while m < len(marks) and marks[m][0] <= t:
                _, is_start, i = marks[m]
                if is_start:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                m += 1
            nxt = min(b, marks[m][0]) if m < len(marks) else b
            name = records[stack[-1]][0] if stack else "(none)"
            out[name] = out.get(name, 0.0) + (nxt - t) / 1e9
            t = nxt
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cell")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from portbench import run as bench_run
    from portbench import trace
    from sibelia_tpu_torch.core import timings

    jobs, events, spans = [], [], []
    run_job, device_events, Spans = (bench_run.run_job, trace.device_events,
                                     trace.Spans)

    def kept_job(*a, **k):
        job = run_job(*a, **k)
        jobs.append(job)
        return job

    def kept_events(prof):
        events[:] = device_events(prof)
        return events

    def kept_spans(*a, **k):
        spans.append(Spans(*a, **k))
        return spans[-1]
    bench_run.run_job, trace.device_events, trace.Spans = (
        kept_job, kept_events, kept_spans)

    cell = bench_run.load_cell(args.cell)
    report = {"cell": args.cell, "seed": args.seed}
    for traced in (False, True):
        del jobs[:]
        first = len(timings.LOG)
        result, _ = bench_run.bench(cell, args.seed, args.seconds, traced)
        window = jobs[1:]  # the warm job is the first
        key = "traced" if traced else "untraced"
        keys = sorted({k for j in window for k in j.phases})
        report[key] = {
            "result": result,
            "record_a_job": {k: sum(j.phases.get(k, 0) for j in window)
                             / len(window) for k in keys},
            "job_s": [(j.end_ns - j.start_ns) / 1e9 for j in window],
            "job_median_s": statistics.median(
                (j.end_ns - j.start_ns) / 1e9 for j in window)}
    records = timings.log_records(first)
    job_spans = [(s, e) for s, e, name in spans[-1].records
                 if name.endswith("_job")]
    n = len(job_spans)
    idle = idle_by_span(records, events, job_spans)
    report["traced"].update({
        "log_records_a_job": len(records) / n,
        "log_dropped": timings.LOG_DROPPED[0],
        "profiler_flag_seen": bool(records),
        "job_s_in_spans": sum(e - s for s, e in job_spans) / 1e9 / n,
        "idle_s_a_job": {k: v / n for k, v in
                         sorted(idle.items(), key=lambda kv: -kv[1])}})
    text = json.dumps(report, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
