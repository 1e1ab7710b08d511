#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: whole jobs of its Sibelia
and C-Sibelia CLIs on one card, in process, back to back.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of BENCHMARK.json's ``workloads`` and a file
``cells/<cell>.json`` that names its configuration (``configs/``: the
CLI's arguments, the guarantees, the limits of the comparison) and its
traffic (``traffic/``: the genomes the generator makes from the seed).
A run makes the genomes, runs one warm job (set-up), then runs jobs for
``--seconds`` (the window closes at the end of the first job that ends
after it), judges every job's output with the plain reference, and
prints one JSON line last: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read by the files in
``metrics/`` from the jobs' phases and counters and from a profile of the
window.  It exits non-zero without a result when there is no card, or
when ``jax``, ``jaxlib``, ``flax`` or the JAX package was imported.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import trace  # noqa: E402
from portbench.genomes import Inputs, make_inputs  # noqa: E402
from portbench.reference import judge, load_judge  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sibelia_tpu")
KERNEL_LIBS = ["enum_scan", "gotoh", "order_band", "anchors_sweep"]


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level packages among module names, compared whole
    (``sibelia_tpu_torch`` is not ``sibelia_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: str = ROOT


def load_cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """A cell by name: its BENCHMARK.json entry, its file under ``cells/``,
    its configuration and traffic files, and the metrics it reports; all
    found under `root`, a checkout's root.  The configuration's judge
    (``reference.load_judge``) must be there."""
    bench = bench or _json(root, "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, "portbench")
    cell = _json(here, "cells", f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"cells/{name}.json disagrees with BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    config = _json(root, conf["file"])
    try:
        load_judge(config, os.path.join(here, "reference"))
    except (KeyError, ValueError) as e:
        raise SystemExit(f"{conf['file']} names no judge: {e}")
    return Cell(name, entry["chips"], config,
                _json(here, "traffic", f"{entry['traffic']}.json"), e2e,
                per_layer, root)


def load_metric(name: str, root: str = ROOT):
    """The ``read(run)`` of ``portbench/metrics/<name>.py`` under `root`."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Job:
    start_ns: int
    end_ns: int
    rc: int
    out: str
    phases: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)


@dataclass
class Run:
    """What the metric files read: the window's jobs, their input size,
    set-up (monotonic clock), and in a traced run the card's events and
    the window on the profiler's clock (``time.time_ns``)."""
    program: str
    bases: int
    setup_s: float
    jobs: list[Job]
    window_ns: tuple[int, int]
    events: list | None = None
    trace_ns: tuple[int, int] | None = None

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9


def job_argv(config: dict, inputs: Inputs, out: str, tmp: str) -> list[str]:
    if config["program"] == "sibelia":
        return [*config["argv"], "-o", out, "-t", tmp, *inputs.fastas]
    if config["program"] == "csibelia":
        return [*inputs.fastas, *config["argv"], "-o", out]
    raise ValueError(f"unknown program {config['program']!r}")


@contextmanager
def stdout_to(path: str):
    """File descriptor 1 (the CLIs' progress) into `path`, so that the
    result stays the last line of standard output."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "ab") as log:
        os.dup2(log.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


def run_job(program: str, argv: list[str], log: str, sync) -> Job:
    """One whole CLI run in process; its phases (``timings``, which each
    run resets, read unrounded) and the launches it counted."""
    from sibelia_tpu_torch.core import platform, timings
    if program == "sibelia":
        from sibelia_tpu_torch.cli.sibelia import run
    else:
        from sibelia_tpu_torch.cli.csibelia import run
    before = dict(platform.LAUNCHES)
    t0 = time.monotonic_ns()
    with stdout_to(log):
        rc = run(argv)
    sync()
    t1 = time.monotonic_ns()
    launches = {k: v - before.get(k, 0) for k, v in platform.LAUNCHES.items()
                if v != before.get(k, 0)}
    return Job(t0, t1, rc, argv[argv.index("-o") + 1],
               timings.snapshot(), launches)


def tree_digest(path: str) -> str:
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode() + b"\0")
            with open(full, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def set_up(device: str) -> None:
    """Open the card, and build (first run) or load the port's four nvcc
    libraries and three g++ libraries from their directories in the
    checkout."""
    import torch
    if device == "cuda":
        from sibelia_tpu_torch.kernels import nvcc
        nvcc.build_all(KERNEL_LIBS)
        for name in KERNEL_LIBS:
            nvcc.load(name)
        torch.zeros(1, device="cuda")
    from sibelia_tpu_torch import native
    native.load()
    native.load_lagan()
    native.load_ranking()


@contextmanager
def environ(updates: dict):
    """os.environ with `updates` inside the block, as it was after."""
    saved = {k: os.environ.get(k) for k in updates}
    os.environ.update(updates)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def is_correct(checks: dict, limits: dict, jobs: int, failed: int) -> bool:
    """The run's verdict: jobs ran, none failed, and every number the
    limits hold is there and within its limit."""
    return (jobs > 0 and failed == 0 and set(limits) <= set(checks)
            and all(checks[k] <= v for k, v in limits.items()))


def bench(cell: Cell, seed: int, seconds: float, traced: bool,
          device: str = "cuda", plant=None, warm: bool = True
          ) -> tuple[dict, dict]:
    """One run of a cell: (the result line, the checks).  `plant` is a
    context manager that breaks the program under the window (the control
    and the faults); None in a benchmark run.  Without `warm` the window
    follows set-up with no warm job (readings of the comparison alone)."""
    config = cell.config
    with environ({"SIBELIA_TPU_TORCH_DEVICE": device,
                  **config.get("env", {})}):
        return _bench(cell, seed, seconds, traced, device, plant, warm)


def _bench(cell, seed, seconds, traced, device, plant, warm):
    import torch
    config, program = cell.config, cell.config["program"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    set_up(device)
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        inputs = make_inputs(cell.traffic, seed, work)
        log = os.path.join(work, "cli.log")
        if warm:
            job = run_job(program, job_argv(config, inputs,
                                            os.path.join(work, "warm"), work),
                          log, sync)
            if job.rc != 0:
                raise RuntimeError(f"the warm job exited {job.rc}; see {log}")
            shutil.rmtree(job.out)
        setup_s = time.perf_counter() - T0

        spans = trace.Spans() if traced else None
        prof = None
        if traced:
            spans.install()
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA] if cuda else
                           [ProfilerActivity.CPU])
            prof.start()
        jobs: list[Job] = []
        failed = raised = 0
        with plant() if plant else nullcontext():
            wall_open = time.time_ns()
            t_open = time.monotonic_ns()
            deadline = t_open + int(seconds * 1e9)
            while True:
                out = os.path.join(work, f"job{len(jobs)}")
                argv = job_argv(config, inputs, out, work)
                try:
                    if spans:
                        with spans.span(f"{program}_job"):
                            job = run_job(program, argv, log, sync)
                    else:
                        job = run_job(program, argv, log, sync)
                except Exception as e:  # a job that raises is a failed job
                    print(f"job {len(jobs)} raised {e!r}", file=sys.stderr)
                    failed += 1
                    raised = 1
                    break
                jobs.append(job)
                failed += job.rc != 0
                if job.end_ns >= deadline:
                    break
        t_close = jobs[-1].end_ns if jobs else time.monotonic_ns()
        wall_close = time.time_ns()
        events = None
        if traced:
            prof.stop()
            spans.restore()
            events = trace.device_events(prof) if cuda else []
        peak = torch.cuda.max_memory_reserved() if cuda else 0

        written = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(work) for f in fs)
        print(f"bytes in the run's directory at the close {written}; job "
              f"seconds {[(j.end_ns - j.start_ns) / 1e9 for j in jobs]}",
              file=sys.stderr)
        digests = [tree_digest(j.out) if j.rc == 0 else "" for j in jobs]
        checks = {"jobs_differing": sum(d != digests[0] for d in digests[1:])}
        if jobs and jobs[0].rc == 0:
            checks.update(judge(config, jobs[0].out, inputs,
                                os.path.join(cell.root, "portbench",
                                             "reference")))
        limits = config["limits"]
        correct = is_correct(checks, limits, len(jobs), failed)

        run = Run(program, inputs.bases, setup_s, jobs, (t_open, t_close),
                  events, (wall_open, wall_close))
        wanted = cell.per_layer if traced else cell.end_to_end
        metrics = {}
        for m in wanted:
            value = load_metric(m["name"], cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": correct, "attempted": len(jobs) + raised,
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": cell.chips, "memory_peak_bytes": peak}}
        if traced:
            busy = trace.union_seconds([(s, e) for _, s, e in events],
                                       wall_open, wall_close)
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = (wall_close - wall_open) / 1e9
            result["breakdown"] = trace.breakdown(events, spans.records,
                                                  wall_open, wall_close)
            seen = trace.union_seconds([(s, e) for _, s, e in events],
                                       min((s for _, s, _ in events), default=0),
                                       max((e for _, _, e in events), default=0))
            print(f"device seconds in the window {busy} of {seen} traced",
                  file=sys.stderr)
            if spans.missing:
                print("spans not found: " + ", ".join(spans.missing),
                      file=sys.stderr)
        result["checks"] = {k: {"value": checks.get(k), "limit": v}
                            for k, v in limits.items()}
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if importlib.util.find_spec("sibelia_tpu_torch") is None:
        print("the program (sibelia_tpu_torch) is not here", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    # build caches at fixed places inside the checkout (the port's own
    # nvcc and g++ libraries already live there, in its build directories)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".cache",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _ = bench(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        print("imported, and must not be: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
