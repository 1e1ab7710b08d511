"""The port's record of spans and counters (``core/timings.py``): unrounded
totals, the span log on the profiler's clock, one record per outermost CLI
run, the native engine's sweep record, and the benchmark's metrics that
read it."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sibelia_tpu_torch.core import timings
from tests.test_device_e2e import REPO_ROOT
from tests.test_torch_cli_e2e import write_pair_fixture


@pytest.fixture
def fresh_log(monkeypatch):
    """An empty span log and record for the test, put back after it."""
    monkeypatch.setattr(timings, "LOG", [])
    monkeypatch.setattr(timings, "LOG_DROPPED", [0])
    monkeypatch.setattr(timings, "_ACC", {})
    return timings


def test_phase_totals_are_unrounded_and_snapshot_is_the_record(fresh_log):
    t = fresh_log
    with t.phase("a"):
        time.sleep(0.003)
    t.add("a", 0.001)
    t.add("n", 2)
    t.add("n", 3)
    snap = t.snapshot()
    assert snap == t._ACC
    assert 0.004 <= snap["a"] < 1 and round(snap["a"], 2) != snap["a"]
    assert snap["n"] == 5 and isinstance(snap["n"], int)
    t.reset()
    assert t.snapshot() == {}


def test_nothing_is_logged_outside_a_profiler_session(fresh_log):
    with fresh_log.phase("outer"):
        with fresh_log.phase("inner"):
            pass
    assert fresh_log.LOG == [] and "inner" in fresh_log._ACC


def test_a_span_brackets_the_profiler_events_inside_it(fresh_log):
    """Inside a CPU profiler session a span's (start, end) hold a
    record_function event that ran inside it, on the profiler's clock,
    and its parent is the enclosing span."""
    t = fresh_log
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("outer"):
            with t.phase("inner"):
                with record_function("work_inside"):
                    torch.ones(4096).cumsum(0)
                    time.sleep(0.002)
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "work_inside")
    start = (ev.start_ns() if hasattr(ev, "start_ns")
             else ev.start_us() * 1000)
    end = start + (ev.duration_ns() if hasattr(ev, "duration_ns")
                   else ev.duration_us() * 1000)
    recs = t.log_records()
    assert [r[0] for r in recs] == ["outer", "inner"]
    (_, o_start, o_end, o_parent, run), (_, i_start, i_end, i_parent, _) = recs
    assert o_parent == -1 and i_parent == 0 and run == t.RUNS[0]
    assert o_start <= i_start <= start < end <= i_end <= o_end


def test_the_log_cap_drops_records_and_counts_them(fresh_log, monkeypatch):
    t = fresh_log
    monkeypatch.setattr(t, "LOG_CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with t.phase("top"):
            for _ in range(5):
                with t.phase("leaf"):
                    pass
    assert len(t.LOG) == 3 and t.LOG_DROPPED[0] == 3
    assert t._ACC["leaf"] > 0
    # a dropped span's children would name the nearest logged ancestor
    assert [r[3] for r in t.LOG] == [-1, 0, 0]


def test_a_run_inside_a_run_adds_to_the_outer_record(fresh_log):
    t = fresh_log
    runs = t.RUNS[0]
    with t.run_scope():
        t.add("before", 1)
        with t.run_scope():
            t.add("inside", 1)
        t.add("after", 1)
    assert t._ACC == {"before": 1, "inside": 1, "after": 1}
    assert t.RUNS[0] == runs + 1
    with t.run_scope():
        assert t._ACC == {}


COUNTS = ("gotoh_flushes", "gotoh_pairs", "order_device_jobs",
          "order_host_fallback", "order_row_bytes", "anchors_sweeps")
FAST = {"SIBELIA_TPU_ALIGNER": "fast", "SIBELIA_TPU_DEVICE_ALIGN": "1"}
DEVICE_PATH = {"SIBELIA_TPU_DEVICE_ORDER": "1",
               "SIBELIA_TPU_ANCHORS_DEVICE": "1"}


@pytest.mark.parametrize("switches", [FAST, DEVICE_PATH],
                         ids=["fast aligner", "exact aligner's device path"])
def test_csibelia_cli_keeps_one_record_a_run(tmp_path, monkeypatch, switches):
    """A C-Sibelia run's dump holds what it recorded before, inside and
    after its Sibelia stage; a second run in the same process, under a
    profiler session, dumps the same counts and writes the same files."""
    from sibelia_tpu_torch.cli import csibelia
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
    for key, value in switches.items():
        monkeypatch.setenv(key, value)
    resolve = csibelia.resolve_device

    def resolve_and_count():
        timings.add("probe_before_synteny", 1)
        return resolve()
    monkeypatch.setattr(csibelia, "resolve_device", resolve_and_count)
    ref, asm = write_pair_fixture(tmp_path)
    dumps, files = [], []
    for i in range(2):
        dump = tmp_path / f"timings{i}.json"
        monkeypatch.setenv("SIBELIA_TPU_TIMINGS", str(dump))
        out = tmp_path / f"out{i}"
        first = len(timings.LOG)
        if i:
            with profile(activities=[ProfilerActivity.CPU]):
                rc = csibelia.run([str(ref), str(asm), "-o", str(out),
                                   "--maf", "alignment.maf"])
        else:
            rc = csibelia.run([str(ref), str(asm), "-o", str(out),
                               "--maf", "alignment.maf"])
        assert rc == 0
        dumps.append(json.loads(dump.read_text()))
        files.append([(out / f).read_bytes()
                      for f in ("variant.vcf", "alignment.maf")])
        assert all(dumps[-1][k] == v for k, v in timings._ACC.items())
        spans = {r[0] for r in timings.log_records(first)}
        if i:
            assert {"synteny", "engine_sweep", "variant_calling"} <= spans
        else:
            assert not spans
    for d in dumps:
        assert d["probe_before_synteny"] == 1
        assert d["synteny"] > 0 and d["variant_calling"] > 0
        assert d["engine_sweep"] > 0 and d["sweep_bulges"] > 0
        assert d["enum_host"] > 0 and d["sync_wait"] >= 0
    assert files[0] == files[1]
    assert ({k: dumps[0][k] for k in COUNTS}
            == {k: dumps[1][k] for k in COUNTS})
    if switches is FAST:
        assert dumps[0]["gotoh_flushes"] > 0
        assert dumps[0]["order_device_jobs"] == 0
    else:
        assert dumps[0]["order_device_jobs"] > 0
        assert dumps[0]["anchors_sweeps"] >= dumps[0]["order_device_jobs"]
        assert dumps[0]["order_row_bytes"] > 0
        assert 0 < dumps[0]["chaos"] <= dumps[0]["rechaos"]
        for k in ("chaos_words", "chaos_links"):
            assert dumps[0][k] == dumps[1][k] > 0
        assert dumps[0]["gotoh_flushes"] == 0


_SWEEP = r"""
import json, sys
import numpy as np, torch
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.graph.sequence import MutableSequence
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations_host
from sibelia_tpu_torch.native import engine_runner
rng = np.random.default_rng(7)
acgt = np.frombuffer(b"ACGT", np.uint8)
size = 60000
base = acgt[rng.integers(0, 4, size)]
chroms = [base]
for _ in range(3):
    s = base.copy()
    hit = rng.integers(0, size, size // 100)
    s[hit] = acgt[rng.integers(0, 4, hit.size)]
    at = int(rng.integers(size // 4, size // 2))
    chroms.append(np.concatenate([s[:at], acgt[rng.integers(0, 4, 9)],
                                  s[at:]]))
seq = MutableSequence([c.copy() for c in chroms])
enum = enumerate_bifurcations_host(seq.chars, 11)
timings.reset()
bulges = engine_runner.simplify(seq, enum, 11, 80, 4, torch.device("cpu"))
print(json.dumps({"bulges": bulges, "record": timings._ACC,
                  "seq": [bytes(c).hex() for c in seq.chars]}))
"""


def _sweep(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SIBELIA_TPU_PROF", "SIBELIA_TPU_WAVE")}
    env.update(SIBELIA_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2",
               **env_extra)
    r = subprocess.run([sys.executable, "-c", _SWEEP], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[prof" not in r.stderr
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("wave", [None, "0"], ids=["wave", "serial"])
def test_native_sweep_record(wave):
    """The engine's sweep record on a small stage: its parts within the
    sweep's span, stale detections within the detections, its bulges the
    stage's; the per-id split under SIBELIA_TPU_PROF=2 counts every
    process_bulges call, the detection threads' included; the sequences
    are the same with and without it."""
    env = {} if wave is None else {"SIBELIA_TPU_WAVE": wave}
    plain, deep = _sweep(env), _sweep({**env, "SIBELIA_TPU_PROF": "2"})
    assert plain["seq"] == deep["seq"] and plain["bulges"] == deep["bulges"]
    for run in (plain, deep):
        r = run["record"]
        assert (r["sweep_detect"] + r["sweep_apply"] + r["reprefilter"]
                <= r["engine_sweep"])
        assert r["wave_stale"] <= r["wave_detections"]
        assert r["sweep_bulges"] == run["bulges"] > 0
        assert r["sweep_iterations"] >= 2 and r["sweep_prefilter"] == 0
    assert not any(k.startswith("sweep_prof_") for k in plain["record"])
    r = deep["record"]
    calls = (r["wave_detections"] + r["wave_resume"] + r["wave_stale"]
             + r["wave_uncached"])
    if wave == "0":
        assert r["sweep_detect"] == 0 and r["wave_detections"] == 0
        assert r["sweep_prof_ids"] > 0
    else:
        assert r["sweep_detect"] > 0 and r["wave_detections"] > 0
        assert r["sweep_prof_ids"] == calls
    assert r["sweep_prof_collapses"] == r["sweep_bulges"]


NEW_METRICS = [
    ("sweep_detect_s.sibelia", "sibelia", "sweep_detect"),
    ("sweep_apply_s.sibelia", "sibelia", "sweep_apply"),
    ("reprefilter_s.sibelia", "sibelia", "reprefilter"),
    ("wave_stale_pct.sibelia", "sibelia", None),
    ("enum_host_s.sibelia", "sibelia", "enum_host"),
    ("sync_wait_s.sibelia", "sibelia", "sync_wait"),
    ("enum_host_s.csibelia", "csibelia", "enum_host"),
    ("chaos_s.csibelia", "csibelia", "chaos"),
    ("sync_wait_s.csibelia", "csibelia", "sync_wait"),
]


@pytest.mark.parametrize("name,program,key", NEW_METRICS,
                         ids=[m[0] for m in NEW_METRICS])
def test_record_metric_files(name, program, key):
    """Each metric that reads the record: its value on two jobs, and None
    on jobs without its keys (a program that does not record them) or of
    the other program."""
    from portbench.run import Job, Run, load_metric
    read = load_metric(name)
    phases = [{"sweep_detect": 1.0, "sweep_apply": 2.0, "reprefilter": 0.5,
               "enum_host": 0.25, "sync_wait": 0.125, "chaos": 3.0,
               "wave_detections": 300, "wave_stale": 30},
              {"sweep_detect": 3.0, "sweep_apply": 4.0, "reprefilter": 1.5,
               "enum_host": 0.75, "sync_wait": 0.375, "chaos": 5.0,
               "wave_detections": 100, "wave_stale": 10}]

    def run(program, phases):
        jobs = [Job(0, 1, 0, "out", dict(p)) for p in phases]
        return Run(program, 1000, 1.0, jobs, (0, 2))
    want = (10.0 if key is None
            else (phases[0][key] + phases[1][key]) / 2)
    assert read(run(program, phases)) == pytest.approx(want)
    assert read(run(program, [{"engine_sweep": 1.0}] * 2)) is None
    other = "csibelia" if program == "sibelia" else "sibelia"
    assert read(run(other, phases)) is None


def test_sibelia_cli_files_are_the_same_traced_and_deep(tmp_path):
    """The Sibelia CLI writes the same files and standard output under
    SIBELIA_TPU_PROF=2 and under SIBELIA_TPU_PROFILE_DIR as without
    either; the profile's Chrome trace carries the run's program spans,
    each inside the trace's window."""
    from tests.test_device_e2e import _write_fixture
    from tests.test_torch_cli_e2e import _tree
    fa, stagefile = _write_fixture(tmp_path)
    prof = tmp_path / "prof"
    runs = {}
    for out, extra in (("plain", {}), ("deep", {"SIBELIA_TPU_PROF": "2"}),
                       ("profiled", {"SIBELIA_TPU_PROFILE_DIR": str(prof)})):
        env = {k: v for k, v in os.environ.items()
               if k not in ("SIBELIA_TPU_PROF", "SIBELIA_TPU_PROFILE_DIR")}
        r = subprocess.run(
            [sys.executable, "-m", "sibelia_tpu_torch.cli.sibelia", "-k",
             str(stagefile), "-m", "100", "--lastk", "15", "-o",
             str(tmp_path / out), str(fa)],
            env=dict(env, SIBELIA_TPU_TORCH_DEVICE="cpu", **extra),
            capture_output=True, text=True, timeout=420, cwd=REPO_ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "[prof" not in r.stderr
        runs[out] = (r.stdout, _tree(tmp_path / out))
    assert runs["deep"] == runs["plain"] == runs["profiled"]
    with open(prof / "sibelia.pt.trace.json") as h:
        trace = json.load(h)
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    assert {"enumeration", "engine_sweep", "sync_wait",
            "enum_host"} <= {e["name"] for e in spans}
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") != "program_span"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    assert all(lo - 1e5 <= e["ts"] <= e["ts"] + e["dur"] <= hi + 1e5
               for e in spans)
