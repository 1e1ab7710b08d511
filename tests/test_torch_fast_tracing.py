"""The fast aligner's spans and counters in the port's record
(``gap_batch``, ``host_gotoh``, ``multi_align``, ``gotoh_cells``,
``gotoh_bytes``), the benchmark's metric files that read them, and the
equivalence of ``csibelia_fast``'s scoring with the port's."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference.alignscore import best_score, path_score, subst_table
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.variants import aligner, scoring
from tests.test_device_e2e import REPO_ROOT

FAST = {"SIBELIA_TPU_ALIGNER": "fast", "SIBELIA_TPU_DEVICE_ALIGN": "1"}
KEYS = ("gap_batch", "host_gotoh", "multi_align", "gotoh_cells", "gotoh_bytes")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_repeat_pair(tmp_path):
    """ref.fasta: 30 kbp with 2.5 kbp of it copied once more (a block of
    three instances); asm.fasta: the 30 kbp with 150 SNPs, an 11 bp
    insertion and a 300 bp deletion, in two contigs."""
    rng = np.random.default_rng(5)
    base = ACGT[rng.integers(0, 4, 30000)]
    ref = np.concatenate([base[:20000], base[5000:7500], base[20000:]])
    asm = base.copy()
    asm[rng.integers(100, 29900, 150)] = ACGT[rng.integers(0, 4, 150)]
    asm = np.concatenate([asm[:12000], ACGT[rng.integers(0, 4, 11)],
                          asm[12000:17000], asm[17300:]])
    paths = tmp_path / "ref.fasta", tmp_path / "asm.fasta"
    paths[0].write_text(">ref_chr\n%s\n" % ref.tobytes().decode())
    paths[1].write_text(">ctg1\n%s\n>ctg2\n%s\n" % (
        asm[:14000].tobytes().decode(), asm[14000:].tobytes().decode()))
    return paths


def _run(tmp_path, switches, profiled=False):
    """One C-Sibelia run on the CPU in process, on two of torch's threads:
    its record, and the span log it added."""
    from sibelia_tpu_torch.cli import csibelia
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
        for key in FAST:
            mp.delenv(key, raising=False)
        for key, value in switches.items():
            mp.setenv(key, value)
        torch.set_num_threads(2)
        ref, asm = write_repeat_pair(tmp_path)
        first = len(timings.LOG)
        argv = [str(ref), str(asm), "-o", str(tmp_path / "out"), "--maf",
                "alignment.maf"]
        try:
            if profiled:
                with profile(activities=[ProfilerActivity.CPU]):
                    assert csibelia.run(argv) == 0
            else:
                assert csibelia.run(argv) == 0
        finally:
            torch.set_num_threads(threads)
    return dict(timings._ACC), timings.log_records(first)


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    """One fast run under a profiler session, for the tests that read it."""
    return _run(tmp_path_factory.mktemp("fast"), FAST, profiled=True)


def test_a_fast_run_records_its_spans_and_counters(fast_run):
    record, _ = fast_run
    assert all(record.get(k, 0) > 0 for k in KEYS), record
    # every gap reads and writes at least 16 bytes, and far fewer than its
    # padded buffers' 780 at T = 128
    pairs = record["gotoh_pairs"]
    assert 16 * pairs < record["gotoh_bytes"] < pairs * (6 * 128 + 12)
    assert record["gap_batch"] >= record["gotoh_device"]


def test_one_gap_batch_record_a_flush(fast_run):
    record, log = fast_run
    names = [r[0] for r in log]
    assert names.count("gap_batch") == record["gotoh_flushes"] > 0
    assert names.count("multi_align") > 0 and names.count("host_gotoh") > 0
    assert 0 < record["gotoh_cells"] <= record["gotoh_pairs"] * 128 ** 2


def test_gotoh_bytes_are_what_the_kernel_touches():
    """The tables once a launch; a gap's 8 bytes of lengths and its n + m
    bases read, its 4-byte length and its two rows up to their length
    written; the padding to T never counted."""
    from sibelia_tpu_torch.kernels.gotoh import batch_align
    rng = np.random.default_rng(7)
    pairs = [(ACGT[rng.integers(0, 4, n)].tobytes(),
              ACGT[rng.integers(0, 4, m)].tobytes())
             for n, m in [(1, 1), (5, 3), (17, 40), (128, 128), (2, 90)]]
    before = timings._ACC.get("gotoh_bytes", 0)
    rows = batch_align(pairs, 128, torch.device("cpu"))
    want = 256 + 4 * 25 + sum(12 + len(a) + len(b) + 2 * len(r0)
                              for (a, b), (r0, _) in zip(pairs, rows))
    assert timings._ACC["gotoh_bytes"] - before == want


def test_an_exact_run_records_none_of_them(tmp_path):
    record, _ = _run(tmp_path, {})
    assert record["variant_calling"] > 0
    assert not set(KEYS) & set(record)


def _job(phases):
    from portbench.run import Job
    return Job(0, 1, 0, "out", dict(phases))


def _runs(phases, events):
    from portbench.run import Run
    jobs = [_job(p) for p in phases]
    return (Run("csibelia", 1000, 1.0, jobs, (0, 2), events, (0, 2)),
            Run("csibelia", 1000, 1.0, [_job({"synteny": 1.0})] * 2, (0, 2),
                events, (0, 2)),
            Run("sibelia", 1000, 1.0, jobs, (0, 2), events, (0, 2)))


PHASES = [{"anchoring": 1.0, "gap_batch": 0.5, "host_gotoh": 0.25,
           "multi_align": 2.0, "gotoh_cells": 3_000_000,
           "gotoh_bytes": 78_000},
          {"anchoring": 3.0, "gap_batch": 1.5, "host_gotoh": 0.75,
           "multi_align": 4.0, "gotoh_cells": 1_000_000,
           "gotoh_bytes": 780_000_000}]


@pytest.mark.parametrize("name,key", [
    ("anchoring_s.csibelia", "anchoring"),
    ("gap_batch_s.csibelia", "gap_batch")])
def test_fast_phase_metric_files(name, key):
    from portbench.run import load_metric
    read = load_metric(name)
    fast, exact, other = _runs(PHASES, None)
    assert read(fast) == pytest.approx((PHASES[0][key] + PHASES[1][key]) / 2)
    assert read(exact) is None and read(other) is None
    without = _runs([{k: v for k, v in p.items() if k != key}
                     for p in PHASES], None)[0]
    assert read(without) is None


def test_gotoh_roofline_metric_file():
    from portbench.run import load_metric
    read = load_metric("gotoh_roofline_pct.csibelia")
    events = [("k_gotoh_align", 0, 400_000), ("k_gotoh_align", 10**6, 1_600_000),
              ("k_order_band_warp", 0, 10**9)]
    fast, exact, other = _runs(PHASES, events)
    # 4 M cells at 20 operations: 1.19e-6 s; 780.078 MB: 2.329e-4 s
    bound = max(780_078_000 / 3.35e12, 20 * 4_000_000 / 67e12)
    assert read(fast) == pytest.approx(100 * bound / 1e-3)
    assert read(exact) is None and read(other) is None
    assert read(_runs(PHASES, None)[0]) is None
    assert read(_runs(PHASES, events[2:])[0]) is None


def _port_score(row0: str, row1: str) -> int:
    """The rows' score by the port's own constants: the matrix for a
    column of two bases, GAP_OPEN + GAP_EXTEND x L for a run of L gaps."""
    score, run = 0, None
    for x, y in zip(row0, row1):
        kind = 1 if x == "-" else 2 if y == "-" else 0
        if kind == 0:
            score += int(scoring._SM[ord(x), ord(y)])
        elif kind != run:
            score += scoring.GAP_OPEN
        score += scoring.GAP_EXTEND if kind else 0
        run = kind or None
    return score


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fast_scoring_is_the_ports(seed):
    """Under csibelia_fast.json's scoring, path_score of the fast rows
    (and a column of A against A after them, for the last run of gaps to
    close into) is the port's own score of the rows and the best score
    of the pair."""
    with open(os.path.join(REPO_ROOT, "portbench/configs/csibelia_fast.json")) as f:
        fast = json.load(f)["scoring"]
    rng = np.random.default_rng(seed)
    a = ACGT[rng.integers(0, 4, 300)]
    b = a.copy()
    b[rng.integers(0, 300, 20)] = ACGT[rng.integers(0, 4, 20)]
    b = np.concatenate([b[:100], ACGT[rng.integers(0, 4, 7)], b[100:200],
                        b[212:]])
    row0, row1 = aligner.align_pair(a.tobytes(), b.tobytes())
    table = subst_table(fast)
    enc = [np.frombuffer(f"{r}A".encode(), dtype=np.uint8) for r in (row0, row1)]
    scored = path_score(enc[0], enc[1], table, fast["gap_start"],
                        fast["gap_cont"]) - table[65, 65]
    best = best_score(np.frombuffer(a.tobytes() + b"A", dtype=np.uint8),
                      np.frombuffer(b.tobytes() + b"A", dtype=np.uint8),
                      table, fast["gap_start"], fast["gap_cont"]) - table[65, 65]
    assert scored == _port_score(row0, row1) == best
    assert fast["gap_start"] + fast["gap_cont"] == scoring.GAP_OPEN
    assert fast["gap_cont"] == scoring.GAP_EXTEND
    acgt = np.ix_(list(b"ACGT"), list(b"ACGT"))
    assert np.array_equal(table[acgt], scoring._SM[acgt])
