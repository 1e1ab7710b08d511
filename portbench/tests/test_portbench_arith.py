"""The arithmetic of the metrics on synthetic jobs and intervals."""
import pytest

from portbench import readers, trace
from portbench.run import Job, Run


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)]
    assert trace.union_seconds(iv, 0, 100) == pytest.approx(40e-9)
    assert trace.union_seconds(iv, 10, 35) == pytest.approx(15e-9)
    assert trace.union_seconds([], 0, 100) == 0


def test_gaps_and_their_labels():
    iv = [(10, 20), (15, 30), (50, 60)]
    assert trace.idle_gaps(iv, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    spans = [(0, 100, "job"), (25, 55, "engine_sweep"), (40, 45, "inner")]
    assert trace.label_at(spans, 40) == "inner"
    assert trace.label_at(spans, 30) == "engine_sweep"
    assert trace.label_at(spans, 200) == "harness"
    b = trace.breakdown([("k_a", 10, 20), ("k_b", 15, 30), ("k_a", 50, 60)],
                        spans, 0, 100)
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-9)]
    assert [g[0] for g in b["idle_gaps"]] == ["job", "inner", "job"]
    assert b["idle_gaps"][0][1] == pytest.approx(40e-9)


def _run(program="sibelia"):
    jobs = [Job(0, 2_000_000_000, 0, "a", {"engine_sweep": 1.0, "block_trim": 0.25},
                {"enum_segment_scan": 5}),
            Job(2_000_000_000, 5_000_000_000, 0, "b", {"engine_sweep": 2.0},
                {"enum_segment_scan": 7, "anchors_sweep": 2})]
    events = [("k_flags", 1_000_000_000, 1_001_000_000),
              ("k_flags", 1_000_500_000, 1_002_000_000),
              ("at::sort", 3_000_000_000, 3_500_000_000)]
    return Run(program, 3_000_000, 9.5, jobs, (0, 5_000_000_000), events,
               (0, 5_000_000_000))


def test_rate_phases_launches_kernels_idle():
    run = _run()
    assert readers.rate_mbp_s(run, "sibelia") == pytest.approx(6.0 / 5.0)
    assert readers.rate_mbp_s(run, "csibelia") is None
    assert readers.phase_per_job(run, "engine_sweep", "sibelia") == pytest.approx(1.5)
    assert readers.phase_per_job(run, "block_trim", "sibelia") == pytest.approx(0.125)
    assert readers.phase_per_job(run, "rechaos", "sibelia") is None
    assert readers.launches_per_job(run, "sibelia") == pytest.approx(7.0)
    assert readers.kernel_ms_per_job(run, "sibelia") == pytest.approx(2.5 / 2)
    assert readers.card_idle_pct(run, "sibelia") == pytest.approx(
        100 * (1 - 0.502 / 5))
    untraced = _run()
    untraced.events = None
    assert readers.card_idle_pct(untraced, "sibelia") is None
    assert readers.kernel_ms_per_job(untraced, "sibelia") is None
