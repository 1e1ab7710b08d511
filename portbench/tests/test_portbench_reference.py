"""The reference agrees with the port's CPU path on small inputs, every
fault planted under the timed path turns ``correct`` false, and on a card
a cell's own run is correct."""
import os

import pytest

from portbench import control, faults, run
from portbench.run import load_cell

SMALL = {
    "sibelia_loose": {"genomes": "strains", "strains": 2, "length": 210_000,
                      "layout_seed": 4},
    "csibelia_default": {"genomes": "pair", "length": 250_000,
                         "contig_min": 20_000, "contig_max": 80_000},
}
CELLS = {"sibelia_loose": "sibelia_loose.hpylori2",
         "csibelia_default": "csibelia_default.saureus_half_pair"}


def small_cell(config):
    cell = load_cell(CELLS[config])
    cell.traffic = SMALL[config]
    return cell


@pytest.mark.parametrize("config", sorted(SMALL))
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_agrees_with_the_cpu_path(config, seed):
    before = dict(os.environ)
    result, checks = run.bench(small_cell(config), seed, 0.0, False,
                               device="cpu")
    assert result["correct"], checks
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert dict(os.environ) == before


FAULT_CASES = [(c, f) for c, j in (("sibelia_loose", "blocks"),
                                   ("csibelia_default", "variants"))
               for f in faults.FAULTS[j]]


@pytest.mark.parametrize("config,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct(config, fault):
    cell = small_cell(config)
    result, checks = run.bench(cell, 7, 0.0, False, device="cpu",
                               plant=faults.for_config(cell.config)[fault])
    assert not result["correct"], (fault, checks)


def test_the_control_readings_are_the_harness_verdicts():
    rows = control.readings(small_cell("csibelia_default"), [7],
                            ["none", "gap_shifted"], device="cpu")
    assert [r["correct"] for r in rows] == [True, False]
    assert rows[1]["numbers"]["score_deficit"] > rows[0]["numbers"]["score_deficit"]
    summary = control.summary(rows)
    assert summary["gap_shifted"]["correct_runs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS.values()))
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = run.bench(load_cell(name), 2**31 + 3, 1.0, True)
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
