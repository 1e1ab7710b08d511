"""Faults planted in the fast aligner's rows fail ``csibelia_fast``'s
comparison, and the unchanged job passes it.

``faults.FAULTS["fast"]`` patches the rows that the variant caller takes
from the fast aligner's ``align_pair`` for its unique pairs (the
caller's own binding of it) with ``faults.py``'s transforms of a pair's
rows: a base altered, a gap moved four columns on, the rows laid end to
end, and a tied gap run moved one column on.  The configuration holds no
``tie_errors`` (the fast traceback puts a tied gap first), so a tie
moved on is for ``anchored_row_errors`` alone to catch: the rows against
the plain reference, ``portbench/reference/anchored.py``."""
import pytest

from portbench import faults, run
from portbench.run import load_cell

SMALL = {"genomes": "pair", "length": 250_000, "contig_min": 20_000,
         "contig_max": 80_000}
PLANTS = ("row_base_altered", "gap_shifted", "rows_unaligned", "gap_tie_on")


def small_cell():
    cell = load_cell("csibelia_fast.saureus_half_pair")
    cell.traffic = SMALL
    return cell


def test_the_fast_faults_are_the_configurations():
    cell = small_cell()
    assert faults.for_config(cell.config) is faults.FAULTS["fast"]
    assert set(PLANTS) <= set(faults.FAULTS["fast"])
    assert faults.FAST_WIDEST == cell.config["scoring"]["band_half_width"]


@pytest.mark.parametrize("fault", [None, *sorted(PLANTS)])
def test_a_fault_in_the_fast_rows_is_not_correct(fault):
    result, checks = run.bench(small_cell(), 7, 0.0, False, device="cpu",
                               plant=faults.FAULTS["fast"][fault] if fault
                               else None)
    assert result["correct"] == (fault is None), (fault, checks)
    assert (checks["anchored_row_errors"] > 0) == (fault is not None), checks
