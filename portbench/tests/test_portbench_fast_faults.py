"""Faults planted in the fast aligner's rows fail ``csibelia_fast``'s
comparison, and the unchanged job passes it.

``faults.py``'s alignment faults patch the exact aligner, which the fast
path never calls; these patch the rows that the variant caller takes from
the fast aligner's ``align_pair`` for its unique pairs (the caller's own
binding of it) with ``faults.py``'s transforms of a pair's rows: a base
altered, a gap moved four columns on, the rows laid end to end.  The
configuration holds no ``tie_errors`` (the fast traceback puts a tied gap
first), so a tie placed one back is no fault here."""
import pytest

from portbench import faults, run
from portbench.run import load_cell

SMALL = {"genomes": "pair", "length": 250_000, "contig_min": 20_000,
         "contig_max": 80_000}


def small_cell():
    cell = load_cell("csibelia_fast.saureus_half_pair")
    cell.traffic = SMALL
    return cell


def fast_pair(transform):
    """The first unique pair with a gap whose rows `transform` changes,
    changed."""
    from sibelia_tpu_torch.variants import caller
    done = [False]

    def make(f):
        def wrapped(*a, **k):
            rows = f(*a, **k)
            if done[0] or "-" not in rows[0] + rows[1]:
                return rows
            changed = transform(rows)
            done[0] = changed != rows
            return changed
        return wrapped
    return faults.patched(caller, "align_pair", make)


WIDEST = load_cell("csibelia_fast.saureus_half_pair").config["scoring"][
    "band_half_width"]
PLANTS = {
    "row_base_altered": lambda: fast_pair(faults._base_altered),
    "gap_shifted": lambda: fast_pair(
        lambda p: faults._gap_shifted(p, widest=WIDEST)),
    "rows_unaligned": lambda: fast_pair(faults._unaligned),
}


@pytest.mark.parametrize("fault", [None, *sorted(PLANTS)])
def test_a_fault_in_the_fast_rows_is_not_correct(fault):
    result, checks = run.bench(small_cell(), 7, 0.0, False, device="cpu",
                               plant=PLANTS[fault] if fault else None)
    assert result["correct"] == (fault is None), (fault, checks)
