"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` fails them (``control.py`` on the card at a cell's own
size, ``tests/test_portbench_reference.py`` on the CPU at a small one).

``overlap_unresolved`` is the control: block generation claims bases
without looking at what earlier blocks hold, which breaks the guarantee
that instances do not overlap.  The others are the faults a cell can
have: a step that returns its state unchanged (the graph simplification),
half of the batch left out (the blocks; C-Sibelia's variants), and an
answer altered where it is produced (a block's instance; a base of an
aligned row; the columns of one alignment; one gap of one alignment
moved a few columns, as a wrong choice in the band DP or its traceback
would move it; one gap in a repeat placed one column back, as a wrong
tie-break would place it).

``FAULTS`` holds them by the judge a configuration names
(``reference.judge_name``): the fast aligner's (``fast``) plants the
alignment faults in the rows of its own ``align_pair``, and a tie moved
one column on, since its traceback puts a tied gap run first.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from .reference import DEFAULT, judge_name


@contextmanager
def patched(module, name: str, make):
    """module.name replaced by make(original) inside the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def overlap_unresolved():
    from sibelia_tpu_torch.blocks import synteny
    return patched(synteny, "resolve_overlap", lambda f: (
        lambda group, min_size, overlap:
        f(group, min_size, [np.zeros_like(o) for o in overlap])))


def state_unchanged():
    from sibelia_tpu_torch.blocks import finder
    return patched(finder, "simplify", lambda f: (lambda *a, **k: 0))


def half_blocks_dropped():
    from sibelia_tpu_torch.blocks import finder
    return patched(finder, "generate_synteny_blocks", lambda f: (
        lambda *a, **k: [b for b in f(*a, **k) if b.block_id % 2]))


def instance_moved():
    """The first instance of the longest block, moved by its own length
    along its sequence (back, where forward would leave it)."""
    from dataclasses import replace

    from sibelia_tpu_torch.blocks import finder

    def make(f):
        def wrapped(*a, **k):
            blocks = f(*a, **k)
            if not blocks:
                return blocks
            i = max(range(len(blocks)), key=lambda j: blocks[j].length)
            b = blocks[i]
            n = len(b.chr.sequence)
            shift = b.length if b.end + b.length <= n else -b.length
            blocks[i] = replace(b, start=b.start + shift, end=b.end + shift)
            return blocks
        return wrapped
    return patched(finder, "generate_synteny_blocks", make)


def variants_halved():
    """Every other aligned pair's variants left out."""
    from sibelia_tpu_torch.variants import caller
    calls = [0]

    def make(f):
        def wrapped(*a, **k):
            calls[0] += 1
            return f(*a, **k) if calls[0] % 2 else []
        return wrapped
    return patched(caller, "parse_alignment", make)


def _base_altered(pair):
    row = pair[1]
    j = next(j for j, c in enumerate(row) if c != "-")
    return (pair[0], row[:j] + ("C" if row[j] in "Aa" else "A") + row[j + 1:])


def _unaligned(pair):
    a, b = (r.replace("-", "") for r in pair)
    n = max(len(a), len(b))
    return (a + "-" * (n - len(a)), b + "-" * (n - len(b)))


def _gap_shifted(pair, by: int = 4, widest: int = 15):
    """The first gap run inside the alignment that the comparison holds
    (no wider than `widest`, the configuration's ``band_half_width``),
    after a column of two bases and before `by` bases of its own row,
    moved `by` columns on."""
    rows = list(pair)
    for col in range(1, len(rows[0])):
        for r in (0, 1):
            row, other = rows[r], rows[1 - r]
            if row[col] != "-" or row[col - 1] == "-" or other[col - 1] == "-":
                continue
            end = col
            while end < len(row) and row[end] == "-":
                end += 1
            moved = row[end:end + by]
            if end - col > widest or len(moved) < by or "-" in moved:
                continue
            rows[r] = row[:col] + moved + row[col:end] + row[end + by:]
            return tuple(rows)
    return pair


def _gap_tie_back(pair):
    """The first gap run between two columns of two bases that can move
    one column back at an equal score, moved there."""
    rows = list(pair)
    for col in range(1, len(rows[0]) - 1):
        for r in (0, 1):
            row, other = rows[r], rows[1 - r]
            if row[col] != "-" or row[col - 1] == "-" or other[col - 1] == "-":
                continue
            end = col
            while end < len(row) and row[end] == "-":
                end += 1
            if end >= len(row) or other[col - 1] != other[end - 1]:
                continue
            rows[r] = row[:col - 1] + row[col:end] + row[col - 1] + row[end:]
            return tuple(rows)
    return pair


@contextmanager
def first_pair(transform):
    """The rows of the first exactly aligned pair that has a gap and that
    `transform` changes, changed: in the batch of all pairs (on a card), or among the
    pairs aligned alone (on the CPU)."""
    from sibelia_tpu_torch.align import lagan_exact
    done = [False]

    def pick(r):
        if r is None or done[0] or "-" not in r[0] + r[1]:
            return r
        changed = transform(r)
        done[0] = changed != r
        return changed

    def batch(f):
        def wrapped(*a, **k):
            return [pick(r) for r in f(*a, **k)]
        return wrapped

    def single(f):
        def wrapped(*a, **k):
            return pick(f(*a, **k))
        return wrapped
    with patched(lagan_exact, "align_pairs_exact_batch", batch), \
            patched(lagan_exact, "align_pair_exact", single):
        yield


def _gap_tie_on(pair):
    """The first gap run between two columns of two bases that can move
    one column on at an equal score (``alignscore.tie_errors``' rule),
    moved there."""
    rows = list(pair)
    for col in range(1, len(rows[0]) - 1):
        for r in (0, 1):
            row, other = rows[r], rows[1 - r]
            if row[col] != "-" or row[col - 1] == "-" or other[col - 1] == "-":
                continue
            end = col
            while end < len(row) and row[end] == "-":
                end += 1
            if (end >= len(row) or "-" in (row[end], other[end])
                    or other[col].upper() != other[end].upper()):
                continue
            rows[r] = row[:col] + row[end] + row[col:end] + row[end + 1:]
            return tuple(rows)
    return pair


@contextmanager
def fast_pair(transform):
    """The rows of the first unique pair that the fast aligner aligns,
    that has a gap and that `transform` changes, changed: the variant
    caller's own binding of ``align_pair``."""
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
    with patched(caller, "align_pair", make):
        yield


def row_base_altered():
    """One base of an aligned assembly row changed."""
    return first_pair(_base_altered)


def gap_shifted():
    """One gap of one pair's alignment moved four columns on: the bases
    are right, a few columns are not."""
    return first_pair(_gap_shifted)


def gap_tie_back():
    """One gap in a repeat placed one column back, where it scores the
    same: a wrong tie-break."""
    return first_pair(_gap_tie_back)


def rows_unaligned():
    """One pair's alignment replaced by its two rows laid end to end: the
    bases are right, their columns are not."""
    return first_pair(_unaligned)


# the widest gap run the fast aligner's score windows hold (csibelia_fast's
# band_half_width: the widest gap its Gotoh kernel closes)
FAST_WIDEST = 128
CONTROL = "overlap_unresolved"
BLOCKS = {"overlap_unresolved": overlap_unresolved,
          "state_unchanged": state_unchanged,
          "half_blocks_dropped": half_blocks_dropped,
          "instance_moved": instance_moved}
FAULTS = {
    "blocks": BLOCKS,
    "variants": {**BLOCKS, "variants_halved": variants_halved,
                 "row_base_altered": row_base_altered,
                 "rows_unaligned": rows_unaligned,
                 "gap_shifted": gap_shifted,
                 "gap_tie_back": gap_tie_back},
    "fast": {**BLOCKS, "variants_halved": variants_halved,
             "row_base_altered": lambda: fast_pair(_base_altered),
             "rows_unaligned": lambda: fast_pair(_unaligned),
             "gap_shifted": lambda: fast_pair(
                 lambda p: _gap_shifted(p, widest=FAST_WIDEST)),
             "gap_tie_on": lambda: fast_pair(_gap_tie_on)},
}


def for_config(config: dict) -> dict:
    """The faults of a configuration's judge; a judge with none of its own
    takes its program's."""
    return FAULTS.get(judge_name(config)) or FAULTS[DEFAULT[config["program"]]]
