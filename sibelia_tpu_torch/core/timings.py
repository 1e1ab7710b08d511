"""The port's one record of spans and counters.

The reference has no observability beyond the progress bar (SURVEY §5);
this registry gives users and the benchmark a split of an end-to-end run.
``_ACC`` holds, for the current outermost CLI run (``run_scope``), the
seconds of every span name (``phase``, summed over its entries, unrounded,
on ``time.perf_counter_ns``) and every counter (``add``).  The CLIs dump it
as JSON to $SIBELIA_TPU_TIMINGS when set; the benchmark copies it after
each job.

While a ``torch.profiler`` session runs, every span entered also goes to
``LOG`` as ``(name, start_ns, end_ns, parent, run)``: start and end on
``time.time_ns``, the clock of the profiler's events, so that a gap on the
card can be put down to the program span open at the time; ``parent`` is
the index in ``LOG`` of the innermost logged span that encloses it on the
same thread (-1 for none) and ``run`` the outermost run it belongs to.  The
log lives for the whole process and holds at most ``LOG_CAP`` records; the
records that do not fit are counted in ``LOG_DROPPED``.  Outside a
profiler session nothing is logged.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from torch.autograd import profiler as _profiler

_ACC: dict[str, float] = {}

LOG_CAP = 1 << 20
LOG: list[list] = []
LOG_DROPPED = [0]
RUNS = [0]          # outermost runs begun in this process
_DEPTH = [0]        # run_scope nesting
_OPEN = threading.local()


def _profiling() -> bool:
    return getattr(_profiler, "_is_profiler_enabled", False)


@contextmanager
def phase(name: str):
    """Time the block into ``_ACC[name]`` (and into ``LOG`` while a
    profiler session runs)."""
    if not _profiling():
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            add(name, (time.perf_counter_ns() - t0) / 1e9)
        return
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    parent = stack[-1] if stack else -1
    if len(LOG) < LOG_CAP:
        idx = len(LOG)
        rec = [name, time.time_ns(), 0, parent, RUNS[0]]
        LOG.append(rec)
    else:
        idx, rec = parent, None
        LOG_DROPPED[0] += 1
    stack.append(idx)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        add(name, (time.perf_counter_ns() - t0) / 1e9)
        if rec is not None:
            rec[2] = time.time_ns()
        stack.pop()


def add(name: str, value: float) -> None:
    """Add `value` (seconds, or a count) to ``_ACC[name]``."""
    _ACC[name] = _ACC.get(name, 0) + value


def snapshot() -> dict[str, float]:
    return dict(_ACC)


def reset() -> None:
    _ACC.clear()


@contextmanager
def run_scope():
    """One CLI run: the outermost scope resets ``_ACC`` and starts a new
    run number; a run inside another (C-Sibelia's Sibelia stage) adds to
    the outer run's record."""
    if _DEPTH[0] == 0:
        reset()
        RUNS[0] += 1
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def log_records(first: int = 0) -> list[tuple]:
    """The closed records of ``LOG`` from index `first` on, as tuples."""
    return [tuple(r) for r in LOG[first:] if r[2]]
