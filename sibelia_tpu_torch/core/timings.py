"""Per-phase wall-clock accounting for the pipeline.

The reference has no observability beyond the progress bar (SURVEY §5);
this registry gives the bench harness and users a per-phase split of an
end-to-end run.  Phases accumulate (multiple stages add into the same
key).  The CLI dumps the table as JSON to $SIBELIA_TPU_TIMINGS when set.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

_ACC: dict[str, float] = {}


@contextmanager
def phase(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        _ACC[name] = _ACC.get(name, 0.0) + (time.time() - t0)


def add(name: str, seconds: float) -> None:
    _ACC[name] = _ACC.get(name, 0.0) + seconds


def snapshot() -> dict[str, float]:
    return {k: round(v, 2) for k, v in _ACC.items()}


def reset() -> None:
    _ACC.clear()


def dump(path: str) -> None:
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
