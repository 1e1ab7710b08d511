"""Arithmetic the metric files share.  A metric file under ``metrics/``
is named after its metric and defines ``read(run)``, which returns a
number, or None where the run has nothing for it to read."""
from __future__ import annotations

import json
import os

from .trace import union_seconds

HERE = os.path.dirname(os.path.abspath(__file__))


def rate_mbp_s(run, program: str):
    """Input bases of every job the window completed, in Mbp, over the
    window's wall seconds."""
    if run.program != program or not run.jobs:
        return None
    return run.bases * len(run.jobs) / 1e6 / run.window_s


def phase_per_job(run, phase: str, program: str):
    """A timings phase's seconds over the window, a job on average; None
    where no job entered the phase."""
    if run.program != program or not run.jobs:
        return None
    vals = [j.phases[phase] for j in run.jobs if phase in j.phases]
    if not vals:
        return None
    return sum(vals) / len(run.jobs)


def launches_per_job(run, program: str):
    """Launches the port counted (``platform.LAUNCHES``) a job."""
    if run.program != program or not run.jobs:
        return None
    return sum(sum(j.launches.values()) for j in run.jobs) / len(run.jobs)


def port_kernels() -> list[str]:
    with open(os.path.join(HERE, "kernels.json")) as f:
        return json.load(f)


def kernel_ms_per_job(run, program: str):
    """Device ms of the port's own kernels (``kernels.json``: names or
    prefixes) a job, from the traced window."""
    if run.program != program or not run.jobs or run.events is None:
        return None
    names = port_kernels()
    ns = sum(e - s for n, s, e in run.events if any(k in n for k in names))
    return ns / 1e6 / len(run.jobs)


def card_idle_pct(run, program: str):
    """100 less the share of the window in which any kernel, copy or
    memset ran on the card."""
    if run.program != program or run.events is None:
        return None
    lo, hi = run.trace_ns
    busy = union_seconds([(s, e) for _, s, e in run.events], lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e9))
