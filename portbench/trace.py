"""The traced run: device intervals from torch.profiler, host spans the
harness records around the port's layers, and the arithmetic over both.

Device events come from the profiler's CUDA activity alone (kernels,
copies, memsets).  Their start and end are on the profiler's clock, which
is CLOCK_REALTIME, the clock of ``time.time_ns``; the host spans and the
traced window take the same clock, so an idle gap on the card can be
labelled by what the host was inside of while it lasted.
"""
from __future__ import annotations

import importlib
import json
import os
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.abspath(__file__))


def union_seconds(intervals: list[tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of [lo, hi) (ns) covered by at least one interval."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e9


def idle_gaps(intervals: list[tuple[int, int]], lo: int,
              hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) (ns) that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end and end < hi:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def label_at(spans: list[tuple[int, int, str]], t: int) -> str:
    """The innermost span (the latest to start) that holds time t."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "harness"


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every event the profiler saw on a card."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
        dur = (ev.duration_ns() if hasattr(ev, "duration_ns")
               else ev.duration_us() * 1000)
        out.append((ev.name(), int(start), int(start + dur)))
    return out


def breakdown(events, spans, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time (names cut to 160
    characters: torch's kernels carry their whole template), and the
    longest idle gaps on the card, each named by the host span it fell
    in."""
    by_name: dict[str, float] = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(s, e) for _, s, e in events], lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[label_at(spans, (s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps]}


class Spans:
    """Host spans around the calls into the port's layers.  The targets
    are named in ``spans.json`` as ``module:attribute`` (``Class.method``
    for a method); each is wrapped for the traced run and put back by
    ``restore``.  A target that does not exist is skipped and reported in
    ``missing``."""

    def __init__(self, path: str = os.path.join(HERE, "spans.json")):
        with open(path) as f:
            self.targets: dict[str, str] = json.load(f)
        self.records: list[tuple[int, int, str]] = []
        self.missing: list[str] = []
        self._undo: list[tuple[object, str, object]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.records.append((t0, time.time_ns(), name))

    def install(self) -> None:
        for name, target in self.targets.items():
            mod_name, _, attr_path = target.partition(":")
            try:
                owner = importlib.import_module(mod_name)
                *parents, attr = attr_path.split(".")
                for p in parents:
                    owner = getattr(owner, p)
                fn = getattr(owner, attr)
            except (ImportError, AttributeError):
                self.missing.append(target)
                continue
            self._undo.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))

    def _wrap(self, name: str, fn):
        spans = self

        def wrapped(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)
        wrapped.__wrapped__ = fn
        return wrapped

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()
