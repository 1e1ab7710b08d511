"""Exact LAGAN pipeline (lagan.pl / rechaos.pl semantics; twin of
``sibelia_tpu/align/lagan_exact.py``).  Where the JAX package asks
``device_dispatch()``, the functions here take the run's ``device``: on a
CUDA device the anchors stage and the order stage's band DP run on the
card (``align/anchors_device.py``, ``kernels/order_device.py``); with
``None`` or the CPU they run in the native library, unless
``SIBELIA_TPU_ANCHORS_DEVICE=1`` or ``SIBELIA_TPU_DEVICE_ORDER=1`` forces
the device modules (on the CPU their plain versions).

Drives the native chaos / anchors / order stage primitives
(native/lagan_*.cpp) through the recursive anchoring scheme of
the reference Perl scripts (reference: src/lagan/lagan.pl:132-178 and
src/lagan/rechaos.pl), producing byte-identical -mfa output to
``lagan.pl seq1 seq2 -mfa`` for the inputs C-Sibelia generates.

Replicated script behaviors:

* the recursion schedule ``(12,0,25,0)x,(13,1,30,0)x,(4,0,4,3000)xt,
  (8,1,30,0)x,(7,1,30,0)x`` with translated levels skipped
  (rechaos.pl:14, :160);
* sentinel boundary anchors (scores 1.1 / 1.2) appended while more levels
  remain (rechaos.pl:190-198);
* accumulated-anchor carry-over between levels minus the first/last
  (sentinel) entries (rechaos.pl:247-252);
* gap-region extraction with minbox 10 / minside 5 and the strict
  begin < end check (rechaos.pl:16-17, :304-312);
* GNU ``sort -n -k2,2`` / ``sort -nr -k2,2`` emulation: numeric value of
  the second whitespace-delimited field with a bytewise whole-line
  last-resort comparison (C collation), reversal applying to both.
"""
from __future__ import annotations

import re

import os

import torch

from ..core import timings
from ..native import (lagan_anchors, lagan_chaos, lagan_chaos_stats,
                      lagan_order, load_lagan)


def available() -> bool:
    """Whether the native LAGAN library is on (SIBELIA_TPU_NATIVE=0 turns
    it off; a failed build raises)."""
    return load_lagan() is not None


def _on_card(device: torch.device | None) -> bool:
    return device is not None and device.type == "cuda"


def _anchors_stage(texts: list[str], gfc: bool,
                   device: torch.device | None) -> list[str]:
    """anchors stage dispatch for the chaos outputs of one recursion level
    (one a pair): the device weighted-LIS sweep (align/anchors_device.py,
    byte-equal by differential test; every text's sweep in one call) on a
    CUDA device or when SIBELIA_TPU_ANCHORS_DEVICE=1; the native C++ sweep
    otherwise, and for hits the device sweep does not take."""
    env = os.environ.get("SIBELIA_TPU_ANCHORS_DEVICE")
    use_dev = env == "1" if env is not None else _on_card(device)
    outs: list[str | None] = [None] * len(texts)
    if use_dev:
        from .anchors_device import anchors_text_device_batch
        outs = anchors_text_device_batch(texts, gfc,
                                         device or torch.device("cpu"))
    return [lagan_anchors(text, gfc=gfc) if out is None else out
            for text, out in zip(texts, outs)]


def order_on_device(device: torch.device | None) -> bool:
    """Whether the order stage's band DP goes to kernels/order_device.py:
    SIBELIA_TPU_DEVICE_ORDER=0 forces the host, any other value the device
    module, unset means a CUDA device."""
    env = os.environ.get("SIBELIA_TPU_DEVICE_ORDER")
    return env != "0" if env is not None else _on_card(device)


# rechaos.pl:14 minus the translated level (skipped when -translate is off)
RECURSION_LEVELS = [(12, 0, 25, 0), (13, 1, 30, 0), (8, 1, 30, 0),
                    (7, 1, 30, 0)]
MINBOX = 10   # rechaos.pl:16
MINSIDE = 5   # rechaos.pl:17
SENTINEL_LEFT = 1.1   # rechaos.pl:30
SENTINEL_RIGHT = 1.2  # rechaos.pl:31

_ANCHOR_RE = re.compile(r"\((\d+) (\d+)\)=\((\d+) (\d+)\) (.*)")


def _field2_numeric(line: str) -> int:
    """Numeric value GNU sort assigns to key -k2,2 of an anchor line."""
    fields = line.split()
    if len(fields) < 2:
        return 0
    text = fields[1]
    m = re.match(r"[+-]?\d*", text)
    tok = m.group(0) if m else ""
    if tok in ("", "+", "-"):
        return 0
    return int(tok)


def _gnu_sort_n_k2(lines: list[str], reverse: bool = False) -> list[str]:
    """GNU ``sort -n -k2,2`` (``-nr`` when reverse): numeric key with the
    whole-line bytewise last-resort; -r reverses both comparisons."""
    keyed = sorted(lines, key=lambda l: (_field2_numeric(l),
                                         l.encode("latin-1")))
    if reverse:
        keyed.reverse()
    return keyed


class _Rechaos:
    """One pair's state through the levels of rechaos.pl: the regions still
    to search, the clip sentinels and the anchors carried over.  A level is
    ``chaos`` (the anchors stage's input), the anchors stage, ``absorb``
    (its output)."""

    def __init__(self, seq1: bytes, name1: str, seq2: bytes, name2: str,
                 gfc: bool, levels: list[tuple[int, int, int, int]]):
        self.seq1, self.name1, self.seq2, self.name2 = seq1, name1, seq2, name2
        self.gfc = gfc
        self.levels = levels
        self.b1, self.e1 = [1], [len(seq1)]
        self.b2, self.e2 = [1], [len(seq2)]
        self.app_str = ""
        self.sorted_lines: list[str] = []

    def chaos(self, level: int) -> str:
        """The hits of this level's regions, with the sentinels (while more
        levels remain) and the anchors found so far."""
        wl, nd, co, rsc = self.levels[level]
        pairs_text = "".join(
            f"-s1 {self.b1[j]} {self.e1[j]} -s2 {self.b2[j]} {self.e2[j]}\n"
            for j in range(len(self.b1)))
        hits = lagan_chaos(self.seq1, self.name1, self.seq2, self.name2,
                           pairs_text, wl, nd, co, rsc, gfc=self.gfc,
                           ext=True)
        if level + 1 < len(self.levels):
            # rechaos.pl's clip bounds: nothing is clipped here, so the
            # left sentinel ends at 0 and the right one starts past the end
            t1 = len(self.seq1) + 1
            t2 = len(self.seq2) + 1
            self.app_str += (f"seq1 0 0; seq2 0 0; "
                             f"score={SENTINEL_LEFT} (+)\n")
            self.app_str += (f"seq1 {t1} {t1}; seq2 {t2} {t2}; "
                             f"score={SENTINEL_RIGHT} (+)\n")
        return hits + self.app_str

    def absorb(self, level: int, anch: str) -> None:
        """Takes the anchors stage's output: sorts it and, while more levels
        remain, keeps the anchors for the next level's input and cuts the
        gaps between them into its regions."""
        self.sorted_lines = sorted_lines = _gnu_sort_n_k2(
            [l for l in anch.split("\n") if l != ""])
        if level + 1 >= len(self.levels):
            return
        parsed = []
        for line in sorted_lines:
            m = _ANCHOR_RE.match(line)
            parsed.append(m.groups() if m else None)
        app_str = ""
        nb1: list[int] = []
        nb2: list[int] = []
        ne1: list[int] = []
        ne2: list[int] = []
        for m_i in range(len(sorted_lines)):
            if 1 <= m_i < len(sorted_lines) - 1 and parsed[m_i]:
                g = parsed[m_i]
                app_str += (f"seq1 {g[0]} {g[1]}; seq2 {g[2]} {g[3]}; "
                            f"score={g[4]} (+)\n")
            if m_i == 0:
                continue
            gp = parsed[m_i - 1]
            gc = parsed[m_i]
            if gp is None or gc is None:
                continue
            gap1begin = int(gp[1]) + 1
            gap2begin = int(gp[3]) + 1
            gap1end = int(gc[0]) - 1
            gap2end = int(gc[2]) - 1
            boxarea = (gap1end - gap1begin + 1) * (gap2end - gap2begin + 1)
            if (boxarea >= MINBOX and (gap1end - gap1begin + 1) > MINSIDE
                    and (gap2end - gap2begin + 1) > MINSIDE):
                if gap1begin < gap1end and gap2begin < gap2end:
                    nb1.append(gap1begin)
                    nb2.append(gap2begin)
                    ne1.append(gap1end)
                    ne2.append(gap2end)
        self.app_str = app_str
        self.b1, self.b2, self.e1, self.e2 = nb1, nb2, ne1, ne2

    def text(self) -> str:
        """rechaos.pl's stdout: the anchors sorted by seq1 end, descending."""
        return "".join(
            l + "\n" for l in _gnu_sort_n_k2(self.sorted_lines, reverse=True))


def rechaos_batch(pairs: list[tuple[bytes, str, bytes, str]],
                  gfc: bool = True,
                  levels: list[tuple[int, int, int, int]] | None = None,
                  device: torch.device | None = None,
                  processes: int = 1) -> list[str]:
    """rechaos of each (seq1, name1, seq2, name2), level by level over all
    pairs: chaos for every pair (native, the GIL released: fanned over a
    thread pool when processes > 1), then ONE anchors stage for the level
    (on a card: every pair's sweep in one launch), then each pair's next
    regions.  Each level adds chaos's work to the run's record: the
    counters ``chaos_words`` (word matches chained) and ``chaos_links``
    (chain links walked by the rescoring)."""
    levels = RECURSION_LEVELS if levels is None else levels
    states = [_Rechaos(*p, gfc, levels) for p in pairs]
    pool = None
    if processes > 1 and len(pairs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=processes)
    try:
        for level in range(len(levels)):
            before = lagan_chaos_stats()
            with timings.phase("chaos"):
                if pool is not None:
                    texts = list(pool.map(lambda st: st.chaos(level),
                                          states))
                else:
                    texts = [st.chaos(level) for st in states]
            if before is not None:
                words, links = lagan_chaos_stats()
                timings.add("chaos_words", words - before[0])
                timings.add("chaos_links", links - before[1])
            for st, anch in zip(states, _anchors_stage(texts, gfc, device)):
                st.absorb(level, anch)
    finally:
        if pool is not None:
            pool.shutdown()
    return [st.text() for st in states]


def rechaos(seq1: bytes, name1: str, seq2: bytes, name2: str,
            gfc: bool = True,
            levels: list[tuple[int, int, int, int]] | None = None,
            device: torch.device | None = None) -> str:
    """Returns the final anchor text (rechaos.pl stdout: anchors sorted by
    seq1 end, descending).  lagan.pl passes -gfc (gap-free chunk anchors);
    mlagan calls rechaos without it (whole-hit anchors, mlagan.c:231-240).
    `levels` overrides the recursion schedule (the `-recurse
    "(wl,nd,co,rsc)x,..."` flag — e.g. cmerge2.pl's single
    (12,0,40,0) level for contig-overlap detection)."""
    return rechaos_batch([(seq1, name1, seq2, name2)], gfc, levels,
                         device)[0]


def lagan_pl_mfa_batch(pairs: list[tuple[bytes, str, bytes, str]],
                       device: torch.device | None = None) -> list[str]:
    """``lagan.pl seq1 seq2 -mfa`` of each (seq1, name1, seq2, name2): the
    anchors of all pairs level by level (rechaos_batch), then, when the
    order stage goes to the device (order_on_device), every band DP and
    traceback in one batched call (kernels/order_device.py) and native
    lagan_order for the pairs it leaves (a band too wide); else native
    lagan_order for each.  The texts are independent of the batching."""
    with timings.phase("rechaos"):
        anchors = rechaos_batch(pairs, device=device)
    jobs = [(*p, anch) for p, anch in zip(pairs, anchors)]
    outs: list[str | None] = [None] * len(jobs)
    if order_on_device(device):
        from ..kernels.order_device import order_mfa_device_batch
        outs = order_mfa_device_batch(jobs, device or torch.device("cpu"))
    return [lagan_order(*job) if out is None else out
            for job, out in zip(jobs, outs)]


def lagan_pl_mfa(seq1: bytes, name1: str, seq2: bytes, name2: str,
                 device: torch.device | None = None) -> str:
    """Full ``lagan.pl seq1 seq2 -mfa`` replacement; returns the mfa text.

    The order-stage band DP goes to `device` when it is a card
    (kernels/order_device.py: byte-identical pointer matrix, native band
    construction and traceback); SIBELIA_TPU_DEVICE_ORDER=1/0 forces it
    on or off.  A batch of one of lagan_pl_mfa_batch."""
    return lagan_pl_mfa_batch([(seq1, name1, seq2, name2)], device)[0]


def _mfa_rows(mfa: str) -> tuple[str, str]:
    rows: list[str] = []
    cur: list[str] = []
    for line in mfa.split("\n"):
        if line.startswith(">"):
            if cur:
                rows.append("".join(cur))
                cur = []
        elif line:
            cur.append(line)
    if cur:
        rows.append("".join(cur))
    return rows[0], rows[1]


def align_pair_exact(a: bytes, b: bytes,
                     name_a: str = "seq_a",
                     name_b: str = "seq_b",
                     device: torch.device | None = None) -> tuple[str, str]:
    """Aligned rows for a unique block pair, byte-identical to the rows the
    reference C-Sibelia obtains from ``lagan.pl -mfa``."""
    if isinstance(a, str):
        a = a.encode()
    if isinstance(b, str):
        b = b.encode()
    return _mfa_rows(lagan_pl_mfa(a, name_a, b, name_b, device))


def align_pairs_exact_batch(
        pairs: list[tuple[bytes, bytes, str, str]],
        processes: int = 1,
        device: torch.device | None = None,
) -> list[tuple[str, str] | None]:
    """Batched unique-pair alignment: the anchors of all pairs level by
    level (rechaos_batch: chaos fanned over a thread pool when processes >
    1, one anchors stage a level), then every band DP in one batched call
    on the device (kernels/order_device.py).  Entries come back None when a
    pair needs the host fallback (band too wide); rows are byte-identical
    to align_pair_exact either way."""
    from ..kernels.order_device import order_mfa_device_batch

    def encoded(x):
        return x.encode() if isinstance(x, str) else x

    named = [(encoded(a), name_a, encoded(b), name_b)
             for a, b, name_a, name_b in pairs]
    with timings.phase("rechaos"):
        anchors = rechaos_batch(named, device=device, processes=processes)
    jobs = [(*p, anch) for p, anch in zip(named, anchors)]
    res = order_mfa_device_batch(jobs, device or torch.device("cpu"))
    return [None if mfa is None else _mfa_rows(mfa) for mfa in res]
