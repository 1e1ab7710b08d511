"""Exact mlagan pipeline (progressive multiple alignment of repeat blocks;
twin of ``sibelia_tpu/align/mlagan_exact.py``; `device` goes through to
``rechaos``, whose anchors stage runs on a card).

Drives the native mlagan port (native/lagan_multial.cpp) through the
reference binary's pipeline: rechaos per pair WITHOUT -gfc
(mlagan.c:231-240), anchors handed over in file order, similarity-tree
progressive merging, FASTA output byte-identical to
``mlagan f1 ... fN`` for C-Sibelia's flag-free invocation.
"""
from __future__ import annotations

import re

import torch

from ..native import mlagan_native
from .lagan_exact import rechaos

_ANCHOR_RE = re.compile(r"\((\d+) (\d+)\)=\((\d+) (\d+)\) (.*)")


def mlagan_fasta(seqs: list[bytes], names: list[str],
                 device: torch.device | None = None) -> str:
    """FASTA text of the progressive alignment (reference mlagan stdout)."""
    n = len(seqs)
    pair_lines: dict[tuple[int, int], list] = {}
    for i in range(n - 1):
        for j in range(i + 1, n):
            text = rechaos(seqs[i], names[i], seqs[j], names[j], gfc=False,
                           device=device)
            lines = []
            for line in text.split("\n"):
                m = _ANCHOR_RE.match(line)
                if m:
                    lines.append((int(m.group(1)), int(m.group(2)),
                                  int(m.group(3)), int(m.group(4)),
                                  float(m.group(5))))
            pair_lines[(i, j)] = lines
    return mlagan_native(seqs, names, pair_lines)


def align_multiple_exact(seqs: list[bytes], names: list[str],
                         device: torch.device | None = None) -> list[str]:
    """Aligned rows in the reference's output order (which follows the
    merge-tree order, not necessarily the input order); returns rows
    re-ordered to match the input by name."""
    fasta = mlagan_fasta(seqs, names, device)
    rows: dict[str, str] = {}
    cur_name = None
    cur: list[str] = []
    for line in fasta.split("\n"):
        if line.startswith(">"):
            if cur_name is not None:
                rows[cur_name] = "".join(cur)
            cur_name = line[1:]
            cur = []
        elif line:
            cur.append(line)
    if cur_name is not None:
        rows[cur_name] = "".join(cur)
    return [rows[nm] for nm in names]
