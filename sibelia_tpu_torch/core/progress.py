"""Console progress bar — PutProgressChr twin.

Reference: src/util.cpp:89-111.  A 50-dot bar: `[` at start, one `.` per
stride of work, `]` + newline at end (the end event first flushes any
remaining dots, so the bar always completes to 50).  States mirror
BlockFinder::State: 0 = start, 1 = run, 2 = end (blockfinder.h:38-39).
"""
from __future__ import annotations

import sys

PROGRESS_STRIDE = 50

START, RUN, END = 0, 1, 2


def make_progress_bar(out=None):
    """Return a callable(progress, state) that renders the reference's
    50-dot console bar."""
    stream = out if out is not None else sys.stdout
    prev = [0]

    def put_progress_chr(progress: int, state: int) -> None:
        while prev[0] < progress:
            prev[0] += 1
            stream.write(".")
            stream.flush()
        if state == START:
            prev[0] = 0
            stream.write("[")
            stream.flush()
        elif state == END:
            stream.write("]\n")
            stream.flush()

    return put_progress_chr
