"""Bit-exact emulation of glibc rand() (TYPE_3 additive feedback generator).

The reference randomizes ambiguous bases with unseeded C rand()
(reference: src/indexedsequence.cpp:33-37), which in glibc means the
deterministic stream produced by srand(1). To reproduce the reference's
outputs on inputs containing N/ambiguity codes we replicate that stream.

Algorithm (glibc stdlib/random_r.c, TYPE_3, DEG=31, SEP=3):
  r[0] = seed
  r[i] = (16807 * r[i-1]) % 2147483647  for i in 1..30   (Schrage, signed)
  r[i] = r[i-31]                        for i in 31..33
  r[i] = (r[i-31] + r[i-3]) mod 2^32    for i >= 34
  output o[i] = r[i] >> 1               for i >= 344 - 310 discarded warmups
"""
from __future__ import annotations


class GlibcRand:
    def __init__(self, seed: int = 1):
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed & 0xFFFFFFFF
        word = seed
        for i in range(1, 31):
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._hist = r[3:]  # keep a sliding window; need r[i-3] and r[i-31]
        # full list approach: keep last 31 values
        self._buf = r[:]  # indices align with generation order
        # warm up: discard first 310 outputs of the recurrence
        self._idx = 34
        for _ in range(310):
            self._next_raw()

    def _next_raw(self) -> int:
        buf = self._buf
        val = (buf[-31] + buf[-3]) & 0xFFFFFFFF
        buf.append(val)
        if len(buf) > 64:
            del buf[:-31]
        return val >> 1

    def rand(self) -> int:
        return self._next_raw()
