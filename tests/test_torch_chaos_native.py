"""The port's native CHAOS (``native/lagan_chaos.cpp``) against the JAX
package's, byte for byte, at sizes where chains run hundreds of links.

The port's chaos keeps a chain as parent links between hit slots, its
trie flat and its hit records in region-wide arrays; the JAX package's
copies each chain.  Both give the reference binary's text, so every case
asks for equal text from ``native.lagan_chaos`` of both packages, at each
recursion level of ``rechaos`` and at cmerge2's single (12,0,40,0) level,
with ``-gfc`` and the extension on and off, on:

* ``diverged``: a 36 kbp pair, 1 % substitutions and a few indels;
* ``tandem``: tandem repeats of 1 to 37-base units, so that a leaf holds
  over a hundred locations and the diagonal list's insert leaves it locally
  unsorted;
* ``gaps``: runs of ``N``, ``.`` separators and lowercase bases;
* ``regions``: several ``-s1/-s2`` regions in one call, some under
  ``wl + 1`` on one side or both.

The levels with a degenerate position (nd = 1) search windows of a few
kbp, the shape rechaos gives them.  ``rechaos_batch`` on the four pairs
equals the JAX package's ``rechaos``, and its work counters
(``chaos_words``, ``chaos_links``) are positive and the same with one
thread and three."""
import numpy as np
import pytest

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu import native as jax_native
from sibelia_tpu.align import lagan_exact as jax_exact
from sibelia_tpu_torch import native
from sibelia_tpu_torch.align import lagan_exact
from sibelia_tpu_torch.core import timings

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
LEVELS = lagan_exact.RECURSION_LEVELS + [(12, 0, 40, 0)]


def _dna(rng, n):
    return ACGT[rng.integers(0, 4, n)]


def _mutate(rng, s, rate, indels):
    """`s` with `rate` substitutions and `indels` indels of 1-30 bp."""
    s = s.copy()
    hit = np.flatnonzero(rng.random(s.size) < rate)
    s[hit] = _dna(rng, hit.size)
    for _ in range(indels):
        pos, ln = int(rng.integers(s.size)), int(rng.integers(1, 31))
        if rng.random() < 0.5:
            s = np.concatenate([s[:pos], s[pos + ln:]])
        else:
            s = np.concatenate([s[:pos], _dna(rng, ln), s[pos:]])
    return s


def _windows(n1, n2, size, count):
    """`count` region pairs of `size` bases spread over both sequences."""
    starts = np.linspace(0, min(n1, n2) - size, count).astype(int)
    return "".join(f"-s1 {s + 1} {s + size} -s2 {s + 1} {s + size}\n"
                   for s in starts)


def _whole(a, b):
    return f"-s1 1 {len(a)} -s2 1 {len(b)}\n"


def _diverged():
    rng = np.random.default_rng(19)
    anc = _dna(rng, 36_000)
    a, b = bytes(anc), bytes(_mutate(rng, anc, 0.01, 6))
    return a, b, _whole(a, b), _windows(len(a), len(b), 2500, 3)


def _tandem():
    rng = np.random.default_rng(23)
    parts = []
    for unit in (1, 2, 5, 12, 37, 3):
        parts.append(_dna(rng, 700))
        parts.append(np.resize(_dna(rng, unit), int(rng.integers(80, 140))))
    anc = np.concatenate(parts + [_dna(rng, 700)])
    # the copy's repeats lose or gain units, so their diagonals shift
    b = _mutate(rng, anc, 0.005, 0)
    for lo in (800, 2400, 3900):
        b = np.concatenate([b[:lo], b[lo + 24:lo + 120], b[lo:lo + 48],
                            b[lo + 120:]])
    a, b = bytes(anc), bytes(b)
    return a, b, _whole(a, b), _windows(len(a), len(b), 1000, 3)


def _gaps():
    rng = np.random.default_rng(29)
    anc = _dna(rng, 9000)
    b = _mutate(rng, anc, 0.01, 3)
    a = anc.copy()
    for s, at in ((a, 1200), (a, 5000), (b, 3000), (b, 7000)):
        s[at:at + 60] = ord("N")
    for s, at in ((a, 2500), (b, 2600), (a, 7700)):
        s[at] = ord(".")
    a[4000:4400] = np.char.lower(a[4000:4400].view("S1")).view(np.uint8)
    a, b = bytes(a), bytes(b)
    return a, b, _whole(a, b), _windows(len(a), len(b), 2200, 3)


def _regions():
    rng = np.random.default_rng(31)
    anc = _dna(rng, 12_000)
    a, b = bytes(anc), bytes(_mutate(rng, anc, 0.01, 4))
    regions = ("-s1 1 4000 -s2 1 4050\n"
               "-s1 4001 4010 -s2 4051 4060\n"    # both under wl + 1
               "-s1 4100 4105 -s2 4100 6000\n"    # seq1's side under
               "-s1 6000 9000 -s2 6010 6011\n"    # seq2's side under
               "-s1 9001 11900 -s2 9001 11880\n")
    return a, b, regions, regions.replace("-s1 1 4000 -s2 1 4050\n", "")


INPUTS = {"diverged": _diverged(), "tandem": _tandem(), "gaps": _gaps(),
          "regions": _regions()}


@pytest.mark.parametrize("ext", [False, True], ids=["noext", "ext"])
@pytest.mark.parametrize("gfc", [False, True], ids=["nogfc", "gfc"])
@pytest.mark.parametrize("level", LEVELS,
                         ids=["%d-%d-%d-%d" % lv for lv in LEVELS])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_chaos_equals_jax(name, level, gfc, ext):
    a, b, whole, windows = INPUTS[name]
    pairs_text = whole if level[1] == 0 else windows
    want = jax_native.lagan_chaos(a, "sA", b, "sB", pairs_text, *level,
                                  gfc=gfc, ext=ext)
    got = native.lagan_chaos(a, "sA", b, "sB", pairs_text, *level,
                             gfc=gfc, ext=ext)
    assert want is not None and got == want
    assert want.count("\n") > 0


def test_long_chains_are_walked():
    """The diverged pair's first level rescores hits whose chains run
    hundreds of links, and the counters count them."""
    a, b, whole, _ = INPUTS["diverged"]
    before = native.lagan_chaos_stats()
    text = native.lagan_chaos(a, "sA", b, "sB", whole, *LEVELS[0])
    words, links = (x - y for x, y in zip(native.lagan_chaos_stats(),
                                          before))
    hits = text.count("score")
    assert words >= 30_000 and hits > 0 and links / hits > 200


@pytest.mark.parametrize("processes", [1, 3])
def test_rechaos_batch_equals_jax_rechaos(processes):
    pairs = [(a, f"{name}1", b, f"{name}2")
             for name, (a, b, _, _) in sorted(INPUTS.items())]
    timings.reset()
    got = lagan_exact.rechaos_batch(pairs, processes=processes)
    counts = {k: timings.snapshot()[k] for k in ("chaos_words",
                                                 "chaos_links")}
    assert got == [jax_exact.rechaos(*p) for p in pairs]
    assert all(v > 0 for v in counts.values())
    timings.reset()
    lagan_exact.rechaos_batch(pairs, processes=4 - processes)
    assert counts == {k: timings.snapshot()[k] for k in counts}
