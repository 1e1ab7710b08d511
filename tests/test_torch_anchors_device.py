"""Port vs JAX: the anchors stage's event sweep
(``sibelia_tpu_torch/align/anchors_device.py``) against
``sibelia_tpu/align/anchors_device.py`` and the port's native
``lagan_anchors``, on the same seeded inputs.  Exact throughout: int32
and float32 results are compared bit for bit, texts byte for byte.  The
JAX sweep is a ``lax.scan`` and runs as it is on the CPU; the port runs its
plain version (``sweep_plain``) because its tensors lie on the CPU.

JAX is imported inside the tests that compare with it, so the CUDA tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_anchors_device.py``."""
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu_torch.align import anchors_device as port
from sibelia_tpu_torch.core.platform import LAUNCHES
from sibelia_tpu_torch.native import lagan_anchors, lagan_chaos

CPU = torch.device("cpu")


def _hit_line(a_s, a_e, b_s, b_e, score):
    return "seq1 %d %d; seq2 %d %d; score = %.1f (+)\n" % (
        a_s, a_e, b_s, b_e, score)


def _random_hits(rng, n, tie_heavy=False):
    """The generator of tests/test_anchors_device.py."""
    lines = []
    for _ in range(n):
        a_s = int(rng.integers(0, 500))
        b_s = int(rng.integers(0, 500))
        ln = int(rng.integers(1, 40))
        if tie_heavy:
            # coarse grids force equal coordinates and equal scores
            a_s = (a_s // 25) * 25
            b_s = (b_s // 25) * 25
            ln = 20
            score = float(rng.integers(1, 4)) * 10.0
        else:
            score = float(rng.integers(-5, 80))
        lines.append(_hit_line(a_s, a_s + ln, b_s, b_s + ln, score))
    return "".join(lines)


def hit_set(rng, n, tie_heavy=False, span=500):
    """(a_s, a_e, score, ev_hit, ev_isstart) of n random hits."""
    a_s = rng.integers(0, span, n)
    b_s = rng.integers(0, span, n)
    ln = rng.integers(1, 40, n)
    score = rng.integers(-5, 80, n).astype(np.float32)
    if tie_heavy:
        a_s, b_s, ln = (a_s // 25) * 25, (b_s // 25) * 25, np.full(n, 20)
        score = (rng.integers(1, 4, n) * 10).astype(np.float32)
    ev_h, ev_st = port.event_order(b_s, b_s + ln)
    return (a_s.astype(np.int32), (a_s + ln).astype(np.int32), score, ev_h,
            ev_st)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _chaos_hits():
    rng = np.random.default_rng(123)
    base = rng.choice(list(b"ACGT"), size=4000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, len(mut), size=120)
    mut[pos] = rng.choice(list(b"ACGT"), size=120)
    hits = lagan_chaos(bytes(base), "seq1", bytes(mut), "seq2",
                       f"-s1 1 {len(base) + 1} -s2 1 {len(mut) + 1}\n",
                       12, 0, 6, 0, gfc=True, ext=True)
    assert hits
    return hits


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_sweep_plain_matches_jax(seed, tie_heavy):
    from sibelia_tpu.align.anchors_device import _sweep_device
    rng = np.random.default_rng(seed)
    s = hit_set(rng, int(rng.integers(1, 60)), tie_heavy)
    want = _sweep_device(*s)
    (got,) = port.sweep([s], CPU)
    _same_bits(got[0], want[0])
    _same_bits(got[1], want[1])
    assert got[2] == want[2]
    _same_bits(np.float32(got[3]), np.float32(want[3]))


def staircase_set(rng, n, kind):
    """hit_set's sets of the block form's sizes: random, tie-heavy, or
    every a_e equal (one tie group)."""
    s = list(hit_set(rng, n, kind == "tie-heavy", span=max(500, 4 * n)))
    if kind == "equal a_e":
        s[1] = np.full(n, 123, np.int32)
        s[0] = np.minimum(s[0], 122).astype(np.int32)
    return tuple(s)


STAIRCASE_KINDS = ["random", "tie-heavy", "equal a_e"]


@pytest.mark.parametrize("n", [33, 60, 256, 1000])
@pytest.mark.parametrize("kind", STAIRCASE_KINDS)
def test_staircase_plain_matches_jax_and_the_plain_sweep(n, kind):
    """The block form's algebra (ranks, the last alive rank below a key, a
    kill a prefix of the alive ranks) against the JAX scan and the masked
    maxima of sweep_plain, bit for bit."""
    from sibelia_tpu.align.anchors_device import _sweep_device
    s = staircase_set(np.random.default_rng(n), n, kind)
    want = _sweep_device(*s)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in s]
    offsets = np.array([0, n], np.int64)
    got = port.sweep_staircase_plain(*args, offsets)
    plain = port.sweep_plain(*args, offsets)
    for g, p in zip(got, plain):
        _same_bits(g.numpy(), p.numpy())
    _same_bits(got[0].numpy(), want[0])
    _same_bits(got[1].numpy(), want[1])
    assert int(got[2][0]) == want[2]
    _same_bits(got[3].numpy()[0], np.float32(want[3]))


def _masked_events(a_s, a_e, score, ev_hit, ev_isstart):
    """_sweep_device's steps in numpy, one set: yields (alive, sofar, end
    event of each hit, -1 before it) after every event."""
    n = len(a_s)
    sofar = np.zeros(n, np.float32)
    alive = np.zeros(n, bool)
    ended = np.full(n, -1)
    for e, (h, start) in enumerate(zip(ev_hit.tolist(), ev_isstart.tolist())):
        key = a_s[h] if start else a_e[h]
        mask = alive & (a_e < key)
        hs = np.float32(port.NEG)
        if mask.any():
            hs = sofar[mask & (a_e == a_e[mask].max())].max()
        if start:
            sofar[h] = score[h] + (hs if mask.any() and hs > 0
                                   else np.float32(0))
        else:
            ended[h] = e
            if not (mask.any() and hs > sofar[h]):
                alive &= ~((a_e >= a_e[h]) & (sofar <= sofar[h]))
                alive[h] = True
        yield alive, sofar, ended


@st.composite
def _proper_sets(draw):
    """n hits with a_e on a small grid (ties), scores with repeats, and any
    order of their 2n events in which each hit's start comes first."""
    n = draw(st.integers(1, 40))
    a_e = np.array(draw(st.lists(st.integers(0, 12), min_size=n,
                                 max_size=n)), np.int32) * 5
    a_s = a_e - np.array(draw(st.lists(st.integers(0, 20), min_size=n,
                                       max_size=n)), np.int32)
    score = np.array(draw(st.lists(st.sampled_from([-3, 0, 1, 2, 5, 10]),
                                   min_size=n, max_size=n)), np.float32)
    seq = draw(st.permutations(list(range(n)) * 2))
    seen, ev_hit, ev_st = set(), [], []
    for h in seq:
        ev_hit.append(h)
        ev_st.append(0 if h in seen else 1)
        seen.add(h)
    return (a_s, a_e, score, np.array(ev_hit, np.int32),
            np.array(ev_st, np.int32))


@settings(max_examples=150, deadline=None)
@given(_proper_sets())
@example((np.array([0, 0], np.int32), np.array([5, 5], np.int32),
          np.array([2, 1], np.float32), np.array([0, 1, 0, 1], np.int32),
          np.array([1, 1, 0, 0], np.int32)))
def test_the_staircase_invariant_holds_after_every_event(s):
    """After every event of the masked algebra: among alive hits sofar
    never falls along ascending a_e, and inside a tie group it falls
    strictly in the order of the members' end events; so sofar never
    falls along the staircase's ranks.  The staircase's algebra then gives
    sweep_plain's bits."""
    a_s, a_e, score, ev_hit, ev_isstart = s
    for alive, sofar, ended in _masked_events(*s):
        at = np.flatnonzero(alive)
        for i in at:
            later = at[a_e[at] > a_e[i]]
            assert (sofar[later] >= sofar[i]).all()
            group = at[(a_e[at] == a_e[i]) & (ended[at] > ended[i])]
            assert (sofar[group] < sofar[i]).all()
        rank = port.staircase_order(a_e, ev_hit, ev_isstart)
        ranked = rank[alive[rank]]
        assert (np.diff(sofar[ranked]) >= 0).all()
    args = [torch.from_numpy(a) for a in s]
    offsets = np.array([0, len(a_s)], np.int64)
    for g, p in zip(port.sweep_staircase_plain(*args, offsets),
                    port.sweep_plain(*args, offsets)):
        _same_bits(g.numpy(), p.numpy())


def test_sweep_refuses_events_a_hit_cannot_have():
    """The block form's precondition: one start and one later end a hit;
    sweep raises before anything goes to a device."""
    rng = np.random.default_rng(12)
    good = hit_set(rng, 40)
    a_s, a_e, score, ev_h, ev_st = (np.array(a) for a in good)
    starts = np.flatnonzero(ev_st == 1)
    late = ev_st.copy()  # hit ev_h[starts[3]] ends before it starts
    end = int(np.flatnonzero((ev_st == 0) & (ev_h == ev_h[starts[3]]))[0])
    late[starts[3]], late[end] = 0, 1
    twice = ev_h.copy()
    twice[np.flatnonzero(ev_h == 7)[0]] = 8
    outside = ev_h.copy()
    outside[0] = 40
    for eh, es in ((ev_h, late), (twice, ev_st), (outside, ev_st)):
        with pytest.raises(ValueError, match="one start event"):
            port.sweep([hit_set(rng, 3), (a_s, a_e, score, eh, es)], CPU)
    port.sweep([good], CPU)


def test_sweep_checks_only_the_block_forms_sets():
    """A set of at most WARP_HITS hits goes to the warp form, which takes
    any event order: sweep lets one whose hit ends before it starts
    through, with the JAX sweep's bits."""
    from sibelia_tpu.align.anchors_device import _sweep_device
    rng = np.random.default_rng(13)
    a_s, a_e, score, ev_h, ev_st = (np.array(a) for a in
                                    hit_set(rng, port.WARP_HITS))
    first = int(np.flatnonzero(ev_st == 1)[0])
    end = int(np.flatnonzero((ev_st == 0) & (ev_h == ev_h[first]))[0])
    ev_st[first], ev_st[end] = 0, 1
    (got,) = port.sweep([(a_s, a_e, score, ev_h, ev_st)], CPU)
    want = _sweep_device(a_s, a_e, score, ev_h, ev_st)
    _same_bits(got[0], want[0])
    _same_bits(got[1], want[1])
    assert got[2] == want[2]
    _same_bits(np.float32(got[3]), np.float32(want[3]))


def test_a_list_of_sets_equals_each_set_alone():
    rng = np.random.default_rng(31)
    sets = [hit_set(rng, n, tie) for n, tie in
            ((1, False), (37, True), (2, False), (58, False), (20, True))]
    together = port.sweep(sets, CPU)
    for s, got in zip(sets, together):
        (want,) = port.sweep([s], CPU)
        _same_bits(got[0], want[0])
        _same_bits(got[1], want[1])
        assert got[2:] == want[2:]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_text_matches_jax_and_native(seed, tie_heavy):
    from sibelia_tpu.align.anchors_device import anchors_text_device
    rng = np.random.default_rng(seed)
    text = _random_hits(rng, int(rng.integers(1, 60)), tie_heavy)
    for gfc in (False, True):
        got = port.anchors_text_device(text, gfc, CPU)
        assert got == anchors_text_device(text, gfc=gfc), (seed, gfc)
        assert got == lagan_anchors(text, gfc=gfc), (seed, gfc)


def test_gfc_chunk_expansion():
    from sibelia_tpu.align.anchors_device import anchors_text_device
    text = (_hit_line(10, 49, 12, 51, 90.0)
            + "10 12 20 55\n"
            + "31 33 19 35\n"
            + _hit_line(60, 79, 70, 89, 50.0))
    got = port.anchors_text_device(text, True, CPU)
    assert got == anchors_text_device(text, gfc=True)
    assert got == lagan_anchors(text, gfc=True)
    assert "55" in got  # chunk scores survive into the output


def test_real_chaos_output():
    from sibelia_tpu.align.anchors_device import anchors_text_device
    hits = _chaos_hits()
    for gfc in (False, True):
        got = port.anchors_text_device(hits, gfc, CPU)
        assert got == anchors_text_device(hits, gfc=gfc)
        assert got == lagan_anchors(hits, gfc=gfc)


def test_reversed_hit_goes_to_the_native_stage():
    from sibelia_tpu.align.anchors_device import anchors_text_device
    text = _hit_line(10, 30, 50, 40, 20.0) + _hit_line(40, 60, 70, 90, 20.0)
    assert anchors_text_device(text) is None
    assert port.anchors_text_device(text, True, CPU) is None


def test_empty_input_gives_empty_text():
    from sibelia_tpu.align.anchors_device import anchors_text_device
    for text in ("", "no hit here\n"):
        assert anchors_text_device(text) == ""
        assert port.anchors_text_device(text, True, CPU) == ""


def test_no_chain_above_minus_one_emits_nothing():
    from sibelia_tpu.align.anchors_device import anchors_text_device
    text = "".join(_hit_line(10 * i, 10 * i + 5, 10 * i, 10 * i + 5, -3.0)
                   for i in range(6))
    got = port.anchors_text_device(text, True, CPU)
    assert got == anchors_text_device(text) == lagan_anchors(text) == ""


def test_hits_per_sweep_are_recorded():
    before = len(port.HITS_PER_SWEEP)
    port.anchors_text_device(_random_hits(np.random.default_rng(2), 17),
                             True, CPU)
    assert port.HITS_PER_SWEEP[before:] == [17]


def _same_parse(got, want):
    if want is None:
        assert got is None
        return
    assert got[:4] == want[:4]
    assert all(type(v) is int for v in got[:4])
    assert len(got) == len(want)
    if len(want) == 5:
        _same_bits(got[4], want[4])


# a hit line as chaos and rechaos print it, and what can go wrong with one:
# other spacing, signs, exponents, a name with digits or spaces, a cut
_NUM = st.one_of(
    st.integers(0, 10 ** 7).map(str),
    st.integers(-999, 10 ** 11).map(lambda v: "%+d" % v),
    st.sampled_from(["", "-", "007", "1e3", "12x", "0x1f", "--4"]))
_SCORE = st.one_of(
    st.floats(-1e6, 1e6, allow_nan=False).map(lambda v: "%f" % v),
    st.integers(-300, 10 ** 6).map(str),
    st.sampled_from(["1.1", "1.2", ".5", "5.", "-.5", "+7.25", "1e2",
                     "1.5e-3", "3e", "nan", "", "-", "0x10"]))
_NAME = st.one_of(
    st.sampled_from(["seq1", "seq2", "ref12_340", "x", "1", "12 7", "a;b",
                     "gi|9|ref 5", " ", ""]),
    st.text("abz09_|.; \t", max_size=8))
_GAP = st.sampled_from([" ", " ", " ", "", "  ", "\t", " \t "])


@st.composite
def _hit_lines(draw):
    g = lambda: draw(_GAP)
    line = (draw(_NAME) + g() + draw(_NUM) + g() + draw(_NUM)
            + draw(st.sampled_from([";", ";", " ;", "", ","])) + g()
            + draw(_NAME) + g() + draw(_NUM) + g() + draw(_NUM)
            + draw(st.sampled_from([";", ";", " ;", ""])) + g()
            + draw(st.sampled_from(["score", "score", "scor", "Score"]))
            + g() + draw(st.sampled_from(["=", "=", "", "=="])) + g()
            + draw(_SCORE)
            + draw(st.sampled_from([" (+)", " (-)", "(+)", "", " (+) ", " x"])))
    cut = draw(st.one_of(st.none(), st.integers(0, len(line))))
    return line if cut is None else line[:cut]


@settings(max_examples=600, deadline=None)
@given(_hit_lines())
@example("seq1 0 0; seq2 0 0; score=1.1 (+)")
@example("seq1 12 340; seq2 15 343; score = 3290.000000 (+)")
@example("a 5 9 ; b 1 2 3 ; score = -.5 (-)")
@example("7 12 340; 9 15 343; score=55 (+)")
def test_fast_hit_parser_agrees_with_the_scanner(line):
    _same_parse(port.parse_hit(line), port._parse_hit(line))


@settings(max_examples=300, deadline=None)
@given(st.lists(_NUM, min_size=0, max_size=5), st.lists(_GAP, min_size=6,
                                                         max_size=6))
@example(["10", "12", "20", "55"], [""] + [" "] * 4 + [""])
@example(["10", "12", "20", "55"], [""] + [" "] * 5)
def test_fast_chunk_parser_agrees_with_the_scanner(nums, gaps):
    line = gaps[0] + "".join(n + g for n, g in zip(nums, gaps[1:]))
    _same_parse(port.parse_chunk(line), port._parse_chunk(line))


def test_the_fast_parsers_take_every_line_chaos_and_rechaos_emit(monkeypatch):
    """On the line shapes of the pipeline nothing falls to the scanner, and
    the values are the scanner's."""
    from sibelia_tpu_torch.align import lagan_exact
    lines = _chaos_hits().split("\n")
    texts = []
    real = port.anchors_text_device_batch
    monkeypatch.setattr(port, "anchors_text_device_batch",
                        lambda t, *a: texts.extend(t) or real(t, *a))
    monkeypatch.setenv("SIBELIA_TPU_ANCHORS_DEVICE", "1")
    rng = np.random.default_rng(77)
    a = rng.choice(list(b"ACGT"), size=3000).astype(np.uint8)
    b = np.concatenate([a[:1400], a[1460:]])
    lagan_exact.rechaos(bytes(a), "gi|1|ref_1", bytes(b), "ctg_2")
    for text in texts:
        lines += text.split("\n")
    hits = chunks = 0
    for line in lines:
        if port._HIT_RE.fullmatch(line):
            hits += 1
            _same_parse(port.parse_hit(line), port._parse_hit(line))
        elif port._CHUNK_RE.fullmatch(line):
            chunks += 1
            _same_parse(port.parse_chunk(line), port._parse_chunk(line))
            assert port._parse_hit(line) is None
        else:
            assert line == "", line
    assert hits > 10 and chunks > 0


def test_a_batch_of_texts_is_one_sweep_call(monkeypatch):
    """anchors_text_device_batch: every text's set in one call of sweep;
    a text without hits has no set, one that breaks the precondition comes
    back None; each text's result is what it gets alone."""
    rng = np.random.default_rng(3)
    texts = [_random_hits(rng, 9), "", _random_hits(rng, 33, True),
             _hit_line(10, 30, 50, 40, 20.0), "no hit here\n",
             _random_hits(rng, 1)]
    calls = []
    real = port.sweep
    monkeypatch.setattr(port, "sweep",
                        lambda sets, dev: calls.append(len(sets))
                        or real(sets, dev))
    before = len(port.HITS_PER_SWEEP)
    got = port.anchors_text_device_batch(texts, True, CPU)
    assert calls == [3]
    assert port.HITS_PER_SWEEP[before:] == [9, 33, 1]
    assert got[1] == got[4] == "" and got[3] is None
    assert got == [port.anchors_text_device(t, True, CPU) for t in texts]
    for t, g in zip(texts, got):
        if g is not None:
            assert g == lagan_anchors(t, gfc=True)


def test_wrapper_raises_on_an_unsupported_device_or_layout():
    s = hit_set(np.random.default_rng(0), 5)
    args = [torch.from_numpy(a) for a in s]
    off = np.array([0, 5], np.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        port.sweep_packed(*[a.to("meta") for a in args], off)
    with pytest.raises(ValueError, match="on one device"):
        port.sweep_packed(args[0].long(), *args[1:], off)
    with pytest.raises(ValueError, match="every set with a hit"):
        port.sweep_packed(*args, np.array([0, 0, 5], np.int64))


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that says it lies on a card goes to the kernel's loader,
    and a loader that fails raises: nothing gives way to sweep_plain."""
    class OnCard(torch.Tensor):
        device = torch.device("cuda", 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    def no_plain(*args):
        raise AssertionError("the plain version was taken")

    monkeypatch.setattr(port, "build", no_build)
    monkeypatch.setattr(port, "sweep_plain", no_plain)
    monkeypatch.setattr(port, "sweep_staircase_plain", no_plain)
    # the warp form (5 hits) and the block form (40)
    for n in (5, 40):
        s = hit_set(np.random.default_rng(0), n)
        args = [torch.from_numpy(a).as_subclass(OnCard) for a in s]
        with pytest.raises(RuntimeError, match="nvcc failed"):
            port.sweep_packed(*args, np.array([0, n], np.int64))


CUDA_SETS = [(1, False), (2, False), (2, True), (13, False), (32, False),
             (32, True), (33, False), (33, True), (60, True), (1000, False),
             (1000, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,tie_heavy", CUDA_SETS)
def test_cuda_kernel_matches_plain(n, tie_heavy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = hit_set(np.random.default_rng(n), n, tie_heavy, span=max(500, 4 * n))
    before = LAUNCHES.get("anchors_sweep", 0)
    (got,) = port.sweep([s], torch.device("cuda"))
    assert LAUNCHES["anchors_sweep"] == before + 1
    (want,) = port.sweep([s], CPU)
    _same_bits(got[0], want[0])
    _same_bits(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.cuda
def test_cuda_a_level_of_small_sets_is_one_launch():
    """200 sets of 1-13 hits (the shape of an exact run's level): a warp
    each, one launch; a list with larger sets too takes two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    sets = [hit_set(rng, int(n), bool(n % 4 == 0))
            for n in rng.integers(1, 14, 200)]
    for extra, launches in (([], 1), ([hit_set(rng, 33), hit_set(rng, 90)],
                                      2)):
        before = LAUNCHES.get("anchors_sweep", 0)
        got = port.sweep(sets + extra, torch.device("cuda"))
        assert LAUNCHES["anchors_sweep"] == before + launches
        for g, w in zip(got, port.sweep(sets + extra, CPU)):
            _same_bits(g[0], w[0])
            _same_bits(g[1], w[1])
            assert g[2:] == w[2:]


@pytest.mark.cuda
def test_cuda_kernel_list_of_sets_and_device_memory_form():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    sets = [hit_set(rng, n, tie, span=max(500, 4 * n)) for n, tie in
            ((1, False), (700, True), (port.SHARED_HITS + 1, False),
             (33, False))]
    offsets = np.zeros(len(sets) + 1, np.int64)
    offsets[1:] = np.cumsum([len(x[0]) for x in sets])
    args = [torch.from_numpy(np.concatenate([x[c] for x in sets])).cuda()
            for c in range(5)]
    got = port.sweep_packed(*args, offsets)
    want = port.sweep_plain(*args, offsets)
    for g, w in zip(got, want):
        _same_bits(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
def test_cuda_text_matches_native():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hits = _chaos_hits()
    for gfc in (False, True):
        assert (port.anchors_text_device(hits, gfc, torch.device("cuda"))
                == lagan_anchors(hits, gfc=gfc))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 1000, 4097])
@pytest.mark.parametrize("kind", STAIRCASE_KINDS)
def test_cuda_staircase_matches_both_plain_versions(n, kind):
    """The block form at the sizes of its shared-memory sort (33, 1000) and
    of its sort in device memory (4097), against sweep_plain and the
    staircase's own algebra."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = staircase_set(np.random.default_rng(n + 1), n, kind)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in s]
    offsets = np.array([0, n], np.int64)
    got = port.sweep_packed(*[a.cuda() for a in args], offsets)
    for want in (port.sweep_plain(*args, offsets),
                 port.sweep_staircase_plain(*args, offsets)):
        for g, w in zip(got, want):
            _same_bits(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_cuda_block_sets_of_every_layout_in_one_launch():
    """Sets whose sort runs in shared and in device memory, and one whose
    sofar lies in device memory, tie-heavy and not, in one launch beside
    small sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17)
    sets = [staircase_set(rng, n, kind) for n, kind in (
        (3, "random"), (33, "tie-heavy"), (5000, "equal a_e"),
        (port.SHARED_HITS + 1, "tie-heavy"), (4096, "random"),
        (31, "random"), (257, "equal a_e"))]
    offsets = np.zeros(len(sets) + 1, np.int64)
    offsets[1:] = np.cumsum([len(x[0]) for x in sets])
    args = [torch.from_numpy(np.concatenate([x[c] for x in sets]))
            for c in range(5)]
    before = LAUNCHES.get("anchors_sweep", 0)
    got = port.sweep_packed(*[a.cuda() for a in args], offsets)
    assert LAUNCHES["anchors_sweep"] == before + 2
    for g, w in zip(got, port.sweep_plain(*args, offsets)):
        _same_bits(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_cuda_block_form_with_four_levels_of_bits():
    """32 * 1024 + 1 hits: the bit set takes a fourth level (and lies with
    sofar in device memory), against sweep_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 32 * 1024 + 1
    s = staircase_set(np.random.default_rng(23), n, "random")
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in s]
    offsets = np.array([0, n], np.int64)
    got = port.sweep_packed(*args, offsets)
    for g, w in zip(got, port.sweep_plain(*args, offsets)):
        _same_bits(g.cpu().numpy(), w.cpu().numpy())
