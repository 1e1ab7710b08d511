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
    s = hit_set(np.random.default_rng(0), 5)
    args = [torch.from_numpy(a).as_subclass(OnCard) for a in s]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        port.sweep_packed(*args, np.array([0, 5], np.int64))


CUDA_SETS = [(1, False), (2, False), (2, True), (60, True), (1000, False),
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
