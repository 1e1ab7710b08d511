"""Port vs JAX: the order stage's band DP
(``sibelia_tpu_torch/kernels/order_device.py``) against
``sibelia_tpu/kernels/order_device.py`` and the port's native
``lagan_order``, on the same seeded inputs.  Exact throughout: pointer
bytes inside the band are compared bit for bit (``le_order_finish`` reads no
lane outside it), ``-mfa`` texts byte for byte.  The JAX DP is a
``lax.scan`` and runs as it is on the CPU; the port runs its plain version
(``order_band_rows_plain``) because its tensors lie on the CPU.

JAX is imported inside the tests that compare with it, so the CUDA tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_order_device.py``."""
import numpy as np
import pytest
import torch

from sibelia_tpu_torch.align import lagan_exact as port_lagan
from sibelia_tpu_torch.core.platform import LAUNCHES
from sibelia_tpu_torch.kernels import order_device as port
from sibelia_tpu_torch.native import lagan_order, load_lagan

CPU = torch.device("cpu")
ACGT = list(b"ACGT")


def _pair(rng, n, muts, indel=0):
    """The generator of tests/test_order_device.py."""
    a = rng.choice(ACGT, size=n).astype(np.uint8)
    b = a.copy()
    pos = rng.integers(0, len(b), size=muts)
    b[pos] = rng.choice(ACGT, size=muts)
    if indel:
        b = np.concatenate([b[:n // 3], b[n // 3 + indel:]])
    return bytes(a), bytes(b)


def _n_chars():
    sa, sb = _pair(np.random.default_rng(5), 3000, 25, 3)
    return sa[:400] + b"N" * 30 + sa[430:], sb


def _contig_break():
    sa, sb = _pair(np.random.default_rng(6), 2400, 20, 0)
    return sa[:900] + b"." + sa[900:], sb[:1500] + b"." + sb[1500:]


def _unrelated_middle(n=1300, middle=300, seed=8):
    """Two sequences alike but for an unrelated stretch in the middle: a
    wide square between two anchors, necks either side."""
    rng = np.random.default_rng(seed)
    sa, sb = _pair(rng, n, n // 100, 0)
    at = n // 2
    return (sa[:at] + bytes(rng.choice(ACGT, size=middle).astype(np.uint8))
            + sa[at:],
            sb[:at] + bytes(rng.choice(ACGT, size=middle + 17)
                            .astype(np.uint8)) + sb[at:])


CASES = {
    "1500": lambda: _pair(np.random.default_rng(0), 1500, 15, 0),
    "4000 indel 7": lambda: _pair(np.random.default_rng(1), 4000, 60, 7),
    "9000 indel 120": lambda: _pair(np.random.default_rng(2), 9000, 40, 120),
    "N characters": _n_chars,
    "contig break": _contig_break,
    "neck and square": _unrelated_middle,
}


def _anchors(sa, sb):
    return port_lagan.rechaos(sa, "x", sb, "y", gfc=True)


def _inband(job):
    return np.arange(job.wmax)[None, :] < job.params[:, 0:1]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_rows_match_the_jax_scan_inside_the_band(case):
    import jax.numpy as jnp
    from sibelia_tpu.kernels import order_device as ref
    from sibelia_tpu.native import load_lagan as ref_lagan
    sa, sb = CASES[case]()
    anch = _anchors(sa, sb)
    want_job = ref._prepare_job(ref_lagan(), sa, sb, anch, 8192)
    job = port._prepare_job(load_lagan(), sa, sb, anch, 8192)
    try:
        assert (job.nd, job.wmax) == (want_job.nd, want_job.wmax)
        run = ref._scan_fn(want_job.wmax, want_job.nd_pad)
        want = np.asarray(run(
            jnp.asarray(want_job.s1c), jnp.asarray(want_job.s2c),
            jnp.asarray(want_job.params), *map(jnp.asarray, want_job.init))
        )[:job.nd - 1]
        (got,) = port.order_band_rows([job], CPU)
        assert got.dtype == np.uint8 and got.shape == want.shape
        mask = _inband(job)
        assert mask.sum() > job.nd
        assert np.array_equal(got[mask], want[mask])
        if case == "neck and square":
            assert (job.params[:, 6] == 1).any() and job.wmax >= 256
    finally:
        ref_lagan().le_order_release(want_job.handle)
        load_lagan().le_order_release(job.handle)


@pytest.mark.parametrize("case", list(CASES))
def test_mfa_text_matches_jax_and_native(case):
    from sibelia_tpu.kernels.order_device import order_mfa_device
    sa, sb = CASES[case]()
    anch = _anchors(sa, sb)
    got = port.order_mfa_device(sa, "x", sb, "y", anch, CPU)
    assert got is not None
    assert got == lagan_order(sa, "x", sb, "y", anch)
    assert got == order_mfa_device(sa, "x", sb, "y", anch)


def _batch_jobs():
    rng = np.random.default_rng(9)
    jobs = []
    for i in range(5):
        sa, sb = _pair(rng, 2000 + 150 * i, 20, i % 3)
        jobs.append((sa, "a", sb, "b", _anchors(sa, sb)))
    sa, sb = _unrelated_middle(900, 120, 3)  # another band width
    jobs.append((sa, "a", sb, "b", _anchors(sa, sb)))
    return jobs


def test_batch_matches_jax_and_native():
    from sibelia_tpu.kernels.order_device import order_mfa_device_batch
    jobs = _batch_jobs()
    got = port.order_mfa_device_batch(jobs, CPU)
    assert got == order_mfa_device_batch(jobs)
    assert got == [lagan_order(*job) for job in jobs]


def test_batches_are_cut_by_row_bytes(monkeypatch):
    sa, sb = _pair(np.random.default_rng(4), 600, 6, 2)
    jobs = [(sa, "a", sb, "b", _anchors(sa, sb)), (b"ACGT", "a", b"ACGT", "b",
                                                   ""),
            (sb, "a", sa, "b", _anchors(sb, sa))]
    want = port.order_mfa_device_batch(jobs, CPU)
    calls = []
    band_rows = port.band_rows
    monkeypatch.setattr(port, "band_rows",
                        lambda *a: calls.append(a[3].shape[0]) or band_rows(*a))
    monkeypatch.setattr(port, "BATCH_ROW_BYTES", 1)  # one pair a batch
    assert port.order_mfa_device_batch(jobs, CPU) == want
    assert calls == [1, 1, 1]


def test_a_band_over_the_width_goes_to_the_host_on_both_sides():
    from sibelia_tpu.kernels import order_device as ref
    sa, sb = CASES["4000 indel 7"]()
    anch = _anchors(sa, sb)
    before, ref_before = port.get_stats(), ref.get_stats()
    assert port.order_mfa_device(sa, "x", sb, "y", anch, CPU, 8) is None
    assert ref.order_mfa_device(sa, "x", sb, "y", anch, 8) is None
    after, ref_after = port.get_stats(), ref.get_stats()
    for a, b in ((before, after), (ref_before, ref_after)):
        assert b["host_fallback"] == a["host_fallback"] + 1
        assert b["device_jobs"] == a["device_jobs"]


def test_device_jobs_rise():
    """As tests/test_device_e2e.py::test_alignment_device_share_nonzero."""
    rng = np.random.default_rng(17)
    before = port.get_stats()
    jobs = []
    for i in range(3):
        a = rng.choice(ACGT, size=1200 + 80 * i).astype(np.uint8)
        b = a.copy()
        p = rng.integers(0, len(b), size=10)
        b[p] = rng.choice(ACGT, size=10)
        jobs.append((bytes(a), "r", bytes(b), "q",
                     port_lagan.rechaos(bytes(a), "r", bytes(b), "q")))
    rows = port.order_mfa_device_batch(jobs, CPU)
    after = port.get_stats()
    assert rows == [lagan_order(*job) for job in jobs]
    assert after["device_jobs"] == before["device_jobs"] + 3
    assert after["host_fallback"] == before["host_fallback"]


@pytest.mark.parametrize("order", ["1", "0"])
def test_routing_in_lagan_pl_mfa(monkeypatch, order):
    """The switch decides whether the band DP reaches the device module,
    and the text is the same either way."""
    sa, sb = _pair(np.random.default_rng(13), 2500, 30, 11)
    monkeypatch.delenv("SIBELIA_TPU_DEVICE_ORDER", raising=False)
    want = port_lagan.lagan_pl_mfa(sa, "p", sb, "q")
    before = port.get_stats()["device_jobs"]
    monkeypatch.setenv("SIBELIA_TPU_DEVICE_ORDER", order)
    assert port_lagan.lagan_pl_mfa(sa, "p", sb, "q", CPU) == want
    assert port.get_stats()["device_jobs"] == before + int(order)


def test_align_pairs_exact_batch_matches_jax(monkeypatch):
    from sibelia_tpu.align import lagan_exact as ref_lagan
    monkeypatch.setenv("SIBELIA_TPU_ANCHORS_DEVICE", "1")
    rng = np.random.default_rng(21)
    pairs = [(*_pair(rng, 1100 + 90 * i, 12, 2 * i), f"r{i}", f"q{i}")
             for i in range(3)]
    got = port_lagan.align_pairs_exact_batch(pairs, 2, CPU)
    assert got == ref_lagan.align_pairs_exact_batch(pairs, 2)
    assert got == [port_lagan.align_pair_exact(*p) for p in pairs]


def test_batch_align_unique_takes_the_device_path_and_traces(monkeypatch,
                                                             capsys):
    from sibelia_tpu_torch.variants import caller
    sa, sb = _pair(np.random.default_rng(23), 900, 9, 4)

    def block(seq, chr_id):
        return caller.SyntenyBlock(seq.decode(), chr_id, "+", 7, 1, len(seq),
                                   1, len(seq))

    annotated = [(True, 7, [block(sa, "ref"), block(sb, "asm")]),
                 (False, 8, [])]
    monkeypatch.delenv("SIBELIA_TPU_DEVICE_ORDER", raising=False)
    want = {7: port_lagan.align_pair_exact(sa, sb)}  # the native stages
    monkeypatch.setenv("SIBELIA_TPU_DEVICE_ORDER", "1")
    monkeypatch.setenv("SIBELIA_TPU_TRACE", "1")
    before = port.get_stats()["device_jobs"]
    assert caller._batch_align_unique(annotated, 1, CPU) == want
    assert port.get_stats()["device_jobs"] == before + 1
    assert "order device coverage" in capsys.readouterr().err
    # a serial run with the band DP on the host has nothing to pre-align
    monkeypatch.setenv("SIBELIA_TPU_DEVICE_ORDER", "0")
    assert caller._batch_align_unique(annotated, 1, CPU) == {}
    assert capsys.readouterr().err == ""


def _packed(jobs):
    lib = load_lagan()
    prepared = [port._prepare_job(lib, j[0], j[2], j[4], 8192) for j in jobs]
    for job in prepared:
        lib.le_order_release(job.handle)
    codes, params, init, table = port.pack_jobs(prepared)
    return prepared, [torch.from_numpy(a) for a in (codes, params, init)], table


def test_wrapper_raises_on_an_unsupported_device_or_layout():
    _, args, table = _packed(_batch_jobs()[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        port.band_rows(*[a.to("meta") for a in args], table)
    with pytest.raises(ValueError, match="on one device"):
        port.band_rows(args[0].int(), args[1], args[2], table)
    with pytest.raises(ValueError, match="table must be"):
        port.band_rows(*args, table[:, :5])
    bad = table.copy()
    bad[0, port.T_WMAX] = 48
    with pytest.raises(ValueError, match="power of two"):
        port.band_rows(*args, bad)


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that says it lies on a card goes to the kernel's loader,
    and a loader that fails raises: nothing gives way to the plain version
    or to the native engine."""
    class OnCard(torch.Tensor):
        device = torch.device("cuda", 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    def no_plain(*args):
        raise AssertionError("the plain version was taken")

    monkeypatch.setattr(port, "build", no_build)
    monkeypatch.setattr(port, "order_band_rows_plain", no_plain)
    _, args, table = _packed(_batch_jobs()[:1])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        port.band_rows(*[a.as_subclass(OnCard) for a in args], table)


def _cuda_same_inside_the_band(jobs):
    prepared, args, table = _packed(jobs)
    args = [a.cuda() for a in args]
    before = LAUNCHES.get("order_band", 0)
    got = port.band_rows(*args, table).cpu().numpy()
    torch.cuda.synchronize()
    classes = len({job.wmax for job in prepared})
    assert LAUNCHES["order_band"] == before + classes
    want = port.order_band_rows_plain(*args, table).cpu().numpy()
    for b, job in enumerate(prepared):
        lo = int(table[b, port.T_ROWS])
        shape = (job.nd - 1, job.wmax)
        mask = _inband(job)
        g = got[lo:lo + mask.size].reshape(shape)
        w = want[lo:lo + mask.size].reshape(shape)
        assert np.array_equal(g[mask], w[mask]), b


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sa, sb = CASES[case]()
    _cuda_same_inside_the_band([(sa, "x", sb, "y", _anchors(sa, sb))])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_a_ragged_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _cuda_same_inside_the_band(_batch_jobs())


@pytest.mark.cuda
@pytest.mark.parametrize("middle", [600, 5000])
def test_cuda_kernel_matches_plain_on_a_wide_band(middle):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sa, sb = _unrelated_middle(2000, middle, middle)
    jobs = [(sa, "x", sb, "y", _anchors(sa, sb))]
    prepared, _, _ = _packed(jobs)
    assert prepared[0].wmax == (1024 if middle == 600 else 8192)
    _cuda_same_inside_the_band(jobs)
    assert (port.order_mfa_device(*jobs[0], torch.device("cuda"))
            == lagan_order(*jobs[0]))
