"""Port vs JAX: the order stage's band DP and traceback
(``sibelia_tpu_torch/kernels/order_device.py``) against
``sibelia_tpu/kernels/order_device.py`` and the port's native
``lagan_order``, on the same seeded inputs.  Exact throughout: pointer
bytes inside the band are compared bit for bit (the traceback reads no
lane outside it), moves and ``-mfa`` texts byte for byte.  The JAX DP is a
``lax.scan`` and runs as it is on the CPU, its traceback is native; the
port runs its plain versions (``order_band_rows_plain``,
``order_moves_plain``, ``band_params_plain``) because its tensors lie on
the CPU.

JAX is imported inside the tests that compare with it, so the CUDA tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_order_device.py``."""
import numpy as np
import pytest
import torch

from test_torch_reference_libs import REFERENCE_LIBS  # noqa: F401
from sibelia_tpu_torch.align import lagan_exact as port_lagan
from sibelia_tpu_torch.core import timings
from sibelia_tpu_torch.core.platform import LAUNCHES
from sibelia_tpu_torch.kernels import order_device as port
from sibelia_tpu_torch.native import _take_string, lagan_order, load_lagan

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
    "square of 20": lambda: _unrelated_middle(1300, 20, 8),
    "square of 90": lambda: _unrelated_middle(1300, 90, 8),
}
WIDE = {"square of 20": 64, "square of 90": 128}  # their wmax


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
        if case in WIDE:
            assert (job.params[:, 6] == 1).any() and job.wmax == WIDE[case]
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


SMALL = {"nd = 2": (b"", b"A"), "nd = 3": (b"A", b"A"),
         "nd = 9": (b"ACGT", b"ACGT")}
MOVE_CASES = list(CASES) + list(SMALL)


def _case(name):
    """(seq1, seq2, anchors) of a case of CASES or SMALL."""
    if name in SMALL:
        return (*SMALL[name], "")
    sa, sb = CASES[name]()
    return sa, sb, _anchors(sa, sb)


def _walk(job, rows):
    """order_moves_plain's moves of one job over the pointer rows `rows`
    (uint8 [nd - 1, wmax])."""
    codes, params, _, table = port.pack_jobs([job])
    moves, counts = port.order_moves_plain(
        torch.from_numpy(codes), torch.from_numpy(params), table,
        torch.from_numpy(np.array(rows).reshape(-1)))
    assert moves.dtype == torch.uint8 and counts.dtype == torch.int32
    assert moves.shape == (job.nd,) and counts.shape == (1,)
    return moves.numpy()[job.nd - int(counts[0]):]


@pytest.mark.parametrize("case", MOVE_CASES)
def test_moves_plain_on_the_jax_rows_give_the_mfa_text(case):
    """The JAX scan's pointer rows, walked by the port's plain traceback
    and printed by its numpy writer: the text of the JAX package's device
    order and of native lagan_order."""
    import jax.numpy as jnp
    from sibelia_tpu.kernels import order_device as ref
    from sibelia_tpu.native import load_lagan as ref_lagan
    sa, sb, anch = _case(case)
    want_job = ref._prepare_job(ref_lagan(), sa, sb, anch, 8192)
    job = port._prepare_job(load_lagan(), sa, sb, anch, 8192)
    ref_lagan().le_order_release(want_job.handle)
    load_lagan().le_order_release(job.handle)
    run = ref._scan_fn(want_job.wmax, want_job.nd_pad)
    rows = np.asarray(run(
        jnp.asarray(want_job.s1c), jnp.asarray(want_job.s2c),
        jnp.asarray(want_job.params), *map(jnp.asarray, want_job.init))
    )[:job.nd - 1]
    moves = _walk(job, rows)
    assert set(moves.tolist()) <= {0, 1, 2, 3}
    got = port.mfa_text(job, moves, "x", "y")
    assert got == lagan_order(sa, "x", sb, "y", anch)
    assert got == ref.order_mfa_device(sa, "x", sb, "y", anch)
    if case in SMALL:
        assert job.nd == int(case.split()[-1]) and job.wmax == 16


@pytest.mark.parametrize("seed", range(6))
def test_moves_plain_equals_the_native_walk_on_any_pointer_rows(seed):
    """Pointer bytes no DP wrote send the walk astray: it stops where it
    leaves the band (an off-band stop) or at an edge, as the native walk
    over the same matrix does."""
    _native_walk_on_random_rows(
        seed, ["1500", "contig break", "neck and square"][seed % 3])


@pytest.mark.parametrize("case", list(WIDE))
def test_moves_plain_equals_the_native_walk_at_wmax_64_and_128(case):
    _native_walk_on_random_rows(WIDE[case], case)


def _native_walk_on_random_rows(seed, case):
    rng = np.random.default_rng(seed)
    sa, sb, anch = _case(case)
    lib = load_lagan()
    job = port._prepare_job(lib, sa, sb, anch, 8192)
    try:
        shape = (job.nd - 1, job.wmax)
        rows = (rng.integers(0, 3, shape)
                | (rng.integers(0, 4, shape) << 2)).astype(np.uint8)
        ptrs = np.zeros((job.nd, job.wmax), np.uint8)
        ptrs[1:] = rows
        out = lib.le_order_finish(job.handle, b"x", b"y", ptrs.ctypes.data,
                                  job.wmax)
        want = _take_string(lib, out)
    finally:
        lib.le_order_release(job.handle)
    moves = _walk(job, rows)
    assert port.mfa_text(job, moves, "x", "y") == want
    # the walk ended inside the matrix: it left the band
    used1 = int((moves != 3).sum())
    used2 = int((moves != 2).sum())
    assert used1 < len(sa) and used2 < len(sb)


def _native_text(job, rows):
    """Native lagan_order's walk over the pointer rows `rows` of a job
    (uint8 [nd - 1, wmax]): its -mfa text."""
    lib = load_lagan()
    ptrs = np.zeros((job.nd, job.wmax), np.uint8)
    ptrs[1:] = rows
    out = lib.le_order_finish(job.handle, b"x", b"y", ptrs.ctypes.data,
                              job.wmax)
    return _take_string(lib, out)


def _segment_walk(case, segment_rows, wild_seed=None):
    """The segment walk's algebra on one case's plain pointer rows (or, with
    `wild_seed`, random pointer bytes), held to order_moves_plain and to
    native lagan_order's walk over the same rows: (job, moves, trace)."""
    sa, sb, anch = _case(case)
    lib = load_lagan()
    job = port._prepare_job(lib, sa, sb, anch, 8192)
    try:
        codes, params, init, table = port.pack_jobs([job])
        codes, params, init = (torch.from_numpy(a)
                               for a in (codes, params, init))
        if wild_seed is None:
            rows = port.order_band_rows_plain(codes, params, init, table)
        else:
            rng = np.random.default_rng(wild_seed)
            n = port.rows_bytes(table)
            rows = torch.from_numpy((rng.integers(0, 3, n)
                                     | (rng.integers(0, 4, n) << 2))
                                    .astype(np.uint8))
        trace = []
        got = port.order_moves_segments_plain(codes, params, table, rows,
                                              segment_rows, trace)
        want = port.order_moves_plain(codes, params, table, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        moves = got[0].numpy()[job.nd - int(got[1][0]):]
        assert (port.mfa_text(job, moves, "x", "y")
                == _native_text(job, rows.numpy().reshape(job.nd - 1,
                                                          job.wmax)))
    finally:
        lib.le_order_release(job.handle)
    return job, moves, trace


@pytest.mark.parametrize("segment_rows", [7, 33])
def test_segment_walk_crosses_edges_by_a_diagonal_over_the_edge_row(
        segment_rows):
    """The DP's own walk through segments of 7 and 33 rows (a diagonal step
    goes two rows down, so odd sizes meet the edges in both parities):
    some segments are entered on the row below their top one, by a
    diagonal step over it; every segment below the top is entered once,
    in order."""
    job, moves, trace = _segment_walk("1500", segment_rows)
    assert sum(code >> 5 == 3 for _, _, code, _, _ in trace) > 5
    ks = [k for _, k, _, _, _ in trace]
    assert ks == list(range(ks[0], ks[0] - len(ks), -1))
    assert ks[0] == (job.nd - 2) // segment_rows
    assert sum(steps for _, _, _, steps, _ in trace) == len(moves)


@pytest.mark.parametrize("seed,segment_rows", [(3, 5), (4, 64), (5, 32)])
def test_segment_walk_stops_off_the_band_inside_a_segment(seed,
                                                          segment_rows):
    """Random pointer bytes send the walk off the band: it stops inside a
    segment above row 0 (no exit code), as the native walk does."""
    job, moves, trace = _segment_walk("contig break", segment_rows, seed)
    _, k, _, steps, exit_ = trace[-1]
    assert exit_ == port.WALK_STOP and k > 0 and steps > 0
    assert int((moves != 3).sum()) < job.nd // 2


@pytest.mark.parametrize("segment_rows", [3, 7])
def test_segment_walk_reaches_diagonal_1(segment_rows):
    """ACGT against ACGT: all matches, the walk's last step leaves (1, 1)
    from diagonal 1, in the bottom segment, after entering segments on
    the row below their top."""
    job, moves, trace = _segment_walk("nd = 9", segment_rows)
    assert moves.tolist() == [1, 1, 1, 1, 1]
    assert trace[-1][1] == 0 and any(c >> 5 == 3 for _, _, c, _, _ in trace)


@pytest.mark.parametrize("case", list(SMALL) + ["1500"])
def test_segment_walk_of_pairs_shorter_than_a_segment(case):
    """A pair of fewer rows than a segment is its top segment alone,
    entered at the walk's start only."""
    job, _, trace = _segment_walk(case, 4096)
    assert job.nd - 1 < 4096
    assert len(trace) == 1 and trace[0][1] == 0


def test_segment_walk_of_a_ragged_batch_of_several_segments_a_pair():
    """The batch's narrow pairs, in segments of 96 rows, on random pointer
    bytes and on their own DP's rows: the walk of each pair."""
    prepared, args, table = _packed(_batch_jobs())
    keep = np.flatnonzero(table[:, port.T_WMAX] <= 32)
    prepared = [prepared[i] for i in keep]
    table = port.sub_table(table, keep)
    rng = np.random.default_rng(44)
    n = port.rows_bytes(table)
    wild = torch.from_numpy((rng.integers(0, 3, n)
                             | (rng.integers(0, 4, n) << 2)).astype(np.uint8))
    for rows in (wild, port.order_band_rows_plain(*args, table)):
        trace = []
        got = port.order_moves_segments_plain(args[0], args[1], table, rows,
                                              96, trace)
        want = port.order_moves_plain(args[0], args[1], table, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len({b for b, *_ in trace}) == len(prepared)
    assert min(job.nd for job in prepared) > 4 * 96


@pytest.mark.parametrize("case", MOVE_CASES)
def test_band_params_plain_equals_the_columns_of_prepare_job(case):
    sa, sb, anch = _case(case)
    lib = load_lagan()
    jobs = [port._prepare_job(lib, sa, sb, anch, 8192),
            port._prepare_job(lib, sb, sa,
                              "" if case in SMALL else _anchors(sb, sa),
                              8192)]
    for job in jobs:
        lib.le_order_release(job.handle)
    _, band, _, table = port.pack_bands(jobs)
    _, params, _, same = port.pack_jobs(jobs)
    assert np.array_equal(table, same)
    got = port.band_params(torch.from_numpy(band), table)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), params)


def test_order_moves_is_one_pass_of_the_three_wrappers(monkeypatch):
    """A batch goes through band_params, band_rows and band_moves once
    each, and what comes back is counted in ROW_BYTES: the moves and their
    counts, not the pointer rows."""
    jobs = _batch_jobs()[:3]
    calls = []
    for name in ("band_params", "band_rows", "band_moves"):
        real = getattr(port, name)
        monkeypatch.setattr(
            port, name, lambda *a, _n=name, _r=real: calls.append(_n)
            or _r(*a))
    before = port.ROW_BYTES[0]
    got = port.order_mfa_device_batch(jobs, CPU)
    assert calls == ["band_params", "band_rows", "band_moves"]
    assert got == [lagan_order(*job) for job in jobs]
    lib = load_lagan()
    prepared = [port._prepare_job(lib, j[0], j[2], j[4], 8192) for j in jobs]
    for job in prepared:
        lib.le_order_release(job.handle)
    assert port.ROW_BYTES[0] - before == sum(j.nd + 4 for j in prepared)
    assert port.ROW_BYTES[0] - before < sum(
        (j.nd - 1) * j.wmax for j in prepared) // 10


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


def test_a_card_batch_holds_what_half_its_memory_holds(monkeypatch):
    """On a card the pairs of a call go up together as far as half of what
    the card gives holds them and BATCH_DIAGONALS allows, whatever
    BATCH_ROW_BYTES says; on the CPU (no budget) BATCH_ROW_BYTES alone cuts
    them."""
    lib = load_lagan()
    jobs = [port._prepare_job(lib, *j[::2], 8192) for j in _batch_jobs()]
    for job in jobs:
        lib.le_order_release(job.handle)
    card = [port.card_bytes_of(j) for j in jobs]
    diags = [j.nd - 1 for j in jobs]
    monkeypatch.setattr(port, "BATCH_ROW_BYTES", 1)
    assert [len(b) for b in port._batches(jobs)] == [1] * 6
    assert [len(b) for b in port._batches(jobs, sum(card))] == [6]
    # the 256-lane pair (its rows and twice as many bytes of words) alone
    assert [len(b) for b in port._batches(jobs, sum(card[:4]))] == [4, 1, 1]
    monkeypatch.setattr(port, "BATCH_DIAGONALS", sum(diags[:3]))
    assert [len(b) for b in port._batches(jobs, sum(card))] == [3, 3]
    monkeypatch.setattr(port, "card_free_bytes", lambda dev: 2 * sum(card))
    assert port._card_budget(CPU) == sum(card)


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
    before = port.get_stats()["device_jobs"]
    counted = timings._ACC.get("order_device_jobs", 0)
    assert caller._batch_align_unique(annotated, 1, CPU) == want
    assert port.get_stats()["device_jobs"] == before + 1
    # the run's record counts the band DP (the trace line is gone)
    assert timings._ACC["order_device_jobs"] == counted + 1
    assert "order device coverage" not in capsys.readouterr().err
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
    for name in ("order_band_rows_plain", "order_moves_plain",
                 "order_moves_segments_plain", "band_params_plain"):
        monkeypatch.setattr(port, name, no_plain)
    # a narrow pair (the segment walk) and a wide one
    for jobs in (_batch_jobs()[:1], _batch_jobs()[5:]):
        prepared, args, table = _packed(jobs)
        on_card = [a.as_subclass(OnCard) for a in args]
        rows = torch.zeros(port.rows_bytes(table),
                           dtype=torch.uint8).as_subclass(OnCard)
        band = torch.from_numpy(port.pack_bands(prepared)[1])
        for call in (lambda: port.band_rows(*on_card, table),
                     lambda: port.band_moves(on_card[0], on_card[1], table,
                                             rows),
                     lambda: port.band_params(band.as_subclass(OnCard),
                                              table)):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                call()


def _cuda_same_inside_the_band(jobs):
    """The three kernels against their plain versions on one batch."""
    prepared, args, table = _packed(jobs)
    args = [a.cuda() for a in args]
    before = {k: LAUNCHES.get(k, 0)
              for k in ("order_band", "order_moves", "band_params")}
    rows = port.band_rows(*args, table)
    got = rows.cpu().numpy()
    moves, counts = port.band_moves(args[0], args[1], table, rows)
    params = port.band_params(
        torch.from_numpy(port.pack_bands(prepared)[1]).cuda(), table)
    torch.cuda.synchronize()
    classes = len({job.wmax for job in prepared})
    assert LAUNCHES["order_band"] == before["order_band"] + classes
    assert LAUNCHES["order_moves"] == before["order_moves"] + classes
    assert LAUNCHES["band_params"] == before["band_params"] + 1
    assert torch.equal(params, args[1])
    want_moves, want_counts = port.order_moves_plain(args[0], args[1], table,
                                                     rows)
    assert torch.equal(counts, want_counts)
    for b, job in enumerate(prepared):
        end = int(table[b, port.T_MOVES]) + job.nd
        lo = end - int(counts[b])
        assert torch.equal(moves[lo:end], want_moves[lo:end]), b
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
def test_cuda_register_form_on_more_pairs_than_a_block_has_warps():
    """Eleven ragged pairs of wmax 16 and 32 (a warp each, four a block),
    and the smallest bands there are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(41)
    jobs = []
    for n in rng.integers(200, 2500, 11).tolist():
        sa, sb = _pair(rng, n, max(1, n // 100), n % 4)
        jobs.append((sa, "a", sb, "b", _anchors(sa, sb)))
    jobs += [(a, "a", b, "b", "") for a, b in SMALL.values()]
    prepared, _, _ = _packed(jobs)
    assert {job.wmax for job in prepared} <= {16, 32}
    _cuda_same_inside_the_band(jobs)
    assert (port.order_mfa_device_batch(jobs, torch.device("cuda"))
            == [lagan_order(*job) for job in jobs])


@pytest.mark.cuda
def test_cuda_traceback_matches_plain_on_any_pointer_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(43)
    _, args, table = _packed(_batch_jobs())
    args = [a.cuda() for a in args]
    n = port.rows_bytes(table)
    rows = torch.from_numpy((rng.integers(0, 3, n)
                             | (rng.integers(0, 4, n) << 2)).astype(np.uint8)
                            ).cuda()
    moves, counts = port.band_moves(args[0], args[1], table, rows)
    want_moves, want_counts = port.order_moves_plain(args[0], args[1], table,
                                                     rows)
    assert torch.equal(counts, want_counts)
    for b in range(table.shape[0]):
        end = int(table[b, port.T_MOVES] + table[b, port.T_DIAGS] + 1)
        lo = end - int(counts[b])
        assert torch.equal(moves[lo:end], want_moves[lo:end]), b


@pytest.mark.cuda
@pytest.mark.parametrize("segment_rows", [32, 96, 1024])
def test_cuda_segment_walk_matches_plain_on_a_ragged_batch(segment_rows,
                                                          monkeypatch):
    """The three kernels of the narrow walk, in segments of 32, 96 and 1024
    rows (several a pair, and pairs under one), on the batch's DP rows and
    on random pointer bytes, with a wide pair beside them: moves and counts
    of every pair as order_moves_plain's, each class one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(port, "WALK_SEGMENT_ROWS", segment_rows)
    rng = np.random.default_rng(segment_rows)
    jobs = _batch_jobs() + [(a, "a", b, "b", "") for a, b in SMALL.values()]
    prepared, args, table = _packed(jobs)
    assert {job.wmax for job in prepared} == {16, 32, 256}
    args = [a.cuda() for a in args]
    n = port.rows_bytes(table)
    wild = torch.from_numpy((rng.integers(0, 3, n)
                             | (rng.integers(0, 4, n) << 2)).astype(np.uint8))
    for rows in (port.band_rows(*args, table), wild.cuda()):
        before = LAUNCHES.get("order_moves", 0)
        moves, counts = port.band_moves(args[0], args[1], table, rows)
        assert LAUNCHES["order_moves"] == before + 3
        want, want_counts = port.order_moves_plain(args[0], args[1], table,
                                                   rows)
        assert torch.equal(counts, want_counts)
        for b in range(table.shape[0]):
            end = int(table[b, port.T_MOVES] + table[b, port.T_DIAGS] + 1)
            lo = end - int(counts[b])
            assert torch.equal(moves[lo:end], want[lo:end]), b


@pytest.mark.cuda
@pytest.mark.parametrize("middle", [600, 5000, 150])
def test_cuda_kernel_matches_plain_on_a_wide_band(middle):
    """One warp holds a 256-lane band (middle 150), a block of warps a
    1024-lane one, the shared-memory form an 8192-lane one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sa, sb = _unrelated_middle(2000, middle, middle)
    jobs = [(sa, "x", sb, "y", _anchors(sa, sb))]
    prepared, _, _ = _packed(jobs)
    assert prepared[0].wmax == {150: 256, 600: 1024, 5000: 8192}[middle]
    _cuda_same_inside_the_band(jobs)
    assert (port.order_mfa_device(*jobs[0], torch.device("cuda"))
            == lagan_order(*jobs[0]))


@pytest.mark.cuda
def test_cuda_wide_pairs_side_by_side_in_one_launch():
    """Three pairs of wmax 1024 and two of 128, each class one launch of a
    block a pair, against the plain versions; the text through
    order_mfa_device_batch as native lagan_order's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jobs = []
    for i, middle in enumerate((600, 700, 900, 60, 90)):
        sa, sb = _unrelated_middle(1200 + 100 * i, middle, 30 + i)
        jobs.append((sa, "x", sb, "y", _anchors(sa, sb)))
    prepared, _, _ = _packed(jobs)
    assert sorted(job.wmax for job in prepared) == [128] * 2 + [1024] * 3
    _cuda_same_inside_the_band(jobs)
    before = LAUNCHES.get("order_band", 0)
    assert (port.order_mfa_device_batch(jobs, torch.device("cuda"))
            == [lagan_order(*job) for job in jobs])
    assert LAUNCHES["order_band"] == before + 2


@pytest.mark.cuda
def test_cuda_wide_walk_crosses_its_windows():
    """Walks over a band the size of the matrix (no anchors, wmax 4096):
    the DP's own pointers from corner to corner, and random ones, whose
    lanes leave every slice a window holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(47)
    a = bytes(rng.choice(ACGT, size=2600).astype(np.uint8))
    b = bytes(rng.choice(ACGT, size=3100).astype(np.uint8))
    jobs = [(a, "x", b, "y", ""), (b[:900], "x", a, "y", "")]
    prepared, args, table = _packed(jobs)
    assert [job.wmax for job in prepared] == [4096, 1024]
    args = [t.cuda() for t in args]
    n = port.rows_bytes(table)
    wild = torch.from_numpy((rng.integers(0, 3, n)
                             | (rng.integers(0, 4, n) << 2)).astype(np.uint8))
    for rows in (port.band_rows(*args, table), wild.cuda()):
        moves, counts = port.band_moves(args[0], args[1], table, rows)
        want, want_counts = port.order_moves_plain(args[0], args[1], table,
                                                   rows)
        assert torch.equal(counts, want_counts)
        assert int(counts.min()) > 600
        for i in range(table.shape[0]):
            end = int(table[i, port.T_MOVES] + table[i, port.T_DIAGS] + 1)
            lo = end - int(counts[i])
            assert torch.equal(moves[lo:end], want[lo:end]), i
