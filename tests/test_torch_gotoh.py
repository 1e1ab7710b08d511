"""Port vs JAX: the batched Gotoh alignment of the fast aligner's gaps.

The port's plain planes (sibelia_tpu_torch/kernels/gotoh.py) against the
JAX vmap formulation (sibelia_tpu/kernels/gotoh.py) and the Pallas kernel
in interpret mode, all four planes; the port's plain aligned rows and
lengths against ``batch_align_pallas`` in interpret mode, the host
``_gotoh`` and the port's own ``traceback_from_dirs``; the port's
``batch_align`` against the host ``_gotoh``; the kernel's 5-class score
table against ``_SM`` and its four bits a cell against the planes; and the
CUDA kernel against the plain versions on the card.  The DP is integer:
exact equality throughout.

JAX is imported inside the tests that compare with it, so the CUDA test
also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_gotoh.py``."""
import numpy as np
import pytest
import torch

from sibelia_tpu.variants.aligner import _SM, _gotoh
from sibelia_tpu_torch.core.platform import LAUNCHES
from sibelia_tpu_torch.kernels.gotoh import (batch_align, batch_align_rows,
                                             batch_align_rows_plain,
                                             batched_gotoh_dirs,
                                             batched_gotoh_dirs_plain,
                                             pack_codes, score_classes,
                                             traceback_from_dirs, unpack_dirs)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MIXED = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)  # N and lowercase


def _mutate(rng, a, alpha, T):
    """A related sequence: substitutions, deletions and insertions,
    kept within 1..T bytes."""
    b = list(a)
    for _ in range(max(1, len(b) // 10)):
        i = int(rng.integers(0, len(b)))
        op = int(rng.integers(0, 3))
        if op == 0:
            b[i] = int(rng.choice(alpha))
        elif op == 1 and len(b) > 1:
            del b[i]
        elif len(b) < T:
            b.insert(i, int(rng.choice(alpha)))
    return bytes(b)


def _pairs(seed: int, B: int, T: int) -> list[tuple[bytes, bytes]]:
    """Related and unrelated pairs of lengths 1..T: every fourth pair is
    n = m = T with substitutions only, every fourth holds N and
    lowercase bytes."""
    rng = np.random.default_rng(seed)
    pairs = []
    for x in range(B):
        kind = x % 4
        alpha = MIXED if kind == 3 else ACGT
        n = T if kind == 0 else int(rng.integers(1, T + 1))
        a = bytes(alpha[rng.integers(0, len(alpha), n)])
        if kind == 0:
            b = bytearray(a)
            for i in rng.integers(0, n, max(1, n // 10)):
                b[i] = int(rng.choice(alpha))
            b = bytes(b)
        elif kind == 1 or (kind == 3 and rng.random() < 0.5):
            b = _mutate(rng, a, alpha, T)
        else:
            m = int(rng.integers(1, T + 1))
            b = bytes(alpha[rng.integers(0, len(alpha), m)])
        pairs.append((a, b))
    return pairs


# exact score ties between alignments: the traceback's tie order decides
TIES = [(b"AA", b"A"), (b"ACA", b"AA"), (b"TTTT", b"TT"),
        (b"GATTACA", b"GATACA"), (b"ACGTACGT", b"ACGT")]


def _planes(pairs, T, device="cpu"):
    codes = torch.from_numpy(pack_codes(pairs, T)).to(device)
    return codes[0], codes[1]


@pytest.mark.parametrize("T,B", [(16, 8), (16, 64), (128, 8), (128, 64)])
def test_plain_matches_jax_vmap(T, B):
    import jax.numpy as jnp

    from sibelia_tpu.kernels.gotoh import batched_gotoh_dirs as jax_dirs
    a, b = _planes(_pairs(T + B, B, T), T)
    want = jax_dirs(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), T)
    got = batched_gotoh_dirs_plain(a, b, T)
    assert got.dtype == torch.int8 and got.shape == (4, B, T, T)
    for plane, ref in zip(got.numpy(), want):
        np.testing.assert_array_equal(plane, np.asarray(ref).astype(np.int8))


@pytest.mark.parametrize("T,B", [(16, 8), (16, 64), (128, 8), (128, 64)])
def test_plain_matches_pallas_interpret(T, B):
    import jax.numpy as jnp

    from sibelia_tpu.kernels.gotoh_pallas import batched_gotoh_dirs_pallas
    a, b = _planes(_pairs(2 * T + B, B, T), T)
    want = batched_gotoh_dirs_pallas(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy()), T, True)
    got = batched_gotoh_dirs_plain(a, b, T)
    for plane, ref in zip(got.numpy(), want):
        np.testing.assert_array_equal(plane, np.asarray(ref))


def _assert_rows_match_host(pairs, T):
    got = batch_align(pairs, T, torch.device("cpu"))
    assert len(got) == len(pairs)
    for (a, b), rows in zip(pairs, got):
        assert rows == _gotoh(a, b), (a, b)


def test_batch_align_matches_host_gotoh():
    _assert_rows_match_host(_pairs(0, 40, 128), 128)


EDGE_CASES = ["length 1", "n = m = T", "N, lowercase", "ties"]


def _edge_pairs(case: str, T: int = 128) -> list[tuple[bytes, bytes]]:
    rng = np.random.default_rng(7)
    full = bytes(ACGT[rng.integers(0, 4, T)])
    other = bytes(MIXED[rng.integers(0, len(MIXED), T)])
    return {
        "length 1": [(b"A", b"A"), (b"A", b"C"), (b"G", full[:50]),
                     (full[:50], b"T"), (b"N", b"n")],
        "n = m = T": [(full, full), (full, full[::-1]),
                      (full, bytes(ACGT[rng.integers(0, 4, T)]))],
        "N, lowercase": [(b"ACGTNNNNACGT", b"ACGTACGT"),
                         (b"acgtACGT", b"ACGTacgt"), (b"NNNN", b"NN"),
                         (full[:60] + b"nnnn" + full[60:120],
                          full[:60] + full[64:124])],
        "ties": TIES,
        "1 x T": [(b"A", full), (b"C", other), (b"n", full)],
        "T x 1": [(full, b"G"), (other, b"T"), (full, b"N")],
        "1 x 1": [(b"A", b"A"), (b"A", b"C"), (b"N", b"N"), (b"a", b"A")],
        "unrelated": [
            (bytes(ACGT[rng.integers(0, 4, int(rng.integers(1, T + 1)))]),
             bytes(ACGT[rng.integers(0, 4, int(rng.integers(1, T + 1)))]))
            for _ in range(12)],
    }[case]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_batch_align_edge_cases(case):
    _assert_rows_match_host(_edge_pairs(case), 128)


def _rows(pairs, T, device="cpu", fn=batch_align_rows_plain):
    """[(row of a, row of b)] from the tensors of batch_align_rows."""
    a, b = _planes(pairs, T, device)
    lens = torch.tensor([[len(x) for x, _ in pairs],
                         [len(y) for _, y in pairs]], dtype=torch.int32,
                        device=device)
    rows, lengths = fn(a, b, lens, T)
    assert rows.dtype == torch.uint8 and rows.shape == (len(pairs), 2, 2 * T)
    assert lengths.dtype == torch.int32 and lengths.shape == (len(pairs),)
    rows, lengths = rows.cpu().numpy(), lengths.cpu().numpy()
    return [(bytes(r[0, :L]).decode(), bytes(r[1, :L]).decode())
            for r, L in zip(rows, lengths)]


@pytest.mark.parametrize("T,B", [(16, 8), (16, 64), (128, 8), (128, 64)])
def test_plain_rows_match_pallas_interpret_and_host(T, B):
    from sibelia_tpu.kernels.gotoh_pallas import batch_align_pallas
    pairs = _pairs(3 * T + B, B, T) + [p for p in TIES if len(p[0]) <= T]
    got = _rows(pairs, T)
    assert got == batch_align_pallas(pairs, T, interpret=True)
    assert got == [_gotoh(a, b) for a, b in pairs]


@pytest.mark.parametrize("case", EDGE_CASES + ["1 x T", "T x 1", "1 x 1",
                                              "unrelated", "random"])
def test_plain_rows_match_traceback_from_dirs(case):
    T = 128
    pairs = _pairs(11, 24, T) if case == "random" else _edge_pairs(case)
    a, b = _planes(pairs, T)
    planes = batched_gotoh_dirs_plain(a, b, T).numpy()
    want = [traceback_from_dirs(x, y, *planes[:, at])
            for at, (x, y) in enumerate(pairs)]
    assert _rows(pairs, T) == want
    assert batch_align(pairs, T, torch.device("cpu")) == want


def test_plain_rows_are_zero_past_each_length():
    pairs = _pairs(5, 9, 16)
    a, b = _planes(pairs, 16)
    lens = torch.tensor([[len(x) for x, _ in pairs],
                         [len(y) for _, y in pairs]], dtype=torch.int32)
    rows, lengths = batch_align_rows_plain(a, b, lens, 16)
    past = torch.arange(32)[None, None, :] >= lengths[:, None, None]
    assert int((rows * past).max()) == 0
    assert bool((lengths >= lens.max(0).values).all())
    assert bool((lengths <= lens.sum(0)).all())


def _pack_dirs(planes: torch.Tensor) -> torch.Tensor:
    """The kernel's byte a cell from the four planes (csrc/gotoh.cu):
    cell_state, ix_open, and iy_open of the cell to the right (0 past the
    last column, which nothing reads)."""
    m_choice, ix_open, iy_open, cell_state = planes.to(torch.uint8)
    right = torch.zeros_like(iy_open)
    right[:, :, :-1] = iy_open[:, :, 1:]
    return cell_state | (ix_open << 2) | (right << 3)


def test_unpack_dirs_round_trips_all_36_combinations():
    """Any cell_state, ix_open and right-shifted iy_open planes, with
    m_choice and iy_open laid out as the DP lays them out: every legal
    (m_choice, ix_open, iy_open, cell_state) occurs and comes back."""
    rng = np.random.default_rng(36)
    B, T = 3, 24
    planes = torch.zeros((4, B, T, T), dtype=torch.int8)
    planes[3] = torch.from_numpy(rng.integers(0, 3, (B, T, T)))
    planes[1] = torch.from_numpy(rng.integers(0, 2, (B, T, T)))
    planes[2, :, :, 1:] = torch.from_numpy(rng.integers(0, 2, (B, T, T - 1)))
    planes[0, :, 0, :] = 2
    planes[0, :, :, 0] = 1
    planes[0, :, 0, 0] = 0
    planes[0, :, 1:, 1:] = planes[3, :, :-1, :-1]
    combos = {tuple(c) for c in planes.reshape(4, -1).T.tolist()}
    assert len(combos) == 36
    packed = _pack_dirs(planes)
    assert packed.dtype == torch.uint8 and int(packed.max()) < 16
    assert torch.equal(unpack_dirs(packed), planes)


@pytest.mark.parametrize("T,B", [(16, 8), (128, 8)])
def test_unpack_dirs_restores_the_plain_planes(T, B):
    a, b = _planes(_pairs(T - B, B, T) + TIES, T)
    planes = batched_gotoh_dirs_plain(a, b, T)
    assert torch.equal(unpack_dirs(_pack_dirs(planes)), planes)


def test_pack_codes_pads_with_zeros():
    pairs = _pairs(1, 10, 16)
    codes = pack_codes(pairs, 16)
    assert codes.shape == (2, 10, 16) and codes.dtype == np.uint8
    for at, pair in enumerate(pairs):
        for side in (0, 1):
            want = np.zeros(16, dtype=np.uint8)
            want[:len(pair[side])] = np.frombuffer(pair[side], dtype=np.uint8)
            np.testing.assert_array_equal(codes[side, at], want)


def _rows_args(T=16, B=4):
    codes = torch.zeros((B, T), dtype=torch.uint8)
    return codes, codes.clone(), torch.ones((2, B), dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("a length of 0", "outside 1..16"),
    ("a length above T", "outside 1..16"),
    ("lens on another device", "on the codes' device"),
    ("codes on two devices", "on one device"),
    ("int64 lens", "contiguous int32"),
    ("lens not contiguous", "contiguous int32"),
    ("codes not contiguous", "contiguous uint8"),
    ("T above 128", "outside 1..128"),
    ("an unsupported device", "unsupported device"),
])
def test_rows_wrapper_raises(case, match):
    T = 16
    a, b, lens = _rows_args(T)
    if case == "a length of 0":
        lens[1, 2] = 0
    elif case == "a length above T":
        lens[0, 3] = T + 1
    elif case == "lens on another device":
        lens = lens.to("meta")
    elif case == "codes on two devices":
        b = b.to("meta")
    elif case == "int64 lens":
        lens = lens.long()
    elif case == "lens not contiguous":
        lens = torch.ones((4, 2), dtype=torch.int32).T
    elif case == "codes not contiguous":
        a = torch.zeros((T, 4), dtype=torch.uint8).T
    elif case == "T above 128":
        T = 129
        a, b, lens = _rows_args(T)
    else:
        a, b, lens = a.to("meta"), b.to("meta"), lens.to("meta")
    with pytest.raises(ValueError, match=match):
        batch_align_rows(a, b, lens, T)


@pytest.mark.parametrize("pair", [(b"", b"A"), (b"A", b""), (b"A" * 17, b"A")])
def test_batch_align_raises_on_a_length_outside_1_to_T(pair):
    with pytest.raises(ValueError, match="outside 1..16"):
        batch_align([(b"AC", b"AG"), pair], 16, torch.device("cpu"))


def test_cpu_rows_take_the_plain_version():
    pairs = _pairs(3, 5, 16)
    before = dict(LAUNCHES)
    got = _rows(pairs, 16, fn=batch_align_rows)
    assert LAUNCHES == before
    assert got == [_gotoh(a, b) for a, b in pairs]


def test_score_classes_match_sm_over_all_byte_pairs():
    byte_class, class_score = score_classes()
    assert byte_class.shape == (256,) and class_score.shape == (5, 5)
    x = np.arange(256)
    np.testing.assert_array_equal(
        class_score[byte_class[x][:, None], byte_class[x][None, :]], _SM)


def test_cpu_tensors_take_the_plain_version():
    a, b = _planes(_pairs(3, 5, 16), 16)
    before = dict(LAUNCHES)
    batched_gotoh_dirs(a, b, 16)
    assert LAUNCHES == before


def test_wrapper_raises_on_an_unsupported_device():
    codes = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        batched_gotoh_dirs(codes, codes, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 128), (7, 128), (8, 128), (1000, 128),
                                 (64, 16), (64, 37)])
def test_cuda_kernel_matches_plain(B, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pairs = _pairs(B + T, B, T) + TIES
    a, b = _planes(pairs, T, "cuda")
    got = batched_gotoh_dirs(a, b, T)
    want = batched_gotoh_dirs_plain(a, b, T)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_128_columns():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codes = torch.zeros((2, 129), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="outside 1..128"):
        batched_gotoh_dirs(codes, codes, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(16, 8), (16, 64), (128, 8), (128, 64)])
def test_cuda_rows_match_pallas_interpret_and_host(T, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pairs = _pairs(3 * T + B, B, T) + [p for p in TIES if len(p[0]) <= T]
    before = LAUNCHES.get("gotoh_align", 0)
    got = _rows(pairs, T, "cuda", batch_align_rows)
    assert LAUNCHES["gotoh_align"] == before + 1
    assert got == _rows(pairs, T, "cuda")
    assert got == [_gotoh(a, b) for a, b in pairs]
    assert got == batch_align(pairs, T, torch.device("cuda"))
    try:
        from sibelia_tpu.kernels.gotoh_pallas import batch_align_pallas
    except ImportError:  # no JAX beside the card
        return
    assert got == batch_align_pallas(pairs, T, interpret=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES + ["1 x T", "T x 1", "1 x 1",
                                              "unrelated"])
def test_cuda_rows_edge_cases(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pairs = _edge_pairs(case)
    assert _rows(pairs, 128, "cuda", batch_align_rows) == _rows(pairs, 128)


@pytest.mark.cuda
def test_cuda_rows_wrapper_raises_on_a_cpu_cuda_mix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, b, lens = _rows_args()
    with pytest.raises(ValueError, match="on the codes' device"):
        batch_align_rows(a.cuda(), b.cuda(), lens, 16)
    with pytest.raises(ValueError, match="on one device"):
        batch_align_rows(a.cuda(), b, lens.cuda(), 16)
