"""Block generation's native edge table and overlap claims
(``native/blocks.cpp`` through ``blocks/synteny.py``) against the port's
Python route (``SIBELIA_TPU_NATIVE=0``).

The table equals ``list_edges``, the ``original_length >= min_size``
filter, ``group_by`` by the natural key, the groups' size ``std_sort`` and
each group's direction ``std_sort`` (``core/stdsort.py``) in every column,
in the groups' bounds and order and in each group's direction order: on
the e2e fixture's chromosomes, indexed at k = 15, 30 and 500, and on
synthetic tables of heavy ties whose listed order is a median-of-3 killer
(McIlroy's adversary run on ``core/stdsort.py``), so that the introsort
falls back to its heap sort in the key sort and in the size sort.
``resolve_overlap``'s native claims equal its numpy rule on random groups
over partly occupied arrays, and one C-Sibelia Sibelia stage writes the
same files with the library and without it."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import faults
from sibelia_tpu_torch import native
from sibelia_tpu_torch.blocks import synteny
from sibelia_tpu_torch.blocks.edges import Edge, list_edges
from sibelia_tpu_torch.blocks.finder import BlockFinder
from sibelia_tpu_torch.core import stdsort, timings
from sibelia_tpu_torch.core.glibc_rand import GlibcRand
from sibelia_tpu_torch.core.platform import Routes
from sibelia_tpu_torch.graph.bifstore import BifStore
from sibelia_tpu_torch.graph.indexed import build_index
from sibelia_tpu_torch.graph.sequence import MutableSequence
from sibelia_tpu_torch.io.fasta import FASTARecord, read_fasta
from tests.test_device_e2e import REPO_ROOT, _write_fixture
from tests.test_torch_cli_e2e import _tree, write_pair_fixture

CPU = torch.device("cpu")


def _python_table(seq, store, k, min_size):
    """The Python route's table: the edges in their final order and the
    groups' bounds, as generate_synteny_blocks ordered them before."""
    edges = [e for e in list_edges(seq, store, k)
             if e.original_length >= min_size]
    groups = stdsort.group_by(edges, synteny._cmp_edges_naturally)
    stdsort.std_sort(groups, lambda a, b: (a[1] - a[0]) > (b[1] - b[0]))
    for g0, g1 in groups:
        seg = edges[g0:g1]
        stdsort.std_sort(seg, synteny._cmp_edges_by_direction)
        edges[g0:g1] = seg
    return edges, groups


def _assert_tables_equal(seq, store, k, min_size):
    want_edges, want_groups = _python_table(seq, store, k, min_size)
    cols, bounds = native.edge_table(seq.chars, seq.origpos, store.bif_at,
                                     store.node_bif, k, min_size)
    assert [dt for dt in (c.dtype for c in cols)] == [
        np.dtype(dt) for _, dt in native.EDGE_COLUMNS]
    got_edges = [Edge(*row) for row in zip(*(c.tolist() for c in cols))]
    assert got_edges == want_edges
    assert [tuple(b) for b in bounds.tolist()] == want_groups
    return want_edges, want_groups


def _edge_groups(monkeypatch, seq, store, k, min_size, native_on):
    if not native_on:
        monkeypatch.setenv("SIBELIA_TPU_NATIVE", "0")
    timings.reset()
    got = synteny.edge_groups(seq, store, k, min_size)
    monkeypatch.delenv("SIBELIA_TPU_NATIVE", raising=False)
    return got, timings.snapshot()


def _fixture_index(tmp_path, k, simplified):
    """The e2e fixture's three chromosomes with N and IUPAC codes planted,
    indexed at k on the CPU, after its first simplification stage or
    before any."""
    fa, _ = _write_fixture(tmp_path)
    recs = []
    read_fasta(str(fa), recs)
    rng = np.random.default_rng(4)
    out = []
    for r in recs:
        s = bytearray(r.sequence.encode())
        for i in rng.integers(0, len(s), size=25):
            s[i] = ord(rng.choice(list("NNNRY")))
        out.append(FASTARecord(s.decode(), r.description, r.id))
    finder = BlockFinder(out, Routes.of(CPU))
    if simplified:
        finder.perform_graph_simplifications(10, 60, 4)
    seq = MutableSequence(finder.raw_seq, finder.original_pos)
    return seq, build_index(seq, k, GlibcRand(5), CPU)


@pytest.mark.parametrize("simplified", [False, True])
@pytest.mark.parametrize("k,min_size", [(15, 0), (15, 100), (30, 100),
                                        (30, 500), (500, 100)])
def test_table_matches_python_on_the_fixture(tmp_path, monkeypatch, k,
                                             min_size, simplified):
    seq, store = _fixture_index(tmp_path, k, simplified)
    edges, groups = _assert_tables_equal(seq, store, k, min_size)
    assert len(groups) > 1
    (n_groups, want), py_record = _edge_groups(monkeypatch, seq, store, k,
                                              min_size, False)
    (got_groups, got), record = _edge_groups(monkeypatch, seq, store, k,
                                             min_size, True)
    assert got_groups == n_groups == len(groups)
    assert got == want
    # the groups that can make a block: two edges or more, one positive
    assert [j for j, _ in got] == [
        j for j, (g0, g1) in enumerate(groups)
        if g1 - g0 > 1 and edges[g0].direction == 0]
    assert record["edge_table_rows"] == len(edges)
    assert "edge_table_rows" not in py_record


def _killer(n):
    """McIlroy's adversary against core/stdsort.py's introsort: values of
    n items (the unfrozen ones tied at n) on which it partitions badly."""
    val = [n] * n
    state = {"candidate": 0, "solid": 0}

    def less(x, y):
        if val[x] == n and val[y] == n:
            z = x if x == state["candidate"] else y
            val[z] = state["solid"]
            state["solid"] += 1
        if val[x] == n:
            state["candidate"] = x
        elif val[y] == n:
            state["candidate"] = y
        return val[x] < val[y]

    stdsort.std_sort(list(range(n)), less)
    return val


def _synthetic(listed):
    """A sequence and a store whose edge list is `listed`: (start vertex,
    end vertex, direction, original length of 1 or 2), the edges of
    direction 0 first, each edge alone on its strand of a chromosome of 4
    bases at k = 2 (a mark at its walk's begin and one a base on), whose
    first char is A on either strand."""
    assert [d for _, _, d, _ in listed] == sorted(d for _, _, d, _ in listed)
    n_chr = max(sum(d == s for _, _, d, _ in listed) for s in (0, 1))
    chars = [np.frombuffer(b"GTAC", np.uint8).copy() for _ in range(n_chr)]
    origpos = [np.arange(4, dtype=np.int32) for _ in range(n_chr)]
    seq = MutableSequence(chars, origpos)
    store = BifStore(seq, 0)
    store._grow(2 * len(listed))
    fill = [0, 0]
    node = 0
    for sv, ev, d, olen in listed:
        c = fill[d]
        fill[d] += 1
        for coord, v in zip((0, 1) if d == 0 else (3, 2), (sv, ev)):
            store.bif_at[d][c][coord] = node
            store.node_bif[node] = v
            node += 1
        if olen == 1:  # both ends (k-mer at 0 and 1) at one position
            seq.origpos[c][[0, 2] if d == 0 else [1, 3]] = 7
    store.n_nodes = node
    return seq, store


def _heap_sorts(monkeypatch):
    calls = []
    heap_sort = stdsort._heap_sort

    def counted(arr, first, last, cmp):
        calls.append(last - first)
        heap_sort(arr, first, last, cmp)
    monkeypatch.setattr(stdsort, "_heap_sort", counted)
    return calls


def _keys_case():
    """1,500 edges whose start vertices, in list order, are the killer's
    values (the first 750 positive), groups of one edge all of one size,
    and among them 15 edges that the filter leaves out."""
    vals = _killer(1500)
    rng = np.random.default_rng(1)
    listed = [(v, 7, int(i >= 750), 2) for i, v in enumerate(vals)]
    for at in sorted(rng.integers(0, len(listed), 15).tolist(), reverse=True):
        listed.insert(at, (int(rng.integers(0, 1500)), 7,
                           listed[at][2], 1))
    return listed


def _sizes_case():
    """150 groups whose sizes, in key order, are the killer's values for
    the size sort's greater-than (1 to 151 edges), the edges listed in a
    random order, each group's of both directions."""
    vals = _killer(150)
    rng = np.random.default_rng(2)
    listed = [(j, 3, int(rng.integers(0, 2)), 2)
              for j, v in enumerate(vals) for _ in range(151 - v)]
    listed = [listed[i] for i in rng.permutation(len(listed))]
    return sorted(listed, key=lambda e: e[2])


@pytest.mark.parametrize("case", ["keys", "sizes"])
def test_table_matches_python_on_heavy_ties(monkeypatch, case):
    listed = _keys_case() if case == "keys" else _sizes_case()
    seq, store = _synthetic(listed)
    heap = _heap_sorts(monkeypatch)
    edges, groups = _assert_tables_equal(seq, store, 2, 2)
    # the Python route's introsort fell back to its heap sort (in the key
    # sort over every edge, or in the size sort over the groups) on more
    # than the insertion sort's 16 elements
    assert heap and max(heap) > 16
    sizes = [g1 - g0 for g0, g1 in groups]
    if case == "keys":
        # a thousand groups tied on their size, some edges filtered out
        assert len(sizes) - len(set(sizes)) > 1000
        assert len(edges) < len(listed)
    else:
        # groups of tied keys with both directions beyond 16 edges
        assert max(sizes) > 16
        assert {e.direction for e in edges[groups[0][0]:groups[0][1]]} == {
            0, 1}
    (_, want), _ = _edge_groups(monkeypatch, seq, store, 2, 2, False)
    (_, got), _ = _edge_groups(monkeypatch, seq, store, 2, 2, True)
    assert got == want


@pytest.mark.parametrize("n_groups", [0, 1, 49, 50, 51, 149, 2600, 60674])
def test_progress_dots_as_when_every_group_was_visited(n_groups):
    """The bar's calls, and where they fall among the groups that trim, as
    the loop over every group made them (one a n_groups // 50 groups)."""
    rng = np.random.default_rng(n_groups)
    can = sorted(set(rng.integers(0, max(1, n_groups), n_groups // 3)
                     .tolist())) if n_groups else []
    trims = set(can)
    want, p_count, p_prog = [], 0, 0
    p_thresh = max(1, n_groups // 50)
    for j in range(n_groups):
        p_count += 1
        if p_count >= p_thresh:
            p_count = 0
            p_prog = min(p_prog + 1, 50)
            want.append((p_prog, 1))
        if j in trims:
            want.append(("group", j))
    got, done = [], 0
    for j in can:
        synteny._dots(lambda *a: got.append(a), p_thresh, done, j + 1)
        done = j + 1
        got.append(("group", j))
    synteny._dots(lambda *a: got.append(a), p_thresh, done, n_groups)
    assert got == want


def _claims(monkeypatch, group, min_size, overlap, native_on):
    if not native_on:
        monkeypatch.setenv("SIBELIA_TPU_NATIVE", "0")
    timings.reset()
    before = [o.copy() for o in overlap]
    got = synteny.resolve_overlap(group, min_size, overlap)
    monkeypatch.delenv("SIBELIA_TPU_NATIVE", raising=False)
    for a, b in zip(overlap, before):
        np.testing.assert_array_equal(a, b)  # read, never written
    return got, timings.snapshot()


def _edge(c, start, length, direction=0):
    return Edge(c, direction, 11, 12, 5, length, start, length, ord("G"))


# (occupancy of each chromosome as (lo, hi) runs, min_size, edges as
# (chromosome, start, length))
CLAIMS = {
    # two free runs of 50 in the span: the first wins
    "two equal runs": ([[(100, 120)], []], 40,
                       [(0, 50, 120), (1, 0, 60)]),
    # the second and third edges overlap the first's claim on chromosome 0
    "claims overlapping in one group": ([[(300, 310)], []], 20,
                                        [(0, 100, 150), (0, 180, 200),
                                         (0, 120, 60), (1, 10, 30)]),
    "min_size exactly met": ([[(0, 40), (90, 200)], []], 50,
                             [(0, 0, 150), (0, 30, 60)]),
    "min_size missed by one": ([[(0, 41), (90, 200)], []], 50,
                               [(0, 0, 150)]),
    # a span that ends at its chromosome's end, and one that runs past it
    # (as numpy's slice, cut at the end)
    "at a chromosome's end": ([[], [(0, 900)]], 30,
                              [(1, 950, 50), (0, 960, 100), (1, 880, 300)]),
    "nothing free": ([[(0, 1000)], [(0, 1000)]], 1,
                     [(0, 0, 1000), (1, 200, 300)]),
    "min_size 0": ([[(0, 1000)], []], 0, [(0, 10, 20), (1, 10, 20)]),
}


def _occupancy(runs):
    overlap = [np.zeros(1000, np.int8) for _ in runs]
    for o, rs in zip(overlap, runs):
        for lo, hi in rs:
            o[lo:hi] = synteny.POS_OCCUPIED
    return overlap


@pytest.mark.parametrize("name", list(CLAIMS))
def test_native_claims_match_numpy(monkeypatch, name):
    runs, min_size, spans = CLAIMS[name]
    group = [_edge(c, s, n, i % 2) for i, (c, s, n) in enumerate(spans)]
    overlap = _occupancy(runs)
    want, py_record = _claims(monkeypatch, group, min_size, overlap, False)
    got, record = _claims(monkeypatch, group, min_size, overlap, True)
    assert got == want
    assert record["overlap_native_calls"] == 1
    assert "overlap_native_calls" not in py_record


@pytest.mark.parametrize("seed", range(8))
def test_native_claims_match_numpy_at_random(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    overlap = [np.zeros(int(n), np.int8) for n in rng.integers(500, 3000, 4)]
    for o in overlap:
        for lo in rng.integers(0, o.size, 12):
            o[lo:lo + int(rng.integers(1, 200))] = synteny.POS_OCCUPIED
    for _ in range(40):
        group = []
        for _ in range(int(rng.integers(1, 7))):
            c = int(rng.integers(0, len(overlap)))
            start = int(rng.integers(0, overlap[c].size))
            group.append(_edge(c, start, int(rng.integers(1, 900)),
                               int(rng.integers(0, 2))))
        min_size = int(rng.integers(0, 120))
        want, _ = _claims(monkeypatch, group, min_size, overlap, False)
        got, _ = _claims(monkeypatch, group, min_size, overlap, True)
        assert got == want


def test_overlap_fault_still_patches_resolve_overlap(tmp_path, monkeypatch):
    """portbench's control fault replaces resolve_overlap by name; block
    generation calls it through the module, every call a native one."""
    seq, store = _fixture_index(tmp_path, 15, True)
    finder = BlockFinder([FASTARecord(s.tobytes().decode(), f"c{i}", f"c{i}")
                          for i, s in enumerate(seq.chars)], Routes.of(CPU))
    seen = []
    resolve = synteny.resolve_overlap

    def counted(group, min_size, overlap):
        seen.append(any(o.any() for o in overlap))
        return resolve(group, min_size, overlap)
    monkeypatch.setattr(synteny, "resolve_overlap", counted)
    timings.reset()
    with faults.overlap_unresolved():
        finder.generate_synteny_blocks(15, 10, 100)
    # the fault hands every claim an empty occupancy
    assert len(seen) > 1 and not any(seen)
    assert timings.snapshot()["overlap_native_calls"] == len(seen)


def _stage(pair, outdir, timings_path, native_on):
    """C-Sibelia's Sibelia stage (cli/csibelia.py::_sibelia_argv's
    arguments) on the pair, in a process of its own."""
    env = dict(os.environ, SIBELIA_TPU_TORCH_DEVICE="cpu",
               SIBELIA_TPU_TIMINGS=str(timings_path))
    if not native_on:
        env["SIBELIA_TPU_NATIVE"] = "0"
    r = subprocess.run(
        [sys.executable, "-m", "sibelia_tpu_torch.cli.sibelia",
         *map(str, pair), "-q", "--correctboundaries", "--nopostprocess",
         "--allstages", "--lastk", "30", "-m", "500", "-o", str(outdir),
         "-s", "fine", "-i", "4", "-r"],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return _tree(outdir), json.loads(timings_path.read_text())


def test_csibelia_stage_same_files_with_and_without_the_library(tmp_path):
    pair = write_pair_fixture(tmp_path)
    got, record = _stage(pair, tmp_path / "native", tmp_path / "n.json",
                         True)
    want, py_record = _stage(pair, tmp_path / "python", tmp_path / "p.json",
                             False)
    assert got == want and got
    assert record["edge_table_rows"] > 0
    assert record["overlap_native_calls"] > 0
    for name in ("edge_table_rows", "overlap_native_calls"):
        assert name not in py_record, name
