"""Native (C++) host engines of the port, built from the sources beside
this file.

Copies of the loaders and ctypes wrappers of ``sibelia_tpu/native/__init__.py``
over the port's own copies of the sources: the simplification engine
(``engine.cpp``, with block generation's trim rounds, ``trim.cpp``, and
its edge table and overlap claims, ``blocks.cpp``), the k-mer ranking and
host enumeration (``ranking.cpp``) and the LAGAN stage primitives
(``lagan_*.cpp``).  Each library is built with
g++ at first use into ``native/build/`` (rebuilt when a source is newer) with
the JAX package's compile flags, and loaded with ctypes.  A build or load
that fails raises: there is no Python engine to take its place, and the
port never loads a library built elsewhere.  The engine runs through
``engine_runner.simplify``, which installs the port's device re-prefilter
(unless ``SIBELIA_TPU_WAVE_DEVICE=0``).
The ranking library is loaded ``RTLD_GLOBAL`` (and before the engine), so
that the engine's ``dlsym(RTLD_DEFAULT, "rank_slab_alloc")`` finds the
arena slab that ``slab_reserve`` maps; its linker version script
(``ranking.map``) exports the C API alone, so that no other name of it
takes the place of the engine's or the LAGAN library's own.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")

_LIBS: dict[str, ctypes.CDLL] = {}

# native progress hook (PutProgressChr twin; engine.cpp ProgressFn)
PROGRESS_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_longlong, ctypes.c_int)
REPREFILTER_CFUNC = ctypes.CFUNCTYPE(ctypes.c_longlong,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_longlong)


def _native_off() -> bool:
    """``SIBELIA_TPU_NATIVE=0``: no native library, the Python engines."""
    return os.environ.get("SIBELIA_TPU_NATIVE", "1") == "0"


def _build(name: str, flags: list[str], sources: list[str],
           headers: tuple[str, ...] = (),
           mode: int = ctypes.DEFAULT_MODE) -> ctypes.CDLL:
    """Compile BUILD_DIR/<name> from `sources` (file names beside this
    module) when it is missing or older than a source or header, and load
    it with dlopen `mode`.  Raises RuntimeError when g++ fails or the
    library does not load."""
    so = os.path.join(BUILD_DIR, name)
    srcs = [os.path.join(_DIR, f) for f in sources]
    newest = max(os.path.getmtime(os.path.join(_DIR, f))
                 for f in (*sources, *headers))
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *flags, "-o", tmp, *srcs], check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed on {srcs}:\n{e.stderr}") from e
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {so}: {e}") from e
        os.replace(tmp, so)
    try:
        return ctypes.CDLL(so, mode=mode)
    except OSError as e:
        raise RuntimeError(f"cannot load {so}: {e}") from e


def load() -> ctypes.CDLL | None:
    """The simplification engine library (engine.cpp); None when
    SIBELIA_TPU_NATIVE=0."""
    if _native_off():
        return None
    lib = _LIBS.get("engine")
    if lib is not None:
        return lib
    # the engine caches its dlsym of rank_slab_alloc at its first
    # allocation: the ranking library must be in the global scope first
    load_ranking()
    lib = _build("libsibelia_engine.so",
                 ["-O3", "-march=native", "-ffp-contract=off", "-shared",
                  "-fPIC"], ["engine.cpp", "trim.cpp", "blocks.cpp"])
    lib.engine_create.restype = ctypes.c_void_p
    lib.engine_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.engine_set_bifs.restype = None
    lib.engine_set_bifs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.engine_simplify_sparse.restype = ctypes.c_int64
    lib.engine_simplify_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.engine_simplify.restype = ctypes.c_int64
    lib.engine_simplify.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64]
    lib.engine_set_progress.restype = None
    lib.engine_set_progress.argtypes = [ctypes.c_void_p, PROGRESS_CFUNC]
    lib.engine_chr_len.restype = ctypes.c_int64
    lib.engine_chr_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.engine_get_chr.restype = None
    lib.engine_get_chr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.engine_destroy.restype = None
    lib.engine_destroy.argtypes = [ctypes.c_void_p]
    lib.radix_argsort_u64.restype = None
    lib.radix_argsort_u64.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]
    lib.engine_set_reprefilter.restype = None
    lib.engine_set_reprefilter.argtypes = [ctypes.c_void_p,
                                           REPREFILTER_CFUNC]
    lib.engine_sweep_stats.restype = ctypes.c_int
    lib.engine_sweep_stats.argtypes = [ctypes.c_void_p] * 3
    lib.engine_live_node_count.restype = ctypes.c_int64
    lib.engine_live_node_count.argtypes = [ctypes.c_void_p]
    lib.engine_export_nodes.restype = None
    lib.engine_export_nodes.argtypes = [ctypes.c_void_p] * 5
    lib.engine_export_chars.restype = None
    lib.engine_export_chars.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.trim_round.restype = ctypes.c_longlong
    lib.trim_round.argtypes = [ptr, ptr, ptr, ctypes.c_int, i64, i64, ptr]
    lib.trim_walk.restype = ctypes.c_longlong
    lib.trim_walk.argtypes = [ptr, ptr, ctypes.c_int, i64, i64, i64,
                              i64, ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr]
    lib.trim_enum.restype = ctypes.c_longlong
    lib.trim_enum.argtypes = [ptr, ptr, ctypes.c_int, i64, *[ptr] * 7]
    lib.edge_table.restype = ctypes.c_longlong
    lib.edge_table.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, i64, ptr,
                               ptr, i64, i64, ptr]
    lib.edge_table_fetch.restype = None
    lib.edge_table_fetch.argtypes = [ptr] * 10
    lib.overlap_claims.restype = ctypes.c_longlong
    lib.overlap_claims.argtypes = [ctypes.c_int, ptr, i64, ptr]
    _LIBS["engine"] = lib
    return lib


def radix_argsort(keys: np.ndarray) -> np.ndarray | None:
    """Stable argsort of a uint64 key array via the native radix sort;
    None when the library is off."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype=np.int64)
    lib.radix_argsort_u64(keys.ctypes.data, len(keys), out.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# Trim rounds of small blocks (trim.cpp)
# ---------------------------------------------------------------------------

def trim_round(chars: np.ndarray, lens: np.ndarray, dirs: np.ndarray,
               k: int, min_size: int):
    """One round of ``blocks/synteny.py::trim_blocks`` over a block's copies
    laid end to end in `chars` (uint8, ambiguous bases already drawn), with
    their lengths (int64) and directions (int8): the enumeration at k and
    the walk in one call.  Returns (drop, out): out[i] = (kept, new start
    within copy i, new length).  None when the library is off."""
    lib = load()
    if lib is None:
        return None
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    if chars.size != lens.sum() or dirs.size != lens.size:
        raise ValueError("trim_round: copies, lengths and directions differ")
    out = np.empty((len(lens), 3), dtype=np.int64)
    drop = lib.trim_round(chars.ctypes.data, lens.ctypes.data,
                          dirs.ctypes.data, len(lens), k, min_size,
                          out.ctypes.data)
    return bool(drop), out


def trim_walk(enum, lens: np.ndarray, dirs: np.ndarray, k: int,
              min_size: int):
    """``trim_round``'s walk alone over a BifEnumeration of the copies made
    elsewhere (the card's); the same (drop, out).  None when the library is
    off."""
    lib = load()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    arrs = []
    for s in (0, 1):
        chrs = np.ascontiguousarray(enum.chr[s], dtype=np.int64)
        poss = np.ascontiguousarray(enum.pos[s], dtype=np.int64)
        ids = np.ascontiguousarray(enum.bif_id[s], dtype=np.uint32)
        # the walk indexes its tables by id and copy
        if chrs.size and not (ids.max() < enum.count
                              and 0 <= chrs.min() and chrs.max() < lens.size
                              and 0 <= poss.min()
                              and (poss < lens[chrs]).all()):
            raise ValueError("trim_walk: an instance outside the copies or "
                             "the enumeration's ids")
        arrs += [chrs, poss, ids]
    if dirs.size != lens.size:
        raise ValueError("trim_walk: lengths and directions differ")
    out = np.empty((len(lens), 3), dtype=np.int64)
    drop = lib.trim_walk(lens.ctypes.data, dirs.ctypes.data, len(lens), k,
                         min_size, enum.count,
                         len(arrs[0]), *(a.ctypes.data for a in arrs[:3]),
                         len(arrs[3]), *(a.ctypes.data for a in arrs[3:]),
                         out.ctypes.data)
    return bool(drop), out


def trim_enum(chars: np.ndarray, lens: np.ndarray, k: int):
    """``trim_round``'s enumeration alone: (count, [(chr, pos, id)] * 2),
    chr and pos int64, id uint32, per strand sorted by (chr, pos); None
    when the library is off."""
    lib = load()
    if lib is None:
        return None
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    cap = int(lens.sum())
    if chars.size != cap:
        raise ValueError("trim_enum: copies and lengths differ")
    arrs = [np.empty(cap, dtype=dt) for _ in (0, 1)
            for dt in (np.int64, np.int64, np.uint32)]
    sizes = np.zeros(2, dtype=np.int64)
    count = lib.trim_enum(chars.ctypes.data, lens.ctypes.data, len(lens), k,
                          *(a.ctypes.data for a in arrs), sizes.ctypes.data)
    return int(count), [tuple(a[:sizes[s]] for a in arrs[3 * s:3 * s + 3])
                        for s in (0, 1)]


# ---------------------------------------------------------------------------
# Block generation's edge table and overlap claims (blocks.cpp)
# ---------------------------------------------------------------------------

# the edge table's columns, in blocks/edges.py::Edge's field order
EDGE_COLUMNS = (("chr", np.int32), ("direction", np.int8),
                ("start_vertex", np.int64), ("end_vertex", np.int64),
                ("actual_position", np.int64), ("actual_length", np.int64),
                ("original_position", np.int64),
                ("original_length", np.int64), ("first_char", np.uint8))


def _pointers(arrays: list[np.ndarray]):
    return (ctypes.c_void_p * max(1, len(arrays)))(
        *(a.ctypes.data for a in arrays))


def edge_table(chars: list[np.ndarray], origpos: list[np.ndarray],
               bif_at: list[list[np.ndarray]], node_bif: np.ndarray,
               k: int, min_size: int):
    """``generate_synteny_blocks``' edge table in one call: the edges of
    ``blocks/edges.py::list_edges`` over the index's marks (`bif_at`,
    `node_bif`) and the sequence (`chars`, `origpos`), those of original
    length below `min_size` left out, grouped by the natural key and
    ordered as ``core/stdsort.py`` orders them: the groups by size, greater
    first, and each group's edges by direction.  Returns (columns,
    bounds): one array a field of ``EDGE_COLUMNS``, the rows in their final
    order, and each group's (begin, end) rows, int64 (n_groups, 2), in the
    groups' final order.  None when the library is off."""
    lib = load()
    if lib is None:
        return None
    n = len(chars)
    chars = [np.ascontiguousarray(c, dtype=np.uint8) for c in chars]
    origpos = [np.ascontiguousarray(o, dtype=np.int32) for o in origpos]
    marks = [[np.ascontiguousarray(a, dtype=np.int64) for a in bif_at[s]]
             for s in (0, 1)]
    node_bif = np.ascontiguousarray(node_bif, dtype=np.int64)
    lens = np.array([c.size for c in chars], dtype=np.int64)
    for arrs in (origpos, *marks):
        if [a.size for a in arrs] != lens.tolist():
            raise ValueError("edge_table: marks, bases and original "
                             "positions differ in length")
    n_groups = np.zeros(1, dtype=np.int64)
    m = lib.edge_table(n, lens.ctypes.data, _pointers(marks[0]),
                       _pointers(marks[1]), node_bif.ctypes.data,
                       node_bif.size, _pointers(chars), _pointers(origpos),
                       k, min_size, n_groups.ctypes.data)
    if m < 0:
        raise ValueError("edge_table: a mark names no node or its edge "
                         "leaves its chromosome")
    cols = [np.empty(m, dtype=dt) for _, dt in EDGE_COLUMNS]
    bounds = np.empty((int(n_groups[0]), 2), dtype=np.int64)
    lib.edge_table_fetch(*(c.ctypes.data for c in cols), bounds.ctypes.data)
    return cols, bounds


def overlap_claims(group: list[tuple[int, int, int]],
                   overlap: list[np.ndarray], min_size: int):
    """``blocks/synteny.py::resolve_overlap``'s claims for one group's
    edges, given as (chromosome, original start, original length), over
    the occupancy arrays `overlap` (int8, 0 free), which are read and not
    written.  Returns one (claimed, start of the claimed run, its length)
    an edge.  None when the library is off."""
    lib = load()
    if lib is None:
        return None
    rows = []
    for c, start, length in group:
        occ = overlap[c]
        if occ.dtype != np.int8 or not occ.flags.c_contiguous:
            raise ValueError("overlap_claims: an occupancy array is not "
                             "contiguous int8")
        if start < 0 or length < 0:
            raise ValueError("overlap_claims: a span before its start")
        rows += (c, start, length, occ.size, occ.ctypes.data)
    n = len(group)
    out = (ctypes.c_int64 * (3 * n))()
    lib.overlap_claims(n, (ctypes.c_int64 * (5 * n))(*rows), min_size, out)
    it = iter(out)
    return list(zip(it, it, it))


# ---------------------------------------------------------------------------
# LAGAN-semantics engine (chaos / anchors / order stage primitives)
# ---------------------------------------------------------------------------

def load_lagan() -> ctypes.CDLL | None:
    """Build (if stale) and load the native LAGAN-stage library; None when
    SIBELIA_TPU_NATIVE=0."""
    if _native_off():
        return None
    lib = _LIBS.get("lagan")
    if lib is not None:
        return lib
    lib = _build("liblagan_engine.so",
                 ["-O2", "-std=c++17", "-shared", "-fPIC"],
                 ["lagan_api.cpp", "lagan_chaos.cpp", "lagan_anchors.cpp",
                  "lagan_order.cpp", "lagan_multial.cpp"],
                 ("lagan_common.h", "lagan_stages.h"))
    lib.le_chaos.restype = ctypes.c_void_p
    lib.le_chaos.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.le_chaos_trans.restype = ctypes.c_void_p
    lib.le_chaos_trans.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.le_chaos_stats.restype = None
    lib.le_chaos_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.le_anchors.restype = ctypes.c_void_p
    lib.le_anchors.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.le_order.restype = ctypes.c_void_p
    lib.le_order.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.le_free.restype = None
    lib.le_free.argtypes = [ctypes.c_void_p]
    # the order stage split around the band DP (kernels/order_device.py)
    lib.le_order_prepare.restype = ctypes.c_void_p
    lib.le_order_prepare.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p]
    lib.le_order_dims.restype = None
    lib.le_order_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.le_order_band.restype = None
    lib.le_order_band.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.le_order_seq.restype = None
    lib.le_order_seq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.le_order_finish.restype = ctypes.c_void_p
    lib.le_order_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_longlong]
    lib.le_order_release.restype = None
    lib.le_order_release.argtypes = [ctypes.c_void_p]
    lib.ml_create.restype = ctypes.c_void_p
    lib.ml_create.argtypes = [ctypes.c_int]
    lib.ml_set_seq.restype = None
    lib.ml_set_seq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_char_p]
    lib.ml_add_anchor.restype = None
    lib.ml_add_anchor.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float]
    lib.ml_run.restype = ctypes.c_void_p
    lib.ml_run.argtypes = [ctypes.c_void_p]
    lib.ml_destroy.restype = None
    lib.ml_destroy.argtypes = [ctypes.c_void_p]
    lib.pl_set_profile.restype = None
    lib.pl_set_profile.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int]
    lib.pl_run.restype = ctypes.c_void_p
    lib.pl_run.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_void_p]
    _LIBS["lagan"] = lib
    return lib


def _take_string(lib, ptr) -> str:
    try:
        return ctypes.string_at(ptr).decode("latin-1")
    finally:
        lib.le_free(ptr)


def lagan_chaos(seq1: bytes, name1: str, seq2: bytes, name2: str,
                pairs_text: str, wl: int, nd: int, co: int, rsc: int,
                gfc: bool = True, ext: bool = True) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_chaos(seq1, len(seq1), name1.encode("latin-1"),
                       seq2, len(seq2), name2.encode("latin-1"),
                       pairs_text.encode("latin-1"),
                       wl, nd, co, rsc, int(gfc), int(ext))
    return _take_string(lib, ptr)


def lagan_chaos_translated(seq1: bytes, name1: str, seq2: bytes,
                           name2: str, both: bool = False, wl: int = 4,
                           nd: int = 1, co: int = 25, rsc: int = 0,
                           gfc: bool = False, ext: bool = False
                           ) -> str | None:
    """6-frame translated chaos (the reference's `chaos -t` / -b; defaults
    mirror fchaos.c:38-62 after the -t overrides, fchaos.c:652-660)."""
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_chaos_trans(seq1, len(seq1), name1.encode("latin-1"),
                             seq2, len(seq2), name2.encode("latin-1"),
                             int(both), wl, nd, co, rsc, int(gfc), int(ext))
    return _take_string(lib, ptr)


def lagan_chaos_stats() -> tuple[int, int] | None:
    """chaos's work since the library was loaded, summed over every region
    of every thread: (word matches chained, chain links walked by the
    rescoring); None when the native library is off."""
    lib = load_lagan()
    if lib is None:
        return None
    out = (ctypes.c_longlong * 2)()
    lib.le_chaos_stats(out)
    return int(out[0]), int(out[1])


def lagan_anchors(hits_text: str, gfc: bool = True) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_anchors(hits_text.encode("latin-1"), int(gfc))
    return _take_string(lib, ptr)


def lagan_order(seq1: bytes, name1: str, seq2: bytes, name2: str,
                anchors_text: str) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_order(seq1, len(seq1), name1.encode("latin-1"),
                       seq2, len(seq2), name2.encode("latin-1"),
                       anchors_text.encode("latin-1"))
    return _take_string(lib, ptr)


def mlagan_native(seqs, names, pair_anchor_lines) -> str | None:
    """Run the native mlagan port. pair_anchor_lines[(i, j)] is the anchor
    text lines for pair (i, j) in file order (descending seq1 end)."""
    lib = load_lagan()
    if lib is None:
        return None
    h = lib.ml_create(len(seqs))
    try:
        for i, (s, nm) in enumerate(zip(seqs, names)):
            lib.ml_set_seq(h, i, s, len(s), nm.encode("latin-1"))
        for (i, j), lines in pair_anchor_lines.items():
            for (s1s, s1e, s2s, s2e, score) in lines:
                lib.ml_add_anchor(h, i, j, s1s, s1e, s2s, s2e, score)
        ptr = lib.ml_run(h)
        return _take_string(lib, ptr)
    finally:
        lib.ml_destroy(h)


def prolagan_native(seqs, names, profiles, pair_anchor_lines,
                    tree) -> str | None:
    """Run the native prolagan port (reference src/lagan/src/prolagan.c).

    profiles: two lists of (file_index, gapped_row) in profile row order.
    pair_anchor_lines[(i, j)]: cross-profile anchor lines, file order.
    tree: the required phylogenetic tree string (prolagan.c:699-705 exits
    without one).
    """
    lib = load_lagan()
    if lib is None:
        return None
    h = lib.ml_create(len(seqs))
    try:
        for i, (s, nm) in enumerate(zip(seqs, names)):
            lib.ml_set_seq(h, i, s, len(s), nm.encode("latin-1"))
        pro_of = np.full(len(seqs), -1, dtype=np.int32)
        for which, rows in enumerate(profiles):
            members = np.array([m for m, _ in rows], dtype=np.int32)
            pro_of[members] = which
            joined = "\n".join(r for _, r in rows).encode("latin-1")
            lib.pl_set_profile(h, which, joined, members.ctypes.data,
                               len(rows))
        if (pro_of < 0).any():
            raise ValueError("sequence not found in either profile")
        for (i, j), lines in pair_anchor_lines.items():
            for (s1s, s1e, s2s, s2e, score) in lines:
                lib.ml_add_anchor(h, i, j, s1s, s1e, s2s, s2e, score)
        ptr = lib.pl_run(h, tree.encode("latin-1"), pro_of.ctypes.data)
        return _take_string(lib, ptr)
    finally:
        lib.ml_destroy(h)


# ---------------------------------------------------------------------------
# Native k-mer ranking kernel and host enumeration
# ---------------------------------------------------------------------------

def load_ranking() -> ctypes.CDLL | None:
    """The ranking and host enumeration library (ranking.cpp); None when
    SIBELIA_TPU_NATIVE=0."""
    if _native_off():
        return None
    lib = _LIBS.get("ranking")
    if lib is not None:
        return lib
    lib = _build("libsibelia_ranking.so",
                 ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                  "-pthread",
                  "-Wl,--version-script=" + os.path.join(_DIR, "ranking.map")],
                 ["ranking.cpp"], ("ranking.map",), ctypes.RTLD_GLOBAL)
    lib.kmer_ranks_native.restype = None
    lib.kmer_ranks_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.enum_run.restype = ctypes.c_void_p
    lib.enum_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.enum_count.restype = ctypes.c_int64
    lib.enum_count.argtypes = [ctypes.c_void_p]
    lib.enum_strand_size.restype = ctypes.c_int64
    lib.enum_strand_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.enum_destroy.restype = None
    lib.enum_destroy.argtypes = [ctypes.c_void_p]
    lib.enum_fetch32.restype = None
    lib.enum_fetch32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.rank_slab_reserve.restype = None
    lib.rank_slab_reserve.argtypes = [ctypes.c_int64]
    lib.rank_slab_stats.restype = None
    lib.rank_slab_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 2
    lib.rank_set_run.restype = None
    lib.rank_set_run.argtypes = [ctypes.c_char_p, ctypes.c_int]
    _LIBS["ranking"] = lib
    return lib


def ranking_run(spill_dir: str | None, final_cache: bool) -> None:
    """Hand the ranking library a run's settings
    (``ranking.cpp::rank_set_run``): the directory its arenas spill to
    (None: in RAM) and whether it keeps the final-level cache (``-g``).
    The Sibelia CLI sets them at the start of every run and clears them at
    its end; a change of directory releases every arena.  The defaults
    need no library: one that is not loaded holds no arena.  Nothing
    under SIBELIA_TPU_NATIVE=0."""
    lib = (load_ranking() if spill_dir or final_cache
           else _LIBS.get("ranking"))
    if lib is not None:
        lib.rank_set_run(spill_dir.encode() if spill_dir else None,
                         int(final_cache))


def slab_reserve(n_bytes: int) -> None:
    """Map and populate the native arena slab of `n_bytes`
    (``ranking.cpp::rank_slab_reserve``: hugetlb pages where the pool has
    them, else plain pages), from which the ranking arenas and the engine's
    node and sequence arrays carve.  Nothing under SIBELIA_TPU_NATIVE=0,
    in spill mode, or once a slab is mapped; a library that does not build
    raises, as every loader here does."""
    lib = load_ranking()
    if lib is None:
        return
    lib.rank_slab_reserve(ctypes.c_int64(n_bytes))


def slab_stats() -> tuple[int, int]:
    """(mapped, carved) bytes of the arena slab; (0, 0) without one or
    before the ranking library is loaded."""
    lib = _LIBS.get("ranking")
    if lib is None:
        return 0, 0
    cap, used = ctypes.c_int64(), ctypes.c_int64()
    lib.rank_slab_stats(ctypes.byref(cap), ctypes.byref(used))
    return cap.value, used.value


def kmer_ranks_native(codes: np.ndarray, k: int):
    """Native (rank, order) twin of index.ranking.kmer_ranks_numpy.

    Contract: identical GROUPING of valid windows (equal rank <=>
    identical k-window) and identical valid-filtered sorted order.  Rank
    VALUES and the placement of invalid (separator-crossing) positions
    may differ from the numpy twin in groups that mix valid and invalid
    members (the k>32 LCP refinement leaves invalid members at the
    group's base rank; see native/ranking.cpp).  None when the library
    is off."""
    lib = load_ranking()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    rank = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.kmer_ranks_native(codes.ctypes.data, n, int(k),
                          rank.ctypes.data, order.ctypes.data)
    return rank, order


def enumerate_native(codes: np.ndarray, block_starts: np.ndarray,
                     n_chr: int, k: int):
    """Native twin of index.enumeration.enumerate_bifurcations_host's scan
    over a prebuilt supergenome; returns (count, [(chr, pos, id)] * 2),
    chr and pos as int32 and id as uint32 (lossless under the 1 GB input
    cap); None when the library is off."""
    lib = load_ranking()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    block_starts = np.ascontiguousarray(block_starts, dtype=np.int64)
    h = lib.enum_run(codes.ctypes.data, len(codes), block_starts.ctypes.data,
                     len(block_starts), int(n_chr), int(k))
    try:
        count = lib.enum_count(h)
        strands = []
        for s in (0, 1):
            m = lib.enum_strand_size(h, s)
            chrs = np.empty(m, dtype=np.int32)
            poss = np.empty(m, dtype=np.int32)
            ids = np.empty(m, dtype=np.uint32)
            lib.enum_fetch32(h, s, chrs.ctypes.data, poss.ctypes.data,
                             ids.ctypes.data)
            strands.append((chrs, poss, ids))
        return int(count), strands
    finally:
        lib.enum_destroy(h)
