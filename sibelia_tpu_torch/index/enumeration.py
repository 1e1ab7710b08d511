"""Bifurcation enumeration: from chromosome strings to per-strand sorted
bifurcation instance lists.

``enumerate_bifurcations`` is the device path (twin of the device branch of
``sibelia_tpu/index/enumeration.py::enumerate_bifurcations``): every k runs
the fused device enumeration (``enum_device.py``), k <= 32 by one sort of the
packed keys, k > 32 by prefix doubling, as the JAX package's single-device
``enumerate_bifurcations_sharded`` does; a call ends in one blocking copy
(the two counts and the first ``HEAD_ROWS`` rows of the selection), and a
second only for a longer selection.  Under ``SIBELIA_TPU_SHARDED=N`` (N > 1,
with N shards available) it runs the sharded enumeration
(``parallel/sharded_enum.py``) over ``make_mesh(N)`` instead, as the JAX
package's branch does, and sets no candidate bitmap.
``enumerate_bifurcations_host`` is the copy of that function's host branch: the native enumeration
(``native/ranking.cpp``) from 2^16 supergenome rows on, its small form
(``native/trim.cpp``, which also serves ``trim_blocks``'s rounds below
``blocks/synteny.py::TRIM_CARD_MIN_ROWS``) below, and numpy when the
native library is off (``SIBELIA_TPU_NATIVE=0``).  It serves supergenomes
of 2^30 rows or more, which exceed the scan kernel's int32 key space.

Both reproduce the semantics of the reference's suffix-array scan
(reference: src/vertexenumeration.cpp:160-364) without a suffix array:

  * supergenome = '#' + chr_0 + '#' + ... + '#' + rc(chr_0) + '#' + ...
  * group positions by identical k-mer
  * a group is a bifurcation vertex iff its predecessor-char set or
    successor-char set has >1 symbol or touches '#'
    (reference: vertexenumeration.cpp:67-70)
  * positions whose k-mer crosses a chromosome end are not candidates
    (reference: vertexenumeration.cpp:341)
  * a group is counted iff it has >=2 candidates, or any candidate is
    terminal (adjacent to '#') (reference: vertexenumeration.cpp:348)
  * ids are assigned densely in suffix-array order == lexicographic k-mer
    order, which is exactly the rank order

The reference's Flank() pass (vertexenumeration.cpp:72-88) is a no-op here:
enumeration always runs after ambiguous bases have been randomized to ACGT
(reference: src/indexedsequence.cpp:33-37), making IsDefiniteBase true
everywhere.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..core import timings
from ..core.convert import download, to_numpy, to_tensor
from ..core.platform import resolve_device, sync_wait
from ..parallel.sharded import requested_mesh
from .enum_device import (candidate_scan, card_free_bytes,
                          fused_enumeration)
from .ranking import CODE_OF, SEP_CODE, kmer_ranks_numpy

NO_BIFURCATION = (1 << 32) - 1  # reference: BifurcationId(-1), uint32
# rows of the selection that come down with its two counts in one copy:
# the whole selection of a supergenome of up to this many rows
HEAD_ROWS = 1 << 14


@dataclass
class BifEnumeration:
    count: int
    # per strand: arrays sorted by (chr, pos); pos is strand-local
    # (for the negative strand: offset within the reverse complement)
    chr: tuple[np.ndarray, np.ndarray]
    pos: tuple[np.ndarray, np.ndarray]
    bif_id: tuple[np.ndarray, np.ndarray]
    # optional uint8[count] bitmap: 1 = the id may have a bulge at stage
    # start (device prefilter, superset of the serial AnyBulges outcome);
    # None when not computed (the engine's re-prefilter computes it)
    candidates: np.ndarray | None = None


_ENC_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _code in CODE_OF.items():
    _ENC_LUT[ord(_ch)] = _code
    # lowercase maps like uppercase so both strand encodings derive from
    # the same LUT composition: the RC strand complements lowercase acgt
    # to uppercase bases via _COMP_LUT, and without these entries the
    # forward strand would treat 'a' as a separator while the RC strand
    # sees a real T code — a latent strand-symmetry break (production
    # callers always pass sanitized uppercase, so this is hardening)
    _ENC_LUT[ord(_ch.lower())] = _code
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGCatgc", b"TACGtacg"):
    _COMP_LUT[_a] = _b


def build_supergenome(chromosomes: list[bytes | np.ndarray]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Return (codes, block_starts). Layout mirrors the reference
    (vertexenumeration.cpp:166-183): leading '#', each chromosome followed
    by '#', then each reverse complement followed by '#'. block_starts[b]
    is the supergenome offset of block b (positive blocks then negative).
    Accepts bytes or uint8 arrays; codes are written straight into one
    output buffer (no intermediate join/copy of the genome)."""
    arrs = [np.frombuffer(c, dtype=np.uint8)
            if isinstance(c, (bytes, bytearray))
            else np.asarray(c, dtype=np.uint8) for c in chromosomes]
    total = supergenome_rows(sum(len(a) for a in arrs), len(arrs))
    codes = np.zeros(total, dtype=np.uint8)  # untouched slots = separators
    starts = []
    off = 1
    for a in arrs:
        starts.append(off)
        codes[off:off + len(a)] = _ENC_LUT[a]
        off += len(a) + 1
    for a in arrs:
        starts.append(off)
        codes[off:off + len(a)] = _ENC_LUT[_COMP_LUT[a]][::-1]
        off += len(a) + 1
    return codes, np.asarray(starts, dtype=np.int64)


def _empty_enumeration() -> BifEnumeration:
    e = np.zeros(0, dtype=np.int64)
    ei = np.zeros(0, dtype=np.uint32)
    return BifEnumeration(0, (e, e.copy()), (e.copy(), e.copy()), (ei, ei.copy()))


def _map_selected(sel: np.ndarray, sel_ids: np.ndarray, count: int,
                  block_starts: np.ndarray, n_chr: int) -> BifEnumeration:
    """Map selected supergenome positions + dense ids to the per-strand
    (chr, pos, id) instance lists sorted by (chr, pos)."""
    sel_block = np.searchsorted(block_starts, sel, side="right") - 1
    sel_block = np.clip(sel_block, 0, 2 * n_chr - 1)
    sel_chr = np.where(sel_block < n_chr, sel_block, sel_block - n_chr)
    sel_local = sel - block_starts[sel_block]
    sel_neg = sel_block >= n_chr

    out_chr, out_pos, out_id = [], [], []
    for strand_neg in (False, True):
        m = sel_neg == strand_neg
        c, p, i = sel_chr[m], sel_local[m], sel_ids[m]
        srt = np.lexsort((p, c))
        out_chr.append(c[srt])
        out_pos.append(p[srt])
        out_id.append(i[srt])
    return BifEnumeration(count, tuple(out_chr), tuple(out_pos), tuple(out_id))


# The card's peak bytes of one single-card enumeration: bytes a supergenome
# row, by k <= 32 (with the candidate prefilter, whose band pairs take half
# of what the card gives, and at least PAIR_ROW_BUDGET bytes a row) and
# k > 32 (prefix doubling), and a constant.  Upper envelopes of the peaks
# the caching allocator reserved on an H100 80GB HBM3 (700 W) for related
# strains of 2 and 2.1 Mbp (chip_smoke.py phase memory and --memory): k > 32
# 93.1 B a row at every size to 827 M rows; k <= 32 94 B a row at 16-64 M
# rows with the card filled to leave this rule's peak, and 119 B a row at
# 567 M rows (0.95 of this rule's crossover) on an empty card.
CARD_BYTES_A_ROW = {False: 140, True: 96}
CARD_BYTES_FIXED = 256 << 20


def card_peak_bytes(n_rows: int, k: int) -> int:
    """The fitted peak of the card's enumeration of `n_rows` rows at k."""
    return CARD_BYTES_A_ROW[k > 32] * n_rows + CARD_BYTES_FIXED


def fits_on_card(n_rows: int, k: int, free_bytes: int) -> bool:
    """The size rule of the single-card route: its fitted peak for
    (n_rows, k) within `free_bytes`."""
    return card_peak_bytes(n_rows, k) <= free_bytes


def supergenome_rows(total: int, n_chr: int) -> int:
    """Rows of the supergenome of `n_chr` chromosomes of `total` bases:
    both strands, a separator before each chromosome and one at the end."""
    return 1 + 2 * (total + n_chr)


def host_route(n_rows: int, k: int, device: torch.device) -> str | None:
    """Why a supergenome of `n_rows` rows at k takes the host enumeration
    on `device`, or None when the single-device route takes it: 2^30 rows
    or more on any device (the scan keeps (ordinal << 1) keys in int32),
    or on a card a fitted peak over what ``card_free_bytes`` gives now."""
    if n_rows >= (1 << 30):
        return ("supergenome exceeds the single-device enumeration's int32 "
                "scan space")
    free = card_free_bytes(device)
    if free is not None and not fits_on_card(n_rows, k, free):
        return (f"supergenome of {n_rows} rows needs about "
                f"{card_peak_bytes(n_rows, k) >> 20} MiB on the device at "
                f"k = {k}, more than its {free >> 20} MiB")
    return None


def enumerate_bifurcations(chromosomes: list[bytes | np.ndarray], k: int,
                           min_branch: int | None = None,
                           device: torch.device | None = None
                           ) -> BifEnumeration:
    """Enumerate bifurcations on the device; with `min_branch` given and
    k <= 32, also the bulge-candidate bitmap for the coming sweep
    (``candidates``).  For k > 32 the JAX device path sets none either: the
    engine's stage-start re-prefilter computes it.  chr and pos come back
    as int64, as from the JAX package's device paths.

    A supergenome that ``host_route`` sends to the host (2^30 rows or more,
    or a fitted peak the card cannot hold) takes the host enumeration
    before anything is allocated on the device, with a RuntimeWarning."""
    if not chromosomes:
        return _empty_enumeration()
    if device is None:
        device = resolve_device()
    mesh = requested_mesh(device)
    if mesh is not None:
        # the sharded route returns before min_branch is read, as the JAX
        # package's does: the engine's re-prefilter makes the bitmap
        if supergenome_rows(sum(len(c) for c in chromosomes),
                            len(chromosomes)) >= (1 << 31):
            warnings.warn(
                "supergenome exceeds the sharded pipeline's int32 position "
                "space; falling back to the host enumeration",
                RuntimeWarning)
            return enumerate_bifurcations_host(chromosomes, k)
        from ..parallel.sharded_enum import enumerate_bifurcations_sharded
        return enumerate_bifurcations_sharded(chromosomes, k, mesh)
    with timings.phase("enum_host"):
        codes, block_starts = build_supergenome(chromosomes)
    why = host_route(codes.shape[0], k, device)
    if why is not None:
        warnings.warn(why + "; falling back to the host enumeration",
                      RuntimeWarning)
        return enumerate_bifurcations_host(chromosomes, k)
    return enumerate_on_device(codes, block_starts, len(chromosomes), k,
                               min_branch, device)


def enumerate_on_device(codes: np.ndarray, block_starts: np.ndarray,
                        n_chr: int, k: int, min_branch: int | None,
                        device: torch.device) -> BifEnumeration:
    """The single-device route of ``enumerate_bifurcations`` over a built
    supergenome, with no gate."""
    n = codes.shape[0]
    with sync_wait("enum_upload"):
        codes_d = to_tensor(codes, device)
    pos_d, id_d, n_sel_d, n_groups_d = fused_enumeration(codes_d, k)
    # one blocking copy: the two counts and the first rows of the
    # selection, all of it up to HEAD_ROWS supergenome rows (n_sel <= n)
    m = min(n, HEAD_ROWS)
    with sync_wait("enum_fetch"):
        head = download(torch.cat([n_sel_d.view(1), n_groups_d.view(1),
                                   pos_d[:m], id_d[:m]]), "enum_head")
    ns, count = int(head[0]), int(head[1])
    if ns == 0:
        return _empty_enumeration()
    sel = np.empty(ns, dtype=np.int64)
    sel_ids = np.empty(ns, dtype=np.uint32)
    sel[:m] = head[2:2 + min(ns, m)]
    sel_ids[:m] = head[2 + m:2 + m + min(ns, m)]
    cand = None
    if k <= 32 and min_branch is not None and min_branch > 1:
        cand_d = candidate_scan(codes_d, pos_d[:ns], id_d[:ns], k,
                                int(min_branch), ns)
        with sync_wait("candidate_fetch"):
            cand = to_numpy(cand_d[:count]).astype(np.uint8)
    if ns > m:
        with sync_wait("enum_fetch", 2):
            sel[m:] = to_numpy(pos_d[m:ns])
            sel_ids[m:] = to_numpy(id_d[m:ns])
    with timings.phase("enum_host"):
        res = _map_selected(sel, sel_ids, count, block_starts, n_chr)
    res.candidates = cand
    return res


def _from_strands(count: int, strands) -> BifEnumeration:
    return BifEnumeration(count, (strands[0][0], strands[1][0]),
                          (strands[0][1], strands[1][1]),
                          (strands[0][2], strands[1][2]))


def enumerate_bifurcations_host(chromosomes: list[bytes | np.ndarray],
                                k: int) -> BifEnumeration:
    """Enumerate bifurcations on the host: the whole ranking and group scan
    in one native call, ``ranking.cpp``'s from 2^16 supergenome rows on
    (chr and pos as int32) and ``trim.cpp``'s small form below (int64);
    the numpy formulation under SIBELIA_TPU_NATIVE=0 (int64)."""
    if not chromosomes:
        return _empty_enumeration()
    from ..native import enumerate_native, trim_enum
    arrs = [np.frombuffer(c, dtype=np.uint8)
            if isinstance(c, (bytes, bytearray))
            else np.asarray(c, dtype=np.uint8) for c in chromosomes]
    lens = np.fromiter((len(a) for a in arrs), np.int64, len(arrs))
    if supergenome_rows(int(lens.sum()), len(arrs)) < (1 << 16):
        res = trim_enum(np.concatenate(arrs), lens, k)
        if res is not None:
            return _from_strands(*res)
    codes, block_starts = build_supergenome(arrs)
    if codes.shape[0] >= (1 << 16):
        with timings.phase("enum_native"):
            res = enumerate_native(codes, block_starts, len(arrs), k)
        if res is not None:
            return _from_strands(*res)
    return enumerate_numpy(codes, block_starts, len(arrs), k)


def enumerate_numpy(codes: np.ndarray, block_starts: np.ndarray, n_chr: int,
                    k: int) -> BifEnumeration:
    """The numpy formulation of the host enumeration over a built
    supergenome (SIBELIA_TPU_NATIVE=0)."""
    n = codes.shape[0]
    # Candidate validity == the k-window crosses no separator; derived
    # from the next-separator index in one reverse cummin pass (cheaper
    # than per-position block lookups over the whole supergenome).
    idx = np.arange(n, dtype=np.int64)
    sep_idx = np.where(codes == SEP_CODE, idx, n)
    next_sep = np.minimum.accumulate(sep_idx[::-1])[::-1]
    valid = (codes != SEP_CODE) & (idx + k <= next_sep)

    # Keep only candidate positions; groups are all-candidate or all-dropped
    # (a '#'-free k-mer fits inside its chromosome; see module docstring).
    rank, order = kmer_ranks_numpy(codes, k)
    keep = order[valid[order]]
    if keep.size == 0:
        return _empty_enumeration()
    kr = rank[keep]
    group_start_mask = np.empty(keep.size, dtype=bool)
    group_start_mask[0] = True
    group_start_mask[1:] = kr[1:] != kr[:-1]
    prev_codes = codes[keep - 1]
    next_code = codes[np.minimum(keep + k, n - 1)]

    starts_idx = np.flatnonzero(group_start_mask)
    group_sizes = np.diff(np.append(starts_idx, keep.size))

    prev_bits = (1 << prev_codes.astype(np.int64))
    next_bits = (1 << next_code.astype(np.int64))
    prev_or = np.bitwise_or.reduceat(prev_bits, starts_idx)
    next_or = np.bitwise_or.reduceat(next_bits, starts_idx)

    def is_bif(bits):
        pop = np.zeros_like(bits)
        for b in range(5):
            pop += (bits >> b) & 1
        return (pop > 1) | ((bits & 1) != 0)

    bif_group = is_bif(prev_or) | is_bif(next_or)

    terminal = (prev_codes == SEP_CODE) | (next_code == SEP_CODE)
    any_terminal = np.bitwise_or.reduceat(terminal.astype(np.int64), starts_idx) != 0
    counted = bif_group & ((group_sizes > 1) | any_terminal)

    ids_per_group = np.cumsum(counted.astype(np.int64)) - 1
    count = int(counted.sum())

    group_of_keep = np.cumsum(group_start_mask.astype(np.int64)) - 1
    pos_counted = counted[group_of_keep]
    sel = keep[pos_counted]
    sel_ids = ids_per_group[group_of_keep[pos_counted]].astype(np.uint32)
    return _map_selected(sel, sel_ids, count, block_starts, n_chr)
