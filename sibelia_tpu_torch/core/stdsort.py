"""Deterministic emulation of libstdc++ std::sort (introsort).

The reference pipeline's output depends on the *unspecified* order that
GCC's unstable std::sort leaves equal elements in (edge groups, group-size
ordering, stripe sorting...). That order is deterministic for a given
input permutation, so we reproduce the exact algorithm:

  * introsort loop: quicksort with median-of-3 pivot
    (__move_median_to_first of first+1, mid, last-1), tail recursion on the
    left range, depth limit 2*floor(log2(n)), heapsort fallback
  * threshold 16, final insertion sort pass

This mirrors gcc's bits/stl_algo.h (any modern release; the algorithm has
been unchanged for decades). `cmp(a, b)` is the strict-weak "less".

Python port notes: recursion converted to an explicit loop on the right
half exactly like gcc's `__introsort_loop` (recurse right, loop left).
"""
from __future__ import annotations

_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def std_sort(arr: list, cmp) -> None:
    n = len(arr)
    if n > 1:
        _introsort_loop(arr, 0, n, 2 * _lg(n), cmp)
        _final_insertion_sort(arr, 0, n, cmp)


def _introsort_loop(arr, first, last, depth_limit, cmp):
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _heap_sort(arr, first, last, cmp)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(arr, first, last, cmp)
        _introsort_loop(arr, cut, last, depth_limit, cmp)
        last = cut


def _unguarded_partition_pivot(arr, first, last, cmp):
    mid = first + (last - first) // 2
    _move_median_to_first(arr, first, first + 1, mid, last - 1, cmp)
    return _unguarded_partition(arr, first + 1, last, first, cmp)


def _move_median_to_first(arr, result, a, b, c, cmp):
    if cmp(arr[a], arr[b]):
        if cmp(arr[b], arr[c]):
            arr[result], arr[b] = arr[b], arr[result]
        elif cmp(arr[a], arr[c]):
            arr[result], arr[c] = arr[c], arr[result]
        else:
            arr[result], arr[a] = arr[a], arr[result]
    elif cmp(arr[a], arr[c]):
        arr[result], arr[a] = arr[a], arr[result]
    elif cmp(arr[b], arr[c]):
        arr[result], arr[c] = arr[c], arr[result]
    else:
        arr[result], arr[b] = arr[b], arr[result]


def _unguarded_partition(arr, first, last, pivot, cmp):
    while True:
        while cmp(arr[first], arr[pivot]):
            first += 1
        last -= 1
        while cmp(arr[pivot], arr[last]):
            last -= 1
        if not first < last:
            return first
        arr[first], arr[last] = arr[last], arr[first]
        first += 1


def _final_insertion_sort(arr, first, last, cmp):
    if last - first > _THRESHOLD:
        _insertion_sort(arr, first, first + _THRESHOLD, cmp)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(arr, i, cmp)
    else:
        _insertion_sort(arr, first, last, cmp)


def _insertion_sort(arr, first, last, cmp):
    if first == last:
        return
    for i in range(first + 1, last):
        if cmp(arr[i], arr[first]):
            val = arr[i]
            arr[first + 1:i + 1] = arr[first:i]
            arr[first] = val
        else:
            _unguarded_linear_insert(arr, i, cmp)


def _unguarded_linear_insert(arr, last, cmp):
    val = arr[last]
    nxt = last - 1
    while cmp(val, arr[nxt]):
        arr[nxt + 1] = arr[nxt]
        nxt -= 1
    arr[nxt + 1] = val


# -- gcc heapsort fallback (bits/stl_heap.h) --------------------------------

def _heap_sort(arr, first, last, cmp):
    _make_heap(arr, first, last, cmp)
    _sort_heap(arr, first, last, cmp)


def _make_heap(arr, first, last, cmp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = arr[first + parent]
        _adjust_heap(arr, first, parent, length, value, cmp)
        if parent == 0:
            return
        parent -= 1


def _adjust_heap(arr, first, hole_index, length, value, cmp):
    top_index = hole_index
    second_child = hole_index
    while second_child < (length - 1) // 2:
        second_child = 2 * (second_child + 1)
        if cmp(arr[first + second_child], arr[first + second_child - 1]):
            second_child -= 1
        arr[first + hole_index] = arr[first + second_child]
        hole_index = second_child
    if (length & 1) == 0 and second_child == (length - 2) // 2:
        second_child = 2 * (second_child + 1)
        arr[first + hole_index] = arr[first + second_child - 1]
        hole_index = second_child - 1
    _push_heap(arr, first, hole_index, top_index, value, cmp)


def _push_heap(arr, first, hole_index, top_index, value, cmp):
    parent = (hole_index - 1) // 2
    while hole_index > top_index and cmp(arr[first + parent], value):
        arr[first + hole_index] = arr[first + parent]
        hole_index = parent
        parent = (hole_index - 1) // 2
    arr[first + hole_index] = value


def _sort_heap(arr, first, last, cmp):
    while last - first > 1:
        last -= 1
        value = arr[last]
        arr[last] = arr[first]
        _adjust_heap(arr, first, 0, last - first, value, cmp)


def group_by(store: list, cmp, sort=std_sort) -> list[tuple[int, int]]:
    """Reference GroupBy (src/common.h:150-160): std::sort with `cmp` then
    contiguous runs of cmp-equal elements as (begin, end) index pairs."""
    sort(store, cmp)
    out = []
    now = 0
    n = len(store)
    while now < n:
        prev = now
        while now < n and not cmp(store[prev], store[now]):
            now += 1
        out.append((prev, now))
    return out
