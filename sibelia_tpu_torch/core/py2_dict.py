"""Python 2.7 dict iteration-order emulation for string keys.

The reference C-Sibelia script is Python 2 and iterates string-keyed dicts
(reference: C-Sibelia.py:380 ``all_cover.items()``) whose order leaks into
output ordering: the relative order of equal-(chr, pos) variants under the
stable sort at C-Sibelia.py:575 and the numbering of breakend records.
CPython 2.7 (PYTHONHASHSEED unset, the default) iterates hash-table slots
in order, so the order is a deterministic function of the insertion
sequence:

* string hash (stringobject.c): ``x = s[0] << 7`` then
  ``x = (1000003 * x) ^ ch`` over all chars, ``x ^= len``, ``-1 -> -2``,
  in a 64-bit signed register;
* open addressing (dictobject.c lookdict): start ``i = hash & mask``,
  probe ``i = (i << 2) + i + perturb + 1; perturb >>= 5``;
* table starts at 8 slots and resizes to the next power of two above
  ``used * 4`` (``* 2`` above 50000 used) when ``used * 3 >= size * 2``,
  re-inserting in slot order.

No deletions occur in the replicated flows, so dummy slots are not
modeled.
"""
from __future__ import annotations

_MASK64 = (1 << 64) - 1


def py2_str_hash(s: str | bytes) -> int:
    """CPython 2.7 64-bit string hash (signed)."""
    if isinstance(s, str):
        s = s.encode("latin-1")
    if len(s) == 0:
        return 0
    x = (s[0] << 7) & _MASK64
    for ch in s:
        x = ((1000003 * x) ^ ch) & _MASK64
    x ^= len(s)
    if x >= (1 << 63):
        x -= (1 << 64)
    if x == -1:
        x = -2
    return x


class Py2Dict:
    """Insertion-compatible model of a py2.7 string-keyed dict; only the
    iteration order is exposed."""

    def __init__(self, keys=()):
        self._size = 8
        self._table: list[str | None] = [None] * 8
        self._used = 0
        for k in keys:
            self.insert(k)

    def _slot(self, key: str, table, mask) -> int:
        h = py2_str_hash(key) & _MASK64
        i = h & mask
        if table[i] is None or table[i] == key:
            return i
        perturb = h
        while True:
            i = ((i << 2) + i + perturb + 1) & _MASK64
            if table[i & mask] is None or table[i & mask] == key:
                return i & mask
            perturb >>= 5

    def insert(self, key: str) -> None:
        mask = self._size - 1
        i = self._slot(key, self._table, mask)
        if self._table[i] == key:
            return
        self._table[i] = key
        self._used += 1
        if self._used * 3 >= self._size * 2:
            self._resize()

    def _resize(self) -> None:
        minused = self._used * (2 if self._used > 50000 else 4)
        newsize = 8
        while newsize <= minused:
            newsize <<= 1
        old = self._table
        self._size = newsize
        self._table = [None] * newsize
        mask = newsize - 1
        for k in old:  # re-insert in slot order (dictresize)
            if k is not None:
                self._table[self._slot(k, self._table, mask)] = k

    def iterkeys(self) -> list[str]:
        return [k for k in self._table if k is not None]


def py2_dict_key_order(keys_in_insertion_order) -> list[str]:
    """The order ``dict.items()`` would yield for these (unique) string
    keys inserted in the given sequence under CPython 2.7."""
    return Py2Dict(keys_in_insertion_order).iterkeys()
