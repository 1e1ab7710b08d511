"""Iteration-order-exact emulation of boost 1.54 unordered_map<size_t, V>.

The reference collects bulge candidates in a boost::unordered_map and
processes them in ITERATION order (reference: src/bulgeremoval.cpp:168,
203-215). That order decides which bulge collapses first, which changes
results — so we replicate the container's layout exactly, from the
vendored headers (reference: src/include/boost/unordered/detail/):

  * 64-bit platform => mix64_policy (buckets.hpp:604-645): power-of-two
    bucket counts, hash mixed by the 64-bit Wang mix, bucket = hash & (n-1)
  * grouped singly-linked node list: a bucket stores the link *preceding*
    its first node; inserting into an empty bucket pushes the node at the
    global list FRONT (unique.hpp:302-333 add_node)
  * default bucket count 11 -> rounded to 16 (util.hpp:27, mix64
    new_bucket_count); lazy bucket creation on first insert; max load
    factor 1.0; growth to min_buckets_for_size(max(size+1, size*1.5))
    (table.hpp:808-824)
  * rehash walks the list front-to-back re-placing each node, moving
    same-bucket nodes to their group front (unique.hpp:591-618)

Only the operations AnyBulges needs are implemented: find / insert-unique
/ in-order iteration.
"""
from __future__ import annotations

_M64 = (1 << 64) - 1


def _mix64(key: int) -> int:
    key &= _M64
    key = ((~key) + (key << 21)) & _M64
    key ^= key >> 24
    key = (key + (key << 3) + (key << 8)) & _M64
    key ^= key >> 14
    key = (key + (key << 2) + (key << 4)) & _M64
    key ^= key >> 28
    key = (key + (key << 31)) & _M64
    return key


def _new_bucket_count(minimum: int) -> int:
    if minimum <= 4:
        return 4
    return 1 << (minimum - 1).bit_length()


class _Node:
    __slots__ = ("key", "value", "hash", "next")

    def __init__(self, key, value, h):
        self.key = key
        self.value = value
        self.hash = h
        self.next = None


class _Link:
    """Sentinel link (the 'previous start' slot)."""
    __slots__ = ("next",)

    def __init__(self):
        self.next = None


class Boost154Map:
    def __init__(self):
        self.bucket_count = _new_bucket_count(11)  # 16
        self.buckets = None  # lazily created: list of link pointers or None
        self.size = 0
        self.max_load = 0
        self.prev_start = _Link()

    # -- internals ----------------------------------------------------------
    def _to_bucket(self, h: int) -> int:
        return h & (self.bucket_count - 1)

    def _min_buckets_for_size(self, size: int) -> int:
        return _new_bucket_count(size + 1)  # mlf == 1.0

    def _create_buckets(self, n: int) -> None:
        self.bucket_count = n
        self.buckets = [None] * n
        self.max_load = n  # ceil(1.0 * n)

    def _rehash_impl(self, num_buckets: int) -> None:
        self._create_buckets(num_buckets)
        prev = self.prev_start
        while prev.next is not None:
            n = prev.next
            bi = self._to_bucket(n.hash)
            b = self.buckets[bi]
            if b is None:
                self.buckets[bi] = prev
                prev = n
            else:
                prev.next = n.next
                n.next = b.next
                b.next = n

    def _reserve_for_insert(self, size: int) -> None:
        if self.buckets is None:
            self._create_buckets(max(self.bucket_count,
                                     self._min_buckets_for_size(size)))
        elif size > self.max_load:
            num = self._min_buckets_for_size(
                max(size, self.size + (self.size >> 1)))
            if num != self.bucket_count:
                self._rehash_impl(num)

    def _find_node(self, key, h) -> _Node | None:
        if self.buckets is None or self.size == 0:
            return None
        b = self.buckets[self._to_bucket(h)]
        if b is None:
            return None
        n = b.next
        while n is not None and self._to_bucket(n.hash) == self._to_bucket(h):
            if n.key == key:
                return n
            n = n.next
        return None

    # -- public api ---------------------------------------------------------
    def find(self, key):
        n = self._find_node(key, _mix64(key))
        return n.value if n is not None else None

    def insert(self, key, value) -> bool:
        """Insert if absent (reference emplace semantics). Returns True if
        inserted."""
        h = _mix64(key)
        if self._find_node(key, h) is not None:
            return False
        self._reserve_for_insert(self.size + 1)
        n = _Node(key, value, h)
        bi = self._to_bucket(h)
        b = self.buckets[bi]
        if b is None:
            start = self.prev_start
            if start.next is not None:
                self.buckets[self._to_bucket(start.next.hash)] = n
            self.buckets[bi] = start
            n.next = start.next
            start.next = n
        else:
            # b is the link preceding the bucket's first node
            n.next = b.next
            b.next = n
        self.size += 1
        return True

    def items(self):
        """(key, value) pairs in boost iteration order (begin..end)."""
        n = self.prev_start.next
        while n is not None:
            yield n.key, n.value
            n = n.next
