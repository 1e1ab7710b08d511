"""Post-processing: stripe gluing (and boundary correction, later phase).

Reference: src/postprocessor.cpp:37-154 (GlueStripes). Repeatedly merges
block pairs that always appear adjacent with consistent orientation, then
renumbers ids densely. All sorts use the libstdc++ std::sort emulation to
preserve the reference's equal-element permutations.
"""
from __future__ import annotations

import bisect

from ..core.stdsort import std_sort
from ..io.fasta import FASTARecord
from .instance import BlockInstance

_SENTINEL = (1 << 30) - 1  # INT_MAX >> 1


def glue_stripes(block: list[BlockInstance], chr_list: list[FASTARecord]) -> list[BlockInstance]:
    perm: list[list[BlockInstance]] = [[] for _ in chr_list]
    for b in block:
        perm[b.chr_id].append(b)
    for p in perm:
        std_sort(p, lambda a, b: a.start < b.start)

    while True:
        stripe: list[tuple[int, int]] = []
        for p in perm:
            for i, b in enumerate(p):
                bid = b.signed_id
                if bid > 0:
                    next_bid = p[i + 1].signed_id if i < len(p) - 1 else _SENTINEL
                    stripe.append((bid, next_bid))
                else:
                    prev_bid = p[i - 1].signed_id if i > 0 else -_SENTINEL
                    stripe.append((-bid, -prev_bid))

        std_sort(stripe, lambda a, b: a[0] < b[0])
        glue = False
        now = 0
        n = len(stripe)
        while now < n:
            glue = True
            nxt = now
            while nxt < n and stripe[nxt][0] == stripe[now][0]:
                if (stripe[nxt][1] != stripe[now][1] or stripe[nxt][1] == _SENTINEL
                        or abs(stripe[nxt][1]) == stripe[nxt][0]):
                    glue = False
                nxt += 1
            if glue:
                # std::equal_range over firstBlock (postprocessor.cpp:90)
                target = abs(stripe[now][1])
                firsts = [s[0] for s in stripe]
                lo = bisect.bisect_left(firsts, target)
                hi = bisect.bisect_right(firsts, target)
                if hi - lo != nxt - now:
                    glue = False
                else:
                    break
            now = nxt

        if glue:
            glue_bid = stripe[now][0]
            for p in perm:
                i = 0
                while i < len(p):
                    if p[i].block_id == glue_bid:
                        sbid = p[i].signed_id
                        if sbid > 0:
                            a, b = p[i], p[i + 1]
                            p[i] = BlockInstance(a.signed_id, a.chr, a.start, b.end)
                            del p[i + 1]
                        else:
                            i -= 1
                            a, b = p[i], p[i + 1]
                            p[i] = BlockInstance(b.signed_id, a.chr, a.start, b.end)
                            del p[i + 1]
                    i += 1
        else:
            break

    out: list[BlockInstance] = []
    old_ids: list[int] = []
    for p in perm:
        for b in p:
            out.append(b)
            old_ids.append(b.block_id)
    old_ids = sorted(set(old_ids))
    renumbered = []
    for b in out:
        sign = 1 if b.signed_id > 0 else -1
        new_id = bisect.bisect_left(old_ids, b.block_id) + 1
        renumbered.append(BlockInstance(new_id * sign, b.chr, b.start, b.end))
    return renumbered
