// One trim round of blocks/synteny.py::trim_blocks in one call: a small
// block's copies enumerated at trim_k and walked to the outermost trim_k-mer
// each copy shares with another copy.
//
// The enumeration equals index/enumeration.py's numpy formulation over the
// same supergenome ('#' + copy_0 + '#' + ... + rc(copy_0) + '#' + ...,
// build_supergenome's codes), formed for a few hundred rows: the valid
// windows (those that cross no separator) grouped by k-mer in a hash table,
// the bifurcation and terminal rules on each group, and the counted groups
// alone sorted by k-mer for their dense ids.  No threads and no allocation
// a call beyond the thread's reusable buffers (ranking.cpp's enum_run
// serves from 2^16 rows; enumerate_bifurcations_host takes this form
// below).
//
// The walk is _trim_walk's rule (reference: synteny.cpp:31-122): for each
// copy the lexicographic argmin of (sum, bifurcation id, walk index) over
// (own mark) x (another copy's instance), for the start and for the end.
// The sum is the own mark's distance from its copy's begin (end) plus the
// partner's from its own copy's begin (end), so for one own mark the best
// partner is the one of least distance among the instances of its
// bifurcation on another copy: each bifurcation keeps its least distance
// and the least on any other copy than that one's, and the walk is two
// passes over the instances and one over the own marks.  trim_walk runs
// the same walk over an enumeration made elsewhere (the card's).
//
// C ABI for ctypes (native/__init__.py: trim_round, trim_walk, trim_enum).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;
typedef uint64_t u64;

const uint32_t NO_ID = 0xFFFFFFFFu;
const i64 OO = (1LL << 32) - 1;  // synteny.cpp:42, const size_t oo = UINT_MAX
const i64 FAR = INT64_MAX / 4;   // no instance

// build_supergenome's codes: '#' 0, A 1, C 2, G 3, T 4 (lowercase alike,
// every other byte a separator), for a byte and for its complement
uint8_t ENC[256], RC_ENC[256];
struct LutInit {
    LutInit() {
        std::memset(ENC, 0, sizeof ENC);
        const char* up = "ACGT";
        const char* lo = "acgt";
        for (int i = 0; i < 4; i++) {
            ENC[(uint8_t)up[i]] = (uint8_t)(i + 1);
            ENC[(uint8_t)lo[i]] = (uint8_t)(i + 1);
        }
        uint8_t comp[256];
        for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
        const char* a = "ATGCatgc";
        const char* b = "TACGtacg";
        for (int i = 0; i < 8; i++) comp[(uint8_t)a[i]] = (uint8_t)b[i];
        for (int i = 0; i < 256; i++) RC_ENC[i] = ENC[comp[i]];
    }
} lut_init;

// the members of one k-mer: its key and first member, how many, and the
// codes before and after them (one bit a code)
struct Group {
    u64 key;
    i64 pos;
    i64 size;
    uint8_t prev_or, next_or;
    bool terminal;
};

// per-strand instance lists sorted by (chr, pos), as BifEnumeration holds
// them: pos strand-local
struct Strands {
    std::vector<i64> chr[2], pos[2];
    std::vector<uint32_t> id[2];
};

struct Scratch {
    std::vector<uint8_t> codes;
    std::vector<int32_t> slot, grp_at, counted;
    std::vector<u64> slot_h;
    std::vector<Group> groups;
    std::vector<uint32_t> gid;
    Strands st;
    // the walk's: each bifurcation's least start and end distance, its
    // copy, and the least on another copy
    std::vector<i64> s1, s2, e1, e2;
    std::vector<int32_t> sc, ec;
    // each copy's own marks, bucketed by copy
    std::vector<i64> own_off, fill, own_x;
    std::vector<uint32_t> own_g;
};

thread_local Scratch S;

// The enumeration of `n` copies (`chars`, their lengths `lens`, laid end to
// end) at k into S.st; returns the number of bifurcations.
i64 enumerate(const uint8_t* chars, const i64* lens, int n, i64 k) {
    Strands& st = S.st;
    for (int s = 0; s < 2; s++) {
        st.chr[s].clear();
        st.pos[s].clear();
        st.id[s].clear();
    }
    if (n <= 0) return 0;
    i64 total = 0;
    for (int c = 0; c < n; c++) total += lens[c];
    const i64 rows = 1 + 2 * (total + n);
    std::vector<uint8_t>& codes = S.codes;
    codes.assign((size_t)rows, 0);
    i64 off = 1;
    const uint8_t* src = chars;
    for (int c = 0; c < n; c++) {
        for (i64 j = 0; j < lens[c]; j++) codes[off + j] = ENC[src[j]];
        src += lens[c];
        off += lens[c] + 1;
    }
    src = chars;  // then the copies' reverse complements, in copy order
    for (int c = 0; c < n; c++) {
        for (i64 j = 0; j < lens[c]; j++)
            codes[off + j] = RC_ENC[src[lens[c] - 1 - j]];
        src += lens[c];
        off += lens[c] + 1;
    }

    // valid windows (no separator in [i, i + k), i.e. i + k <= the next
    // separator at or after i; the last row is one, so i + k < rows),
    // grouped by k-mer in a hash table: a key of the first min(k, 32)
    // codes, 2 bits each, first code highest (so that keys order as
    // k-mers do), and beyond 32 codes a polynomial hash of the window with
    // every match checked byte for byte.  Both roll from the right.
    const int m = (int)std::min<i64>(k, 32);
    const u64 B = 0x9E3779B97F4A7C15ULL;
    u64 b_k = 1;
    for (i64 j = 0; j < k; j++) b_k *= B;
    int shift = 64 - 4;
    while ((1LL << (64 - shift)) < 2 * rows) shift--;
    const size_t cap = (size_t)1 << (64 - shift);
    S.slot.assign(cap, -1);
    S.slot_h.resize(cap);
    S.grp_at.assign((size_t)rows, -1);
    S.groups.clear();
    int32_t* slot = S.slot.data();
    u64* slot_h = S.slot_h.data();
    int32_t* grp_at = S.grp_at.data();
    std::vector<Group>& groups = S.groups;
    const uint8_t* cd = codes.data();
    {
        i64 next_sep = rows;
        u64 key = 0, roll = 0;
        for (i64 i = rows - 1; i >= 0; i--) {
            const uint8_t c = cd[i];
            key = (key >> 2) | ((u64)((c - 1) & 3) << (2 * (m - 1)));
            if (k > 32) roll = c + B * roll - (i + k < rows ? cd[i + k] : 0) * b_k;
            if (c == 0) {
                next_sep = i;
                continue;
            }
            if (i + k > next_sep) continue;
            const u64 h = k <= 32 ? key : key ^ (roll * 0xFF51AFD7ED558CCDULL);
            size_t at = (size_t)((h * B) >> shift);
            int32_t g = -1;
            for (; slot[at] >= 0; at = (at + 1) & (cap - 1)) {
                if (slot_h[at] == h &&
                    (k <= 32 || std::memcmp(cd + groups[slot[at]].pos, cd + i,
                                            (size_t)k) == 0)) {
                    g = slot[at];
                    break;
                }
            }
            if (g < 0) {
                g = (int32_t)groups.size();
                groups.push_back(Group{key, i, 0, 0, 0, false});
                slot[at] = g;
                slot_h[at] = h;
            }
            Group& gr = groups[g];
            const uint8_t p = cd[i - 1], q = cd[i + k];
            gr.size++;
            gr.prev_or |= (uint8_t)(1u << p);
            gr.next_or |= (uint8_t)(1u << q);
            gr.terminal |= p == 0 || q == 0;
            grp_at[i] = g;
        }
    }

    // a group is a bifurcation where the preceding or the following codes
    // of its members take more than one value or touch a separator, counted
    // with two members or more or any member next to a separator
    // (vertexenumeration.cpp:67-70, 348); ids dense in k-mer order
    auto bif = [](unsigned bits) {
        return __builtin_popcount(bits) > 1 || (bits & 1);
    };
    std::vector<int32_t>& counted = S.counted;
    counted.clear();
    for (size_t g = 0; g < groups.size(); g++) {
        const Group& gr = groups[g];
        if ((bif(gr.prev_or) || bif(gr.next_or)) &&
            (gr.size > 1 || gr.terminal))
            counted.push_back((int32_t)g);
    }
    const size_t rest = k > 32 ? (size_t)(k - 32) : 0;
    std::sort(counted.begin(), counted.end(),
              [&groups, cd, rest](int32_t a, int32_t b) {
                  const Group &x = groups[a], &y = groups[b];
                  if (x.key != y.key) return x.key < y.key;
                  return rest && std::memcmp(cd + x.pos + 32, cd + y.pos + 32,
                                             rest) < 0;
              });
    S.gid.assign(groups.size(), NO_ID);
    uint32_t* gid = S.gid.data();
    for (size_t r = 0; r < counted.size(); r++)
        gid[counted[r]] = (uint32_t)r;
    const i64 count = (i64)counted.size();

    // per strand in (chr, pos) order: the supergenome's own order
    off = 1;
    for (int blk = 0; blk < 2 * n; blk++) {
        const int s = blk < n ? 0 : 1;
        const int c = blk < n ? blk : blk - n;
        for (i64 j = 0; j < lens[c]; j++) {
            const int32_t g = grp_at[off + j];
            const uint32_t id = g < 0 ? NO_ID : gid[g];
            if (id != NO_ID) {
                st.chr[s].push_back(c);
                st.pos[s].push_back(j);
                st.id[s].push_back(id);
            }
        }
        off += lens[c] + 1;
    }
    return count;
}

inline i64 dist(i64 a, i64 b) { return a > b ? a - b : b - a; }

// keep (v, c) in the least value (a1, c1) and the least value a2 on another
// copy than c1
inline void least_two(i64& a1, int32_t& c1, i64& a2, i64 v, int32_t c) {
    if (v < a1) {
        if (c != c1) a2 = a1;
        a1 = v;
        c1 = c;
    } else if (c != c1 && v < a2) {
        a2 = v;
    }
}

// The walk over the instance lists of `count` bifurcations, m[s] on
// strand s; out[3 i] = 1 where copy i is kept, out[3 i + 1] its new start
// within the copy, out[3 i + 2] its new length.  Returns 1 where some copy
// shares no trim_k-mer with another (the caller loops to the fixpoint).
i64 walk(const i64* lens, const int8_t* dirs, int n, i64 k, i64 min_size,
         i64 count, const i64* m, const i64* const* chr,
         const i64* const* pos, const uint32_t* const* ids, i64* out) {
    S.s1.assign((size_t)count, FAR);
    S.s2.assign((size_t)count, FAR);
    S.e1.assign((size_t)count, FAR);
    S.e2.assign((size_t)count, FAR);
    S.sc.assign((size_t)count, -1);
    S.ec.assign((size_t)count, -1);
    S.own_off.assign((size_t)n + 1, 0);
    i64 *s1 = S.s1.data(), *s2 = S.s2.data(), *e1 = S.e1.data(),
        *e2 = S.e2.data(), *own_off = S.own_off.data();
    int32_t *sc = S.sc.data(), *ec = S.ec.data();
    // a copy's begin and end in the positive frame (its direction's)
    auto begin_of = [&](int c) { return dirs[c] == 0 ? 0 : lens[c] - 1; };
    auto end_of = [&](int c) { return dirs[c] == 0 ? lens[c] - 1 : 0; };
    for (int s = 0; s < 2; s++) {
        for (i64 j = 0; j < m[s]; j++) {
            const int c = (int)chr[s][j];
            const i64 x = s == 0 ? pos[s][j] : lens[c] - 1 - pos[s][j];
            const uint32_t g = ids[s][j];
            least_two(s1[g], sc[g], s2[g], dist(x, begin_of(c)), c);
            least_two(e1[g], ec[g], e2[g], dist(x, end_of(c)), c);
            if (dirs[c] == s) own_off[c + 1]++;
        }
    }
    // each copy's own marks (its instances on its direction's strand),
    // bucketed by copy: positive-frame coordinate and id
    for (int c = 0; c < n; c++) own_off[c + 1] += own_off[c];
    S.own_x.resize((size_t)own_off[n]);
    S.own_g.resize((size_t)own_off[n]);
    S.fill.assign(own_off, own_off + n);
    for (int s = 0; s < 2; s++) {
        for (i64 j = 0; j < m[s]; j++) {
            const int c = (int)chr[s][j];
            if (dirs[c] != s) continue;
            const i64 at = S.fill[c]++;
            S.own_x[at] = s == 0 ? pos[s][j] : lens[c] - 1 - pos[s][j];
            S.own_g[at] = ids[s][j];
        }
    }
    i64 drop = 0;
    for (int i = 0; i < n; i++) {
        const int d = dirs[i];
        const i64 L = lens[i];
        // the lexicographic least (sum, id, walk index) for the start and
        // for the end, and its own mark's coordinate
        i64 best_s = OO, best_e = OO, w_s = 0, w_e = 0;
        uint32_t g_s = 0, g_e = 0;
        i64 trim_start = 0, trim_end = 0;
        bool found = false;
        for (i64 j = own_off[i]; j < own_off[i + 1]; j++) {
            const i64 x = S.own_x[j];
            const uint32_t g = S.own_g[j];
            const i64 ps = sc[g] != i ? s1[g] : s2[g];
            if (ps >= FAR) continue;  // no instance on another copy
            const i64 pe = ec[g] != i ? e1[g] : e2[g];
            const i64 w = d == 0 ? x : L - 1 - x;
            const i64 now_s = ps + dist(x, begin_of(i));
            const i64 now_e = pe + dist(x, end_of(i));
            if (!found || now_s < best_s ||
                (now_s == best_s && (g < g_s || (g == g_s && w < w_s)))) {
                best_s = now_s;
                g_s = g;
                w_s = w;
                trim_start = x;
            }
            if (!found || now_e < best_e ||
                (now_e == best_e && (g < g_e || (g == g_e && w < w_e)))) {
                best_e = now_e;
                g_e = g;
                w_e = w;
                trim_end = x;
            }
            found = true;
        }
        i64* o = out + 3 * i;
        o[0] = o[1] = o[2] = 0;
        if (found && best_s < OO && best_e < OO) {
            if (dist(trim_start, trim_end) + k >= min_size) {
                const i64 te = d == 0 ? trim_end + (k - 1) : trim_end - (k - 1);
                o[0] = 1;
                o[1] = std::min(trim_start, te);
                o[2] = std::max(trim_start, te) + 1 - o[1];
            }
        } else {
            drop = 1;
        }
    }
    return drop;
}

}  // namespace

extern "C" {

// One round over `n` copies laid end to end in `chars` (after the
// ambiguous bases were drawn), with their lengths and directions.
long long trim_round(const uint8_t* chars, const i64* lens,
                     const int8_t* dirs, int n, i64 k, i64 min_size,
                     i64* out) {
    const i64 count = enumerate(chars, lens, n, k);
    const Strands& st = S.st;
    const i64 m[2] = {(i64)st.chr[0].size(), (i64)st.chr[1].size()};
    const i64* chr[2] = {st.chr[0].data(), st.chr[1].data()};
    const i64* pos[2] = {st.pos[0].data(), st.pos[1].data()};
    const uint32_t* ids[2] = {st.id[0].data(), st.id[1].data()};
    return walk(lens, dirs, n, k, min_size, count, m, chr, pos, ids, out);
}

// The walk alone over an enumeration of `count` bifurcations made
// elsewhere: per strand m_s instances, chr and pos as int64, ids uint32.
long long trim_walk(const i64* lens, const int8_t* dirs, int n, i64 k,
                    i64 min_size, i64 count, i64 m0, const i64* chr0,
                    const i64* pos0, const uint32_t* id0, i64 m1,
                    const i64* chr1, const i64* pos1, const uint32_t* id1,
                    i64* out) {
    const i64 m[2] = {m0, m1};
    const i64* chr[2] = {chr0, chr1};
    const i64* pos[2] = {pos0, pos1};
    const uint32_t* ids[2] = {id0, id1};
    return walk(lens, dirs, n, k, min_size, count, m, chr, pos, ids, out);
}

// The enumeration alone: instance lists into caller arrays that hold the
// copies' total length each; sizes[s] their lengths.  Returns the count.
long long trim_enum(const uint8_t* chars, const i64* lens, int n, i64 k,
                    i64* chr0, i64* pos0, uint32_t* id0, i64* chr1,
                    i64* pos1, uint32_t* id1, i64* sizes) {
    const i64 count = enumerate(chars, lens, n, k);
    const Strands& st = S.st;
    i64* chr[2] = {chr0, chr1};
    i64* pos[2] = {pos0, pos1};
    uint32_t* ids[2] = {id0, id1};
    for (int s = 0; s < 2; s++) {
        const size_t z = st.chr[s].size();
        sizes[s] = (i64)z;
        std::memcpy(chr[s], st.chr[s].data(), z * sizeof(i64));
        std::memcpy(pos[s], st.pos[s].data(), z * sizeof(i64));
        std::memcpy(ids[s], st.id[s].data(), z * sizeof(uint32_t));
    }
    return count;
}

}  // extern "C"
