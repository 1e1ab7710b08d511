// Block generation's host edge pipeline (blocks/synteny.py::
// generate_synteny_blocks) as columns: the condensed graph's edge table
// listed, filtered, grouped and ordered in one call, and one group's
// overlap claims.
//
// The table is blocks/edges.py::list_edges over the index's marks
// (reference: BlockFinder::ListEdges, serialization.cpp:56-86), the
// original_length >= min_size filter, GroupBy by the natural key
// (startVertex, endVertex, firstChar) (common.h:150-160, edge.cpp:24-38),
// the groups sorted by size, greater first, and each group's edges by
// direction (synteny.cpp:229-260).  Every sort is libstdc++'s std::sort,
// as in the reference, on a permutation of row indices with the
// reference's comparators: core/stdsort.py mirrors that introsort step for
// step, so the permutation equals its own, ties included.
//
// The claims are blocks/synteny.py::resolve_overlap's rule (reference:
// synteny.cpp:124-166): each edge of a group, in order, takes the first
// maximal run of maximum length of its original span that is free in the
// global occupancy and not claimed by an earlier edge of the group, when
// that run is at least min_size long.  The group's own claims are a short
// interval list; the global occupancy is read, never written (the caller
// commits a block's claims after trimming).
//
// C ABI for ctypes (native/__init__.py: edge_table, overlap_claims).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

typedef int64_t i64;

const i64 NO_BIFURCATION = (1LL << 32) - 1;

// graph/sequence.py's COMP_LUT: ATGC and atgc complemented, every other
// byte itself
uint8_t COMP[256];
struct CompInit {
    CompInit() {
        for (int i = 0; i < 256; i++) COMP[i] = (uint8_t)i;
        const char* a = "ATGCatgc";
        const char* b = "TACGtacg";
        for (int i = 0; i < 8; i++) COMP[(uint8_t)a[i]] = (uint8_t)b[i];
    }
} comp_init;

// the table's columns, in blocks/edges.py::Edge's field order
struct Columns {
    std::vector<int32_t> chr;
    std::vector<int8_t> dir;
    std::vector<i64> sv, ev, apos, alen, opos, olen;
    std::vector<uint8_t> fch;
};

struct Bounds {
    i64 begin, end;
};

struct Table {
    Columns rows;                // in list order, filtered
    std::vector<i64> perm;       // the final order of the rows
    std::vector<Bounds> groups;  // in their final order
};

thread_local Table T;

}  // namespace

extern "C" {

// The edge table of `n` chromosomes of lengths `lens`: per strand s and
// chromosome c the index's marks bif_s[c] (node index, -1 for none) with
// the nodes' bifurcation ids `node_bif` (`n_nodes` of them), the bases
// chars[c] and original positions origpos[c]; edges of original length
// below `min_size` left out.  Holds the result for edge_table_fetch and
// returns the number of edges; groups[0] the number of groups.  -1 where a
// mark's edge reaches outside its chromosome or a mark names no node.
long long edge_table(int n, const i64* lens, const i64* const* bif0,
                     const i64* const* bif1, const i64* node_bif,
                     i64 n_nodes, const uint8_t* const* chars,
                     const int32_t* const* origpos, i64 k, i64 min_size,
                     i64* groups) {
    T = Table();
    Columns& r = T.rows;
    for (int s = 0; s < 2; s++) {
        const i64* const* bif = s == 0 ? bif0 : bif1;
        for (int c = 0; c < n; c++) {
            const i64* arr = bif[c];
            const i64 L = lens[c];
            bool seen = false;
            i64 prev_t = 0, prev_vertex = NO_BIFURCATION;
            // the marks in walk order: t is the walk distance from the
            // chromosome's begin on strand s
            for (i64 t = 0; t < L; t++) {
                const i64 coord = s == 0 ? t : L - 1 - t;
                const i64 node = arr[coord];
                if (node < 0) continue;
                if (node >= n_nodes) return -1;
                if (!seen) {
                    seen = true;
                    const i64 b = arr[s == 0 ? 0 : L - 1];
                    prev_vertex = b < 0 ? NO_BIFURCATION : node_bif[b];
                }
                if (t == 0) {
                    prev_t = 0;
                    continue;
                }
                const i64 a = prev_t, step = t - a;
                const i64 origin = s == 0 ? a : L - 1 - a;
                const i64 fc_at = s == 0 ? origin + k : origin - k;
                const i64 last = s == 0 ? t + k - 1 : L - 1 - (t + k - 1);
                if (fc_at < 0 || fc_at >= L || last < 0 || last >= L)
                    return -1;
                const i64 now_vertex = node_bif[node];
                const i64 o1 = origpos[c][origin], o2 = origpos[c][last];
                const i64 ostart = std::min(o1, o2);
                const i64 olen = std::max(o1, o2) + 1 - ostart;
                if (olen >= min_size) {
                    const uint8_t ch = chars[c][fc_at];
                    r.chr.push_back(c);
                    r.dir.push_back((int8_t)s);
                    r.sv.push_back(prev_vertex);
                    r.ev.push_back(now_vertex);
                    r.apos.push_back(s == 0 ? a : L - (a + step + k));
                    r.alen.push_back(step + k);
                    r.opos.push_back(ostart);
                    r.olen.push_back(olen);
                    r.fch.push_back(s == 0 ? ch : COMP[ch]);
                }
                prev_vertex = now_vertex;
                prev_t = t;
            }
        }
    }
    const i64 m = (i64)r.chr.size();
    std::vector<i64>& perm = T.perm;
    perm.resize((size_t)m);
    std::iota(perm.begin(), perm.end(), 0);
    const i64 *sv = r.sv.data(), *ev = r.ev.data();
    const uint8_t* fch = r.fch.data();
    const int8_t* dir = r.dir.data();
    auto natural = [sv, ev, fch](i64 a, i64 b) {
        if (sv[a] != sv[b]) return sv[a] < sv[b];
        if (ev[a] != ev[b]) return ev[a] < ev[b];
        return fch[a] < fch[b];
    };
    std::sort(perm.begin(), perm.end(), natural);
    // GroupBy: the runs of elements no greater than their run's first
    std::vector<Bounds>& g = T.groups;
    for (i64 now = 0; now < m;) {
        const i64 prev = now;
        while (now < m && !natural(perm[prev], perm[now])) now++;
        g.push_back(Bounds{prev, now});
    }
    std::sort(g.begin(), g.end(), [](const Bounds& a, const Bounds& b) {
        return (a.end - a.begin) > (b.end - b.begin);
    });
    for (const Bounds& b : g)
        std::sort(perm.begin() + b.begin, perm.begin() + b.end,
                  [dir](i64 x, i64 y) { return dir[x] < dir[y]; });
    groups[0] = (i64)g.size();
    return m;
}

// The table of the last edge_table call in its final order, into caller
// arrays of its length (chr int32, dir int8, the six int64 columns, first
// char uint8), and the groups' (begin, end) rows into `bounds`.
void edge_table_fetch(int32_t* chr, int8_t* dir, i64* sv, i64* ev,
                      i64* apos, i64* alen, i64* opos, i64* olen,
                      uint8_t* fch, i64* bounds) {
    const Columns& r = T.rows;
    const size_t m = T.perm.size();
    for (size_t i = 0; i < m; i++) {
        const i64 j = T.perm[i];
        chr[i] = r.chr[j];
        dir[i] = r.dir[j];
        sv[i] = r.sv[j];
        ev[i] = r.ev[j];
        apos[i] = r.apos[j];
        alen[i] = r.alen[j];
        opos[i] = r.opos[j];
        olen[i] = r.olen[j];
        fch[i] = r.fch[j];
    }
    for (size_t i = 0; i < T.groups.size(); i++) {
        bounds[2 * i] = T.groups[i].begin;
        bounds[2 * i + 1] = T.groups[i].end;
    }
    T = Table();  // nothing held between block generations
}

// One group's claims: `n` edges, each five int64s in `rows` (chromosome,
// original start, original length, the length of the chromosome's
// occupancy array and that int8 array's address).  out[3 i] = 1 where edge
// i claims, out[3 i + 1] the claimed run's start, out[3 i + 2] its length.
// Returns the number of claims.
long long overlap_claims(int n, const i64* rows, i64 min_size, i64* out) {
    struct Claim {
        i64 chr, lo, hi;
    };
    std::vector<Claim> claims;
    std::vector<uint8_t> free_;
    long long made = 0;
    for (int i = 0; i < n; i++) {
        const i64* e = rows + 5 * i;
        const i64 chr = e[0], start = e[1];
        // numpy's slice [start, start + length) of an array of e[3]
        const i64 end = std::min(start + e[2], e[3]);
        const i64 len = std::max<i64>(end - start, 0);
        const int8_t* glob = reinterpret_cast<const int8_t*>(e[4]);
        free_.resize((size_t)len);
        for (i64 p = 0; p < len; p++) free_[p] = glob[start + p] == 0;
        for (const Claim& c : claims) {
            if (c.chr != chr) continue;
            const i64 lo = std::max(c.lo, start), hi = std::min(c.hi, end);
            if (lo < hi) std::memset(free_.data() + (lo - start), 0,
                                     (size_t)(hi - lo));
        }
        // the first maximal free run of maximum length
        i64 best_lo = 0, best_len = 0;
        for (i64 p = 0; p < len;) {
            if (!free_[p]) {
                p++;
                continue;
            }
            const i64 lo = p;
            while (p < len && free_[p]) p++;
            if (p - lo > best_len) {
                best_lo = lo;
                best_len = p - lo;
            }
        }
        i64* o = out + 3 * i;
        if (best_len >= min_size) {
            claims.push_back(Claim{chr, start + best_lo,
                                   start + best_lo + best_len});
            o[0] = 1;
            o[1] = start + best_lo;
            o[2] = best_len;
            made++;
        } else {
            o[0] = o[1] = o[2] = 0;
        }
    }
    return made;
}

}  // extern "C"
