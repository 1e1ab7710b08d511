// Event sweep of the LAGAN anchors stage, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by align/anchors_device.py.
//
// Replaces the lax.scan of sibelia_tpu/align/anchors_device.py::
// _sweep_device (lines 226-251) with its final pick (252-256): the
// weighted longest-increasing-subsequence sweep over the 2n ordered start
// and end events of n hits, keeping sofar f32[n], bk i32[n], alive[n].
//   find_lt(key): among alive entries with a_e < key the largest a_e, then
//                 the largest sofar, then the first index;
//   start of h:   (any, hs, p) = find_lt(a_s[h]); chain = any & hs > 0;
//                 sofar[h] = score[h] + (chain ? hs : 0); bk[h] = chain ? p : -1
//   end of h:     (any, hs, _) = find_lt(a_e[h]); refuse = any & hs > sofar[h];
//                 unless refused, every other alive entry with a_e >= a_e[h]
//                 and sofar <= sofar[h] dies; alive[h] = !refuse
//   final pick:   the largest sofar among alive, then the smallest a_e, then
//                 the first index.
//
// Bound: the chain of 2n dependent events (bytes are O(n)).  One call
// serves the sets of every pair of a recursion level, in two classes (a
// launch each, over a table of the class's sets):
//   * k_anchors_sweep_warp, n <= 32 (every set of a real C-Sibelia run has
//     1-13 hits): a warp a set, eight sets a block, a lane a hit.  a_s,
//     a_e, score, sofar, alive and bk live in registers, and so do the 2n
//     <= 64 events (two a lane); an event's hit, key and score come by
//     shuffle; find_lt is three hardware warp reductions (a_e, then sofar
//     as order-preserving bits, then the index).  No barrier, no shared
//     memory, no load in the event loop;
//   * k_anchors_sweep, n >= 33: a block a set ranks the hits once, then a
//     warp runs the events over the alive staircase, a bit set over the
//     ranks (see the kernel): an event is a few dependent shared-memory
//     loads and not a block-wide maximum over n lanes.  The bit set and
//     sofar lie in shared memory where they fit, else in device memory:
//     no size at which the sweep gives up.  It needs one start and one
//     later end a hit (event_order's lists; anchors_device.sweep checks).
//
// float32 exactness: sofar[h] is one float add, and every comparison is
// made on those float32 values or on their order-preserving bits, which
// order as the floats do (a zero is mapped as +0, so -0 equals +0 as it
// does for a float compare).  No fast-math flag.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -3.4e38f;  // "no entry" of a float maximum
constexpr int IMIN = -2147483647;  // "no entry" of an a_e maximum
constexpr int IMAX = 2147483647;

// Bits that order as the floats do (no NaN); 0 is below every float.
__device__ __forceinline__ unsigned ordered(float f) {
  unsigned u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;  // -0 compares equal to +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

struct Pick {
  int ae;       // IMIN when there is none
  unsigned sb;  // ordered bits of sofar, 0 when there is none
  int idx;      // IMAX when there is none
};

// Over the block: the largest ae, among those the largest sb, among those
// the smallest idx.  One barrier when the block has several warps; the
// caller's next barrier comes before s_* are written again.
__device__ __forceinline__ Pick block_pick(Pick v, int* s_ae, unsigned* s_sb,
                                           int* s_idx) {
  for (int level = 0; level < 2; ++level) {
    const int ae = __reduce_max_sync(FULL, v.ae);
    const unsigned sb = __reduce_max_sync(FULL, v.ae == ae ? v.sb : 0u);
    const int idx = __reduce_min_sync(
        FULL, (v.ae == ae && v.sb == sb) ? v.idx : IMAX);
    v = Pick{ae, sb, idx};
    if (blockDim.x == 32 || level == 1) break;
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    if (lane == 0) {
      s_ae[threadIdx.x >> 5] = ae;
      s_sb[threadIdx.x >> 5] = sb;
      s_idx[threadIdx.x >> 5] = idx;
    }
    __syncthreads();
    v = lane < warps ? Pick{s_ae[lane], s_sb[lane], s_idx[lane]}
                     : Pick{IMIN, 0u, IMAX};
  }
  return v;
}

// ---- the staircase (n >= 33) ---------------------------------------------

constexpr int MAXL = 7;  // levels of the alive bit set: 32^7 > 2^31 ranks
constexpr int SORT_SHARED_KEYS = 4096;     // keys sorted in shared memory
constexpr int BITS_SHARED_WORDS = 16384;   // bit-set words in shared memory
constexpr int SCRATCH_A_HIT = 80;          // device scratch a hit, a set
constexpr int SCRATCH_A_SET = 256;

// The alive ranks as a bit set of `levels` levels, level 0 first: bit j of
// word q of level l > 0 is set when word 32 q + j of level l - 1 is not 0.
// The first word and the words of each level (lvl, cnt: MAXL ints in shared
// memory, so that a level's offset is one load).  Each query looks at level
// 0 first and climbs only when that word has nothing: a lone warp pays for
// every instruction on its path.
struct Bits {
  unsigned* w;
  const int* lvl;
  const int* cnt;
  int levels;

  __device__ __forceinline__ bool test(int r) const {
    return (w[r >> 5] >> (r & 31)) & 1u;
  }
  // The highest set rank at or below i, or -1.
  __device__ __forceinline__ int prev(int i) const {
    if (i < 0) return -1;
    unsigned m = w[i >> 5] & (0xffffffffu >> (31 - (i & 31)));
    if (m) return (i & ~31) + 31 - __clz(m);
    int l = 0;
    do {  // the highest word below word i >> 5 of level l that is not 0
      i = (i >> 5) - 1;
      if (++l == levels || i < 0) return -1;
      m = w[lvl[l] + (i >> 5)] & (0xffffffffu >> (31 - (i & 31)));
    } while (!m);
    i = (i & ~31) + 31 - __clz(m);
    while (--l >= 0) i = (i << 5) + 31 - __clz(w[lvl[l] + i]);
    return i;
  }
  // The lowest set rank at or above i, or -1.
  __device__ __forceinline__ int next(int i) const {
    if ((i >> 5) >= cnt[0]) return -1;
    unsigned m = w[i >> 5] & (0xffffffffu << (i & 31));
    if (m) return (i & ~31) + __ffs(m) - 1;
    int l = 0;
    do {
      i = (i >> 5) + 1;
      if (++l == levels || (i >> 5) >= cnt[l]) return -1;
      m = w[lvl[l] + (i >> 5)] & (0xffffffffu << (i & 31));
    } while (!m);
    i = (i & ~31) + __ffs(m) - 1;
    while (--l >= 0) i = (i << 5) + __ffs(w[lvl[l] + i]) - 1;
    return i;
  }
  // Rank r set; a word that was 0 sets its bit above.
  __device__ __forceinline__ void insert(int r) const {
    unsigned* a = w + (r >> 5);
    unsigned old = *a;
    *a = old | 1u << (r & 31);
    for (int l = 1; old == 0u && l < levels; ++l) {
      r >>= 5;
      a = w + lvl[l] + (r >> 5);
      old = *a;
      *a = old | 1u << (r & 31);
    }
  }
  // Level-0 word q becomes `word`; a word that empties clears its bit above.
  __device__ __forceinline__ void set_word(int q, unsigned word) const {
    w[q] = word;
    for (int l = 1; word == 0u && l < levels; ++l) {
      const int bit = q & 31;
      q >>= 5;
      unsigned* a = w + lvl[l] + q;
      word = *a & ~(1u << bit);
      *a = word;
    }
  }
};

// The 2n events of a set over the alive staircase, by one warp (see
// k_anchors_sweep): sofar by rank `sf` (pad32(n) floats) and the bit set's
// words `bw` in shared memory (SF_SH, BITS_SH: so that the compiler knows it
// and loads from there) or device memory.  What an event reads before it
// knows the answer of its query goes out at once: its key's word of the
// bit set (the query's and the kill's first word), a lane a rank of sofar
// there, and sofar[R].  Every lane runs every event and writes the same
// values to the same places, so that no lane reads another's write; the
// shuffles and the ballot keep the warp together.
template <bool SF_SH, bool BITS_SH>
__device__ __forceinline__ void staircase_events(
    const int4* info, int ne, float* sf_at, unsigned* bw_at, const int* lvl,
    const int* cnt, int levels, int* bk, int lane) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  float* sf = SF_SH ? reinterpret_cast<float*>(s_dyn + (
                          reinterpret_cast<uint8_t*>(sf_at) - s_dyn))
                    : sf_at;
  unsigned* bw = BITS_SH ? reinterpret_cast<unsigned*>(s_dyn + (
                               reinterpret_cast<uint8_t*>(bw_at) - s_dyn))
                         : bw_at;
  const Bits bits{bw, lvl, cnt, levels};
  // level 0's words; level 1 (n >= 33: there is one): its first word and
  // its words
  const int words = cnt[0], l1 = lvl[1], words1 = cnt[1];
  // events e .. e + 31 lie in `cur` (a lane each), the next 32 in `nxt`;
  // each event's fields are shuffled out one event ahead
  const int4 none = make_int4(0, 0, 0, 0);
  int4 cur = lane < ne ? info[lane] : none;
  int4 nxt = 32 + lane < ne ? info[32 + lane] : none;
  int kst = __shfl_sync(FULL, cur.x, 0), R = __shfl_sync(FULL, cur.y, 0);
  int h = __shfl_sync(FULL, cur.z, 0), scb = __shfl_sync(FULL, cur.w, 0);
  for (int e = 0; e < ne; ++e) {
    const int f = e + 1;
    if ((f & 31) == 0) {
      cur = nxt;
      nxt = f + 32 + lane < ne ? info[f + 32 + lane] : none;
    }
    const int kst_f = __shfl_sync(FULL, cur.x, f & 31);
    const int R_f = __shfl_sync(FULL, cur.y, f & 31);
    const int h_f = __shfl_sync(FULL, cur.z, f & 31);
    const int scb_f = __shfl_sync(FULL, cur.w, f & 31);
    const int K = kst & 0x7fffffff, q0 = K >> 5;
    const bool inside = q0 < words;
    const unsigned word0 = inside ? bw[q0] : 0u;
    const unsigned word1 = (q0 >> 5) < words1 ? bw[l1 + (q0 >> 5)] : 0u;
    const float v0 = inside ? sf[(q0 << 5) + lane] : 0.0f;
    const float s = sf[R];
    // find_lt: the last alive rank below K, in K's word, else in the last
    // word before it that level 1 marks there, else further down
    const unsigned below = word0 & ((1u << (K & 31)) - 1u);
    const unsigned below1 = word1 & ((1u << (q0 & 31)) - 1u);
    int p;
    if (below) {
      p = (q0 << 5) + 31 - __clz(below);
    } else if (below1) {
      const int qp = (q0 & ~31) + 31 - __clz(below1);
      p = (qp << 5) + 31 - __clz(bw[qp]);
    } else {
      p = bits.prev(((q0 >> 5) << 10) - 1);
    }
    const float hs = p >= 0 ? sf[p] : NEG;
    if (kst < 0) {
      const bool chain = p >= 0 && hs > 0.0f;
      sf[R] = __int_as_float(scb) + (chain ? hs : 0.0f);
      bk[h] = chain ? p : -1;  // a rank until the end
    } else if (!(p >= 0 && hs > s)) {
      // kill from K while sofar <= s: a word of ranks at a time
      int q = q0;
      unsigned word = word0, from = word0 & (0xffffffffu << (K & 31));
      // level 1's marks of the words after K's in its group of 32
      unsigned after1 = word1 & (0xfffffffeu << (q0 & 31));
      float v = v0;
      for (;;) {
        if (from) {
          const unsigned surv =
              __ballot_sync(FULL, ((from >> lane) & 1u) && v > s);
          const unsigned kill =
              surv ? from & ((surv & (0u - surv)) - 1u) : from;
          if (kill) {
            word &= ~kill;
            bits.set_word(q, word);
          }
          if (surv) break;
        }
        // the next word with an alive rank: the next that level 1 marks
        // in this word's group of 32, else the first in a later group
        int qn;
        if (after1) {
          qn = (q & ~31) + __ffs(after1) - 1;
          after1 &= after1 - 1u;
        } else {
          const int r = bits.next(((q >> 5) + 1) << 10);
          if (r < 0) break;
          qn = r >> 5;
          after1 = bw[l1 + (qn >> 5)] & (0xfffffffeu << (qn & 31));
        }
        q = qn;
        word = from = bw[q];
        v = sf[(q << 5) + lane];
      }
      // R's word is in hand when the kill ended there
      if ((R >> 5) == q && word != 0u) bw[q] = word | 1u << (R & 31);
      else bits.insert(R);
    }
    kst = kst_f;
    R = R_f;
    h = h_f;
    scb = scb_f;
  }
}

// Shared memory of a set of n hits: the bit set (when it fits), then either
// the keys of the sort (when they fit) or, after the sort, sofar by rank
// (n <= shared_hits).
struct Layout {
  int pow2, bit_words;
  bool bits_sh, keys_sh, sofar_sh;
  size_t bits_bytes, shared;
};

__host__ __device__ inline Layout layout_of(int n, int shared_hits) {
  Layout t;
  t.pow2 = 1;
  while (t.pow2 < n) t.pow2 <<= 1;
  t.bit_words = 0;
  for (int pos = n, l = 0; l < MAXL && (l == 0 || pos > 1); ++l) {
    pos = (pos + 31) >> 5;
    t.bit_words += pos;
  }
  t.bits_sh = t.bit_words <= BITS_SHARED_WORDS;
  t.keys_sh = t.pow2 <= SORT_SHARED_KEYS;
  t.sofar_sh = n <= shared_hits;
  t.bits_bytes = t.bits_sh ? (size_t)((t.bit_words + 3) & ~3) * 4 : 0;
  const size_t keys = t.keys_sh ? (size_t)t.pow2 * 8 : 0;
  const size_t sofar = t.sofar_sh ? (size_t)((n + 31) & ~31) * 4 : 0;
  t.shared = t.bits_bytes + (keys > sofar ? keys : sofar);
  return t;
}

// n >= 33: a block a set.  The hits are ranked by (a_e, end event, the
// later first), a bitonic sort of one 64-bit key a hit; every event's key
// rank (the hits with a_e below its key) and its hit's rank are found
// before the loop, by all threads.  Then one warp runs the 2n events over
// the alive staircase: among alive ranks sofar never falls (across a_e by
// the skiplist's invariant, inside a tie group because an insertion kills
// its group's members at or below its sofar and ranks before the
// survivors), so
//   find_lt(key) is the last alive rank below the key's rank (bits.prev),
//     the pick sofar[that rank], bk that rank (its hit at the end);
//   an unrefused end kills the alive ranks from its group's first rank on
//     while their sofar is at most its own (a prefix: a word of ranks at a
//     time, a lane a rank, one ballot), then sets its own;
//   the final pick is the first alive rank of the largest sofar, a block
//     reduction.
// An event is a few dependent shared-memory loads.  The events' ranks and
// the ranks' hits lie in device scratch; the bit set and sofar by rank in
// shared memory where they fit (Layout), else in the scratch.
__global__ void __launch_bounds__(512)
k_anchors_sweep(const int* __restrict__ a_s_all,
                const int* __restrict__ a_e_all,
                const float* __restrict__ score_all,
                const int* __restrict__ ev_hit_all,
                const int* __restrict__ ev_isstart_all,
                const long long* __restrict__ spans, int shared_hits,
                uint8_t* __restrict__ scratch_all,
                float* __restrict__ sofar_all,
                int* __restrict__ bk_all, int* __restrict__ best_out,
                float* __restrict__ best_val_out) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ int s_ae[32];
  __shared__ unsigned s_sb[32];
  __shared__ int s_idx[32];
  const long long lo = spans[3 * blockIdx.x];
  const int n = (int)(spans[3 * blockIdx.x + 1] - lo);
  const int set = (int)spans[3 * blockIdx.x + 2];
  const int* a_s = a_s_all + lo;
  const int* a_e = a_e_all + lo;
  const float* score = score_all + lo;
  const int* ev_hit = ev_hit_all + 2 * lo;
  const int* ev_isstart = ev_isstart_all + 2 * lo;
  float* sofar_out = sofar_all + lo;
  int* bk = bk_all + lo;
  const int tid = threadIdx.x, nthreads = blockDim.x, ne = 2 * n;
  const Layout t = layout_of(n, shared_hits);
  uint8_t* scratch =
      scratch_all + lo * SCRATCH_A_HIT + (long long)blockIdx.x * SCRATCH_A_SET;
  int4* info = reinterpret_cast<int4*>(scratch);
  unsigned long long* keys =
      t.keys_sh ? reinterpret_cast<unsigned long long*>(s_dyn + t.bits_bytes)
                : reinterpret_cast<unsigned long long*>(scratch + 32LL * n);
  int* end_of = reinterpret_cast<int*>(scratch + 48LL * n);
  int* rank_of = reinterpret_cast<int*>(scratch + 56LL * n);
  int* hit_of = reinterpret_cast<int*>(scratch + 60LL * n);
  float* sf = t.sofar_sh ? reinterpret_cast<float*>(s_dyn + t.bits_bytes)
                         : reinterpret_cast<float*>(scratch + 64LL * n);
  unsigned* bw = t.bits_sh ? reinterpret_cast<unsigned*>(s_dyn)
                           : reinterpret_cast<unsigned*>(
                                 scratch + 64LL * n + 4LL * ((n + 31) & ~31));
  __shared__ int s_lvl[MAXL], s_cnt[MAXL];
  int levels = 0;
  for (int pos = n, total = 0; levels < MAXL && (levels == 0 || pos > 1);
       ++levels) {
    pos = (pos + 31) >> 5;
    if (tid == 0) {
      s_lvl[levels] = total;
      s_cnt[levels] = pos;
    }
    total += pos;
  }
  const Bits bits{bw, s_lvl, s_cnt, levels};
  for (int i = tid; i < t.bit_words; i += nthreads) bw[i] = 0u;
  // each hit's end event
  for (int e = tid; e < ne; e += nthreads)
    if (!ev_isstart[e]) end_of[ev_hit[e]] = e;
  __syncthreads();
  // rank order: a_e as order-preserving bits, then the end event, the
  // later first
  for (int i = tid; i < t.pow2; i += nthreads)
    keys[i] = i < n ? (unsigned long long)((unsigned)a_e[i] ^ 0x80000000u) << 32
                          | (unsigned)~end_of[i]
                    : ~0ull;
  __syncthreads();
  for (int k = 2; k <= t.pow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < t.pow2 / 2; q += nthreads) {
        const int i = 2 * q - (q & (j - 1)), l = i + j;
        const unsigned long long x = keys[i], y = keys[l];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < n; r += nthreads) {
    const int h = ev_hit[~(unsigned)keys[r]];
    rank_of[h] = r;
    hit_of[r] = h;
  }
  __syncthreads();
  // each event: its key's rank (| 1 << 31 at a start), its hit's rank, the
  // hit, the hit's score
  for (int e = tid; e < ne; e += nthreads) {
    const int h = ev_hit[e], st = ev_isstart[e];
    const unsigned long long q =
        (unsigned long long)((unsigned)(st ? a_s[h] : a_e[h]) ^ 0x80000000u)
        << 32;
    int at = 0, end = n;
    while (at < end) {
      const int mid = (at + end) >> 1;
      if (keys[mid] < q) at = mid + 1;
      else end = mid;
    }
    info[e] = make_int4(at | (int)((unsigned)st << 31), rank_of[h], h,
                        __float_as_int(score[h]));
  }
  __syncthreads();  // the keys are done with: sf may take their place

  if (tid < 32) {
    if (t.sofar_sh)
      staircase_events<true, true>(info, ne, sf, bw, s_lvl, s_cnt, levels, bk,
                                   tid);
    else if (t.bits_sh)
      staircase_events<false, true>(info, ne, sf, bw, s_lvl, s_cnt, levels,
                                    bk, tid);
    else
      staircase_events<false, false>(info, ne, sf, bw, s_lvl, s_cnt, levels,
                                     bk, tid);
  }
  __syncthreads();

  // final pick: the largest sofar among alive, then the first rank (the
  // smallest a_e; no two alive ranks tie on both)
  Pick v{IMIN, 0u, IMAX};
  for (int r = tid; r < n; r += nthreads) {
    if (bits.test(r)) {
      const unsigned sb = ordered(sf[r]);
      if (sb > v.sb || v.idx == IMAX) v = Pick{0, sb, r};
    }
  }
  v = block_pick(v, s_ae, s_sb, s_idx);
  if (tid == 0) {
    const bool any = v.idx != IMAX;
    best_out[set] = any ? hit_of[v.idx] : 0;
    best_val_out[set] = any ? unordered(v.sb) : NEG;
  }
  for (int h = tid; h < n; h += nthreads) {
    sofar_out[h] = sf[rank_of[h]];
    const int b = bk[h];
    bk[h] = b >= 0 ? hit_of[b] : -1;
  }
}


constexpr int SET_WARPS = 8;  // sets a block in the warp-a-set kernel

// n <= 32: a warp a set, everything in registers (see the header).
__global__ void __launch_bounds__(SET_WARPS * 32)
k_anchors_sweep_warp(const int* __restrict__ a_s_all,
                     const int* __restrict__ a_e_all,
                     const float* __restrict__ score_all,
                     const int* __restrict__ ev_hit_all,
                     const int* __restrict__ ev_isstart_all,
                     const long long* __restrict__ spans, int n_sets,
                     float* __restrict__ sofar_all, int* __restrict__ bk_all,
                     int* __restrict__ best_out,
                     float* __restrict__ best_val_out) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * SET_WARPS + (threadIdx.x >> 5);
  if (slot >= n_sets) return;
  const long long lo = spans[3 * slot];
  const int n = (int)(spans[3 * slot + 1] - lo);
  const int set = (int)spans[3 * slot + 2];
  const bool mine = lane < n;
  const int as = mine ? a_s_all[lo + lane] : 0;
  const int ae = mine ? a_e_all[lo + lane] : 0;
  const float score = mine ? score_all[lo + lane] : 0.0f;
  const int ne = 2 * n;
  // events lane and 32 + lane: the hit, with bit 30 set at a start
  int ev0 = 0, ev1 = 0;
  if (lane < ne)
    ev0 = ev_hit_all[2 * lo + lane] | (ev_isstart_all[2 * lo + lane] << 30);
  if (32 + lane < ne)
    ev1 = ev_hit_all[2 * lo + 32 + lane]
          | (ev_isstart_all[2 * lo + 32 + lane] << 30);
  float sofar = 0.0f;
  int bk = -1;
  bool alive = false;

  for (int e = 0; e < ne; ++e) {
    const int ev = __shfl_sync(FULL, e < 32 ? ev0 : ev1, e & 31);
    const int h = ev & 31;
    const bool start = (ev >> 30) != 0;
    const int key = __shfl_sync(FULL, start ? as : ae, h);
    const float sc = __shfl_sync(FULL, score, h);
    // find_lt(key)
    const bool cand = alive && ae < key;
    const unsigned sb_i = ordered(sofar);
    const int m_ae = __reduce_max_sync(FULL, cand ? ae : IMIN);
    const bool c2 = cand && ae == m_ae;
    const unsigned m_sb = __reduce_max_sync(FULL, c2 ? sb_i : 0u);
    const int idx = __reduce_min_sync(FULL, (c2 && sb_i == m_sb) ? lane : IMAX);
    const bool any = idx != IMAX;
    const float hs = any ? unordered(m_sb) : NEG;
    if (start) {
      if (lane == h) {
        const bool chain = any && hs > 0.0f;
        sofar = sc + (chain ? hs : 0.0f);
        bk = chain ? idx : -1;
      }
    } else {
      const float sfh = __shfl_sync(FULL, sofar, h);
      const bool refuse = any && hs > sfh;
      if (lane == h) alive = !refuse;
      else if (!refuse && alive && ae >= key && sofar <= sfh) alive = false;
    }
  }

  // final pick: the largest sofar among alive, the smallest a_e, the first
  const unsigned sb_i = ordered(sofar);
  const unsigned m_sb = __reduce_max_sync(FULL, alive ? sb_i : 0u);
  const bool c1 = alive && sb_i == m_sb;
  const int m_ae = __reduce_min_sync(FULL, c1 ? ae : IMAX);
  const int idx = __reduce_min_sync(FULL, (c1 && ae == m_ae) ? lane : IMAX);
  if (lane == 0) {
    const bool any = idx != IMAX;
    best_out[set] = any ? idx : 0;
    best_val_out[set] = any ? unordered(m_sb) : NEG;
  }
  if (mine) {
    sofar_all[lo + lane] = sofar;
    bk_all[lo + lane] = bk;
  }
}

}  // namespace

// Bytes of device scratch k_anchors_sweep needs for n_sets sets of n_hits
// hits in all.
extern "C" long long anchors_sweep_scratch_bytes(long long n_hits,
                                                 int n_sets) {
  return n_hits * SCRATCH_A_HIT + (long long)n_sets * SCRATCH_A_SET;
}

// One launch of k_anchors_sweep for n_sets hit sets (each of 33 hits or
// more), a block each; spans: int64 [n_sets, 3], a set's first hit, the one
// past its last (events at twice the offset) and its number, where best and
// best_val go; max_hits: the largest of these sets; sofar by rank in shared
// memory up to shared_hits hits.  scratch: anchors_sweep_scratch_bytes of
// the sets, the first of them at hit 0.  Returns the CUDA error of the
// launch, 0 when it was accepted.
extern "C" int anchors_sweep_launch(
    const void* a_s, const void* a_e, const void* score, const void* ev_hit,
    const void* ev_isstart, const void* spans, int n_sets, int max_hits,
    int shared_hits, void* scratch, void* sofar, void* bk, void* best,
    void* best_val, void* stream) {
  if (n_sets <= 0) return 0;
  const int threads = max_hits <= SORT_SHARED_KEYS ? 256 : 512;
  // the most any set of the launch takes: a layout's shared bytes grow with
  // n up to SORT_SHARED_KEYS (the keys), then up to shared_hits (sofar),
  // then the bit set alone, at most BITS_SHARED_WORDS words
  size_t shared = layout_of(min(max_hits, SORT_SHARED_KEYS), shared_hits)
                      .shared;
  const size_t upto = layout_of(min(max_hits, shared_hits), shared_hits)
                          .shared;
  if (upto > shared) shared = upto;
  if (max_hits > shared_hits && shared < (size_t)BITS_SHARED_WORDS * 4)
    shared = (size_t)BITS_SHARED_WORDS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      k_anchors_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  k_anchors_sweep<<<n_sets, threads, shared, (cudaStream_t)stream>>>(
      (const int*)a_s, (const int*)a_e, (const float*)score,
      (const int*)ev_hit, (const int*)ev_isstart, (const long long*)spans,
      shared_hits, (uint8_t*)scratch, (float*)sofar, (int*)bk, (int*)best,
      (float*)best_val);
  return (int)cudaGetLastError();
}

// One launch of k_anchors_sweep_warp for n_sets hit sets (each of at most 32
// hits), a warp each; spans as above.
extern "C" int anchors_sweep_warp_launch(
    const void* a_s, const void* a_e, const void* score, const void* ev_hit,
    const void* ev_isstart, const void* spans, int n_sets, void* sofar,
    void* bk, void* best, void* best_val, void* stream) {
  if (n_sets <= 0) return 0;
  k_anchors_sweep_warp<<<(n_sets + SET_WARPS - 1) / SET_WARPS, SET_WARPS * 32,
                         0, (cudaStream_t)stream>>>(
      (const int*)a_s, (const int*)a_e, (const float*)score,
      (const int*)ev_hit, (const int*)ev_isstart, (const long long*)spans,
      n_sets, (float*)sofar, (int*)bk, (int*)best, (float*)best_val);
  return (int)cudaGetLastError();
}
