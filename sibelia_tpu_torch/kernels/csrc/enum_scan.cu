// Post-sort segment scan of the fused enumeration, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by kernels/enum_scan.py.
//
// Replaces the three Pallas TPU kernels of sibelia_tpu/kernels/enum_scan.py
// (_fwd_kernel, _bwd_kernel, _fin_kernel, one pallas_call site in
// _grid_call).  Those carry six running scalars through a sequential grid;
// here tiles of TILE rows run in parallel, so the scan is reduce-then-scan
// in three launches:
//
//   1. k_flags (one block a tile): reads the three key columns once, with
//      16-byte loads on neighbouring addresses, and computes per row
//      start and the verdict flag F.  It runs both segmented ORs of F
//      inside the tile and writes one byte for every 4 rows: the 4 start
//      bits and the 4 tile-local verdicts `counted`.  A verdict is final
//      for every segment that opens and closes inside the tile; only the
//      rows before the tile's first start and from its last start on wait
//      for the neighbours.  Per tile it leaves a 8-byte record: first and
//      last start, the ORs of F over those two open ends, and the id and
//      selected counts as far as they are known.
//   2. k_carries (one block): segmented-OR scans of the tile records in
//      both directions give each tile the verdicts of its two open ends;
//      with them its counts are exact, and their exclusive sum is the
//      tile's id offset.  Also the totals (n_groups, n_sel).  A warp takes
//      consecutive records, so its loads and stores are contiguous: one SM
//      does this pass, and its time is the count of sectors it touches.
//   3. k_write (one block a tile): reads the flag bytes and `order`,
//      patches the two open ends, and writes ids = cumsum(start &
//      selected) - 1 and poskey = selected ? order : fill with 16-byte
//      stores.
//
// Row algebra (the XLA formulation of sibelia_tpu/index/enum_device.py):
//   start[i] = i == 0 | i == nv | (sk1, sk2)[i] != (sk1, sk2)[i-1]
//   F[i]     = (!start[i] & aux[i] != aux[i-1])          (A: neighbour change)
//            | (aux[i] >> 3 == 0) | (aux[i] & 7 == 0)   (B: separator touch)
//   counted  = OR of F over the segment; selected = counted & i < nv.
// The forward OR restarts at a start row.  The backward OR is the scan of
// h[i] = start[i] ? 0 : F[i] | h[i+1] (what row i hands to row i-1), so it
// too needs the start flags only, and no row to the right of a tile.
//
// Bound: memory.  One read of the four input columns and one write of the
// two output columns is 24 B/row.  This design moves 12 + 0.25 B/row in
// pass 1 and 0.25 + 4 + 8 B/row in pass 3, 24.5 B/row in all, plus 26 bytes
// a tile of records; the row before each warp's 512 rows is read a second
// time (it is in cache: the neighbouring warp loads it).  Nothing spins on
// another block: the passes are ordered by the stream alone.  The scans
// inside a warp are read off two ballots (the elements have two bits), not
// shuffled in five steps: with 12 loads a thread in flight the first pass
// is otherwise short of instruction slots, not of bandwidth.  TMA and
// thread block clusters would save address arithmetic and registers,
// which do not limit a stream of plain 16-byte loads; there is no product
// here for the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUBS = 4;                      // 16-byte groups per thread
constexpr int SUB_ROWS = 32 * 4;             // rows of one load per lane
constexpr int WARP_ROWS = SUBS * SUB_ROWS;   // consecutive rows of a warp
constexpr int TILE = WARPS * WARP_ROWS;      // rows of a block: 4096
constexpr int CARRY_THREADS = 1024;
constexpr int CARRY_WARPS = CARRY_THREADS / 32;
constexpr int CARRY_ITEMS = 8;               // tiles per thread and chunk
constexpr int CARRY_SPAN = 32 * CARRY_ITEMS;  // consecutive tiles of a warp
constexpr int CARRY_CHUNK = CARRY_THREADS * CARRY_ITEMS;
constexpr unsigned FULL = 0xffffffffu;

// rec.x = first start | last start << 16 (offsets in the tile; TILE when
// the tile has no start).  rec.y = ids | selected << 13 | flags << 26.
constexpr int COUNT_MASK = 0x1fff;
constexpr int HAS_START = 1 << 26;
constexpr int PRE_F = 1 << 27;   // OR of F before the first start
constexpr int SUF_F = 1 << 28;   // OR of F from the last start on

// Segmented OR on 2-bit elements (flag << 1 | value): a set flag opens a
// new segment, so the value restarts there.  `a` precedes `b` in scan
// order; 0 is the identity.
struct SegOr {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return ((a | b) & 2) | ((b & 2) ? (b & 1) : ((a | b) & 1));
  }
};

template <typename T>
struct Add {
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// Rows r0 .. r0+3 of a column; rows at or past n read as 0.  r0 is a
// multiple of 4, so with `vec` (every column 16-byte aligned) a full group
// is one 16-byte load.
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long r0,
                                      long long n, int vec) {
  if (vec && r0 + 4 <= n) return __ldg(reinterpret_cast<const int4*>(p + r0));
  int4 v = make_int4(0, 0, 0, 0);
  if (r0 < n) v.x = p[r0];
  if (r0 + 1 < n) v.y = p[r0 + 1];
  if (r0 + 2 < n) v.z = p[r0 + 2];
  if (r0 + 3 < n) v.w = p[r0 + 3];
  return v;
}

__device__ __forceinline__ void store4(int* __restrict__ p, long long r0,
                                       long long n, int vec, int4 v) {
  if (vec && r0 + 4 <= n) {
    *reinterpret_cast<int4*>(p + r0) = v;
    return;
  }
  if (r0 < n) p[r0] = v.x;
  if (r0 + 1 < n) p[r0 + 1] = v.y;
  if (r0 + 2 < n) p[r0 + 2] = v.z;
  if (r0 + 3 < n) p[r0 + 3] = v.w;
}

// Bits j in 0..3 with j < d.
__device__ __forceinline__ int low_mask(int d) {
  return d <= 0 ? 0 : d >= 4 ? 15 : (1 << d) - 1;
}

// d as an int that low_mask and one_bit read the same way, after any
// offset inside a tile is taken off.
__device__ __forceinline__ int clamped(long long d) {
  return (int)max(-1LL, min(d, 2LL * TILE));
}

// Bit d where d is in 0..3.
__device__ __forceinline__ int one_bit(int d) {
  return (unsigned)d < 4u ? 1 << d : 0;
}

// Start and verdict bits of four rows; (q1, q2, qx) is the row before.
// `forced` are the rows that open a segment whatever their keys (row 0,
// row nv, rows at or past n), `inside` the rows below n: a row at or past
// n gets start = 1, F = 0.
__device__ __forceinline__ void row_flags(int4 a1, int4 a2, int4 ax, int q1,
                                          int q2, int qx, int forced,
                                          int inside, int* s4, int* f4) {
  const int s = forced | ((a1.x != q1) | (a2.x != q2)) |
                (((a1.y != a1.x) | (a2.y != a2.x)) << 1) |
                (((a1.z != a1.y) | (a2.z != a2.y)) << 2) |
                (((a1.w != a1.z) | (a2.w != a2.z)) << 3);
  const int A = (ax.x != qx) | ((ax.y != ax.x) << 1) | ((ax.z != ax.y) << 2) |
                ((ax.w != ax.z) << 3);
  const int B = (((ax.x >> 3) == 0) | ((ax.x & 7) == 0)) |
                ((((ax.y >> 3) == 0) | ((ax.y & 7) == 0)) << 1) |
                ((((ax.z >> 3) == 0) | ((ax.z & 7) == 0)) << 2) |
                ((((ax.w >> 3) == 0) | ((ax.w & 7) == 0)) << 3);
  *s4 = s;
  *f4 = ((A & ~s) | B) & inside;
}

// Fold of a thread's four forward elements (start, F).
__device__ __forceinline__ int fold_fwd(int s4, int f4) {
  if (s4 == 0) return f4 != 0;
  return 2 | ((f4 >> (31 - __clz(s4))) != 0);
}

// Fold of a thread's four backward elements (start, start ? 0 : F), the
// lower row applied last: the OR of F below the first start.
__device__ __forceinline__ int fold_bwd(int s4, int f4) {
  const int below = (s4 & -s4) - 1;  // all four rows when there is no start
  return ((s4 != 0) << 1) | ((f4 & below & 15) != 0);
}

// Segmented-OR scan of one element a lane over a warp, from two ballots:
// returns the fold of the lanes before this one (REV: after it, the scan
// running from lane 31 down); *total is the fold of all 32.
template <bool REV>
__device__ __forceinline__ int warp_exclusive_segor(int x, int lane,
                                                    int* total) {
  const unsigned fm = __ballot_sync(FULL, x & 2);
  const unsigned vm = __ballot_sync(FULL, x & 1);
  if (!REV) {
    // values count from the last flagged lane on
    const unsigned all = fm ? FULL << (31 - __clz(fm)) : FULL;
    *total = (fm ? 2 : 0) | ((vm & all) != 0);
    const unsigned before = (1u << lane) - 1;
    const unsigned fb = fm & before;
    const unsigned from = fb ? FULL << (31 - __clz(fb)) : FULL;
    return (fb ? 2 : 0) | ((vm & before & from) != 0);
  }
  // values count up to the first flagged lane
  const unsigned all = fm ? (2u << (__ffs(fm) - 1)) - 1 : FULL;
  *total = (fm ? 2 : 0) | ((vm & all) != 0);
  const unsigned after = lane == 31 ? 0u : FULL << (lane + 1);
  const unsigned fa = fm & after;
  const unsigned upto = fa ? (2u << (__ffs(fa) - 1)) - 1 : FULL;
  return (fa ? 2 : 0) | ((vm & after & upto) != 0);
}

// Verdicts of a thread's four rows: `fin` is the OR of F from the segment's
// start up to the row before, `hin` what the row after hands back.  Both
// ORs spread over the nibble in two doubling steps.
__device__ __forceinline__ int counted_nibble(int s4, int f4, int fin,
                                              int hin) {
  int p = ~s4;  // row j may take from row j-1
  int fw = f4;
  fw |= (fw << 1) & p;
  fw |= (fw << 2) & p & (p << 1);
  if (fin) fw |= (s4 & -s4) - 1;  // the rows below the first start
  p = ~(s4 >> 1) & 7;  // row j may take from row j+1
  int bw = f4 | (hin << 3);
  bw |= (bw >> 1) & p;
  bw |= (bw >> 2) & p & (p >> 1);
  return (fw | bw) & 15;
}

__global__ void __launch_bounds__(THREADS)
    k_flags(const int* __restrict__ k1, const int* __restrict__ k2,
            const int* __restrict__ aux, long long n,
            const int* __restrict__ nv_ptr, int vec,
            uint8_t* __restrict__ flags, int2* __restrict__ rec) {
  __shared__ int sm_f[WARPS], sm_r[WARPS], sm_first[WARPS], sm_last[WARPS],
      sm_cnt[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase =
      (long long)blockIdx.x * TILE + (long long)warp * WARP_ROWS;
  const long long t0 = wbase + lane * 4;  // this thread's rows of group 0
  const int to_n = clamped(n - t0), to_nv = clamped((long long)*nv_ptr - t0);
  const SegOr op{};

  int4 c1[SUBS], c2[SUBS], ca[SUBS];
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const long long r0 = t0 + s * SUB_ROWS;
    c1[s] = load4(k1, r0, n, vec);
    c2[s] = load4(k2, r0, n, vec);
    ca[s] = load4(aux, r0, n, vec);
  }
  // the row before the warp's first, for lane 0
  int p1 = 0, p2 = 0, pa = 0;
  if (lane == 0 && wbase > 0 && wbase <= n) {
    p1 = k1[wbase - 1];
    p2 = k2[wbase - 1];
    pa = aux[wbase - 1];
  }
  int s4[SUBS], f4[SUBS];
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    int q1 = __shfl_up_sync(FULL, c1[s].w, 1);
    int q2 = __shfl_up_sync(FULL, c2[s].w, 1);
    int qa = __shfl_up_sync(FULL, ca[s].w, 1);
    if (lane == 0) {
      q1 = p1;
      q2 = p2;
      qa = pa;
    }
    // lane 0 of the next group follows this group's lane 31
    p1 = __shfl_sync(FULL, c1[s].w, 31);
    p2 = __shfl_sync(FULL, c2[s].w, 31);
    pa = __shfl_sync(FULL, ca[s].w, 31);
    const int inside = low_mask(to_n - s * SUB_ROWS);
    const int forced = (t0 + s * SUB_ROWS == 0) |
                       one_bit(to_nv - s * SUB_ROWS) | (15 & ~inside);
    row_flags(c1[s], c2[s], ca[s], q1, q2, qa, forced, inside, &s4[s],
              &f4[s]);
  }

  // Both scans inside the warp: per group the exclusive value of each
  // lane, then the exclusive value of each group.
  int exF[SUBS], exR[SUBS], preF[SUBS], preR[SUBS];
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    exF[s] = warp_exclusive_segor<false>(fold_fwd(s4[s], f4[s]), lane,
                                         &preF[s]);
    exR[s] = warp_exclusive_segor<true>(fold_bwd(s4[s], f4[s]), lane,
                                        &preR[s]);
  }
  int runF = 0, runR = 0;
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const int t = preF[s];
    preF[s] = runF;
    runF = op(runF, t);
  }
#pragma unroll
  for (int s = SUBS - 1; s >= 0; --s) {
    const int t = preR[s];
    preR[s] = runR;
    runR = op(runR, t);
  }
  int first = TILE, last = -1;
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    if (s4[s]) {
      const int at = warp * WARP_ROWS + s * SUB_ROWS + lane * 4;
      first = min(first, at + __ffs(s4[s]) - 1);
      last = max(last, at + 31 - __clz(s4[s]));
    }
  }
  first = __reduce_min_sync(FULL, first);
  last = __reduce_max_sync(FULL, last);
  if (lane == 0) {
    sm_f[warp] = runF;
    sm_r[warp] = runR;
    sm_first[warp] = first;
    sm_last[warp] = last;
  }
  __syncthreads();
  int cinF = 0, cinR = 0;
  for (int w = 0; w < warp; ++w) cinF = op(cinF, sm_f[w]);
  for (int w = WARPS - 1; w > warp; --w) cinR = op(cinR, sm_r[w]);

  // ids in the low half, selected rows in the high half: at most 512 each
  // in a warp, 4096 in a tile
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const long long r0 = t0 + s * SUB_ROWS;
    const int fin = op(op(cinF, preF[s]), exF[s]) & 1;
    const int hin = op(op(cinR, preR[s]), exR[s]) & 1;
    const int c4 = counted_nibble(s4[s], f4[s], fin, hin);
    const int sel = c4 & low_mask(to_nv - s * SUB_ROWS);
    cnt += __popc(s4[s] & sel) | (__popc(sel) << 16);
    if (r0 < n) flags[r0 >> 2] = (uint8_t)(s4[s] | (c4 << 4));
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if (lane == 0) sm_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int aggF = 0, aggR = 0, total = 0;
    first = TILE;
    last = -1;
    for (int w = 0; w < WARPS; ++w) {
      aggF = op(aggF, sm_f[w]);
      aggR = op(aggR, sm_r[WARPS - 1 - w]);
      first = min(first, sm_first[w]);
      last = max(last, sm_last[w]);
      total += sm_cnt[w];
    }
    const int has = aggF >> 1;
    rec[blockIdx.x] = make_int2(
        first | ((has ? last : TILE) << 16),
        (total & 0xffff) | ((total >> 16) << 13) | (has ? HAS_START : 0) |
            ((aggR & 1) ? PRE_F : 0) | ((aggF & 1) ? SUF_F : 0));
  }
}

// Exclusive scan of one chunk of CARRY_CHUNK positions by the carry block.
// Warp w holds positions w * CARRY_SPAN + j * 32 + lane in v[j], so that a
// warp's loads and stores are contiguous.  Each v[j] becomes the fold of
// `carry` and every position before it; returns the fold of `carry` and the
// whole chunk.  smem holds CARRY_WARPS + 1 values.
template <typename T, typename Op>
__device__ __forceinline__ T chunk_exclusive_scan(T (&v)[CARRY_ITEMS], Op op,
                                                  T* smem, T carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T run = T(0);
#pragma unroll
  for (int j = 0; j < CARRY_ITEMS; ++j) {
    T inc = v[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc = op(y, inc);
    }
    T ex = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) ex = T(0);
    v[j] = op(run, ex);
    run = op(run, __shfl_sync(FULL, inc, 31));
  }
  if (lane == 0) smem[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = carry;
    for (int w = 0; w < CARRY_WARPS; ++w) {
      const T t = smem[w];
      smem[w] = acc;
      acc = op(acc, t);
    }
    smem[CARRY_WARPS] = acc;
  }
  __syncthreads();
  const T pre = smem[warp];
#pragma unroll
  for (int j = 0; j < CARRY_ITEMS; ++j) v[j] = op(pre, v[j]);
  const T all = smem[CARRY_WARPS];
  __syncthreads();  // smem is reused by the next scan
  return all;
}

// One block over the nb tile records.  From the right: right[t], what the
// tile after t hands back.  Then from the left: the OR of F from the start
// of the segment that runs into tile t; with both, the verdicts of the
// tile's two open ends (ends[t] = before the first start | from the last
// start on << 1) and its exact counts; counts[t] becomes their exclusive
// sum, ids in the high half, selected rows in the low half.
__global__ void __launch_bounds__(CARRY_THREADS)
    k_carries(const int2* __restrict__ rec, long long nb,
              const int* __restrict__ nv_ptr, uint8_t* right, uint8_t* ends,
              long long* counts, int* __restrict__ totals) {
  __shared__ int smem[CARRY_WARPS + 1];
  __shared__ long long smem64[CARRY_WARPS + 1];
  const long long nv = *nv_ptr;
  const int at0 = (threadIdx.x >> 5) * CARRY_SPAN + (threadIdx.x & 31);
  int carry = 0;
  for (long long c0 = 0; c0 < nb; c0 += CARRY_CHUNK) {
    int v[CARRY_ITEMS];
#pragma unroll
    for (int j = 0; j < CARRY_ITEMS; ++j) {
      const long long t = nb - 1 - (c0 + at0 + j * 32);
      const int y = t >= 0 ? rec[t].y : 0;
      v[j] = ((y & HAS_START) ? 2 : 0) | ((y & PRE_F) ? 1 : 0);
    }
    carry = chunk_exclusive_scan(v, SegOr(), smem, carry);
#pragma unroll
    for (int j = 0; j < CARRY_ITEMS; ++j) {
      const long long t = nb - 1 - (c0 + at0 + j * 32);
      if (t >= 0) right[t] = (uint8_t)(v[j] & 1);
    }
  }
  __syncthreads();  // right[] is read back below, by other threads
  carry = 0;
  long long sum = 0;
  for (long long c0 = 0; c0 < nb; c0 += CARRY_CHUNK) {
    int2 r[CARRY_ITEMS];
    int v[CARRY_ITEMS];
#pragma unroll
    for (int j = 0; j < CARRY_ITEMS; ++j) {
      const long long t = c0 + at0 + j * 32;
      r[j] = t < nb ? rec[t] : make_int2(0, 0);
      v[j] = ((r[j].y & HAS_START) ? 2 : 0) | ((r[j].y & SUF_F) ? 1 : 0);
    }
    carry = chunk_exclusive_scan(v, SegOr(), smem, carry);
    long long c[CARRY_ITEMS];
#pragma unroll
    for (int j = 0; j < CARRY_ITEMS; ++j) {
      const long long t = c0 + at0 + j * 32;
      c[j] = 0;
      if (t < nb) {
        const int first = r[j].x & 0xffff, last = r[j].x >> 16;
        const bool has = r[j].y & HAS_START, pre_f = r[j].y & PRE_F,
                   suf_f = r[j].y & SUF_F;
        long long ids = r[j].y & COUNT_MASK;
        long long sel = (r[j].y >> 13) & COUNT_MASK;
        const bool from_right = right[t];
        const bool pre = (v[j] & 1) || pre_f || (!has && from_right);
        const bool suf = has ? (suf_f || from_right) : pre;
        // nv opens a segment, so an open end lies on one side of it; a
        // last start below nv means that the tile has all its rows
        if (t * TILE < nv && !pre_f && pre) sel += first;
        if (has && t * TILE + last < nv && !suf_f && suf) {
          sel += TILE - last;
          ids += 1;
        }
        ends[t] = (uint8_t)(pre | (suf << 1));
        c[j] = (ids << 32) | sel;
      }
    }
    // both counts in one int64: each is below 2^31, so no carry crosses
    sum = chunk_exclusive_scan(c, Add<long long>(), smem64, sum);
#pragma unroll
    for (int j = 0; j < CARRY_ITEMS; ++j) {
      const long long t = c0 + at0 + j * 32;
      if (t < nb) counts[t] = c[j];
    }
  }
  if (threadIdx.x == 0) {
    totals[0] = (int)(sum >> 32);
    totals[1] = (int)(sum & 0xffffffffLL);
  }
}

__global__ void __launch_bounds__(THREADS)
    k_write(const uint8_t* __restrict__ flags, const int* __restrict__ order,
            const int2* __restrict__ rec, const uint8_t* __restrict__ ends,
            const long long* __restrict__ counts, long long n,
            const int* __restrict__ nv_ptr, int fill, int vec,
            int* __restrict__ ids, int* __restrict__ poskey) {
  __shared__ int sm_cnt[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int at0 = warp * WARP_ROWS + lane * 4;  // offset in the tile
  const long long t0 = (long long)blockIdx.x * TILE + at0;
  const int to_n = clamped(n - t0), to_nv = clamped((long long)*nv_ptr - t0);

  int4 ord[SUBS];
  int fl[SUBS];
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const long long r0 = t0 + s * SUB_ROWS;
    fl[s] = r0 < n ? flags[r0 >> 2] : 0;
    ord[s] = load4(order, r0, n, vec);
  }
  const int span = rec[blockIdx.x].x;
  const int first = span & 0xffff, last = span >> 16;
  const int e = ends[blockIdx.x];
  const int pre = (e & 1) ? 15 : 0, suf = (e & 2) ? 15 : 0;

  // rows that take an id, and how many of them lie before this thread's
  // in the warp: four ballots a group, one for each row of a lane
  const unsigned before = (1u << lane) - 1;
  int sel4[SUBS], id4[SUBS], ex[SUBS];
  int run = 0;
#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const int at = at0 + s * SUB_ROWS;
    const int m_pre = low_mask(first - at);
    const int m_suf = 15 & ~low_mask(last - at) & ~m_pre;
    const int c4 = ((fl[s] >> 4) & ~(m_pre | m_suf)) | (pre & m_pre) |
                   (suf & m_suf);
    sel4[s] = c4 & low_mask(min(to_n, to_nv) - s * SUB_ROWS);
    id4[s] = fl[s] & sel4[s];
    ex[s] = run;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned m = __ballot_sync(FULL, (id4[s] >> j) & 1);
      ex[s] += __popc(m & before);
      run += __popc(m);
    }
  }
  if (lane == 0) sm_cnt[warp] = run;
  __syncthreads();
  int base = (int)(counts[blockIdx.x] >> 32) - 1;
  for (int w = 0; w < warp; ++w) base += sm_cnt[w];

#pragma unroll
  for (int s = 0; s < SUBS; ++s) {
    const long long r0 = t0 + s * SUB_ROWS;
    const int b = base + ex[s];
    const int i4 = id4[s], c = sel4[s];
    const int4 id = make_int4(b + __popc(i4 & 1), b + __popc(i4 & 3),
                              b + __popc(i4 & 7), b + __popc(i4));
    const int4 pk = make_int4((c & 1) ? ord[s].x : fill,
                              (c & 2) ? ord[s].y : fill,
                              (c & 4) ? ord[s].z : fill,
                              (c & 8) ? ord[s].w : fill);
    store4(ids, r0, n, vec, id);
    store4(poskey, r0, n, vec, pk);
  }
}

struct Scratch {
  long long* counts;
  int2* rec;
  uint8_t* right;
  uint8_t* ends;
  uint8_t* flags;
};

long long pad16(long long bytes) { return (bytes + 15) & ~15LL; }

Scratch carve(void* base, long long nb) {
  char* p = (char*)base;
  Scratch s;
  s.counts = (long long*)p;
  p += pad16(nb * 8);
  s.rec = (int2*)p;
  p += pad16(nb * 8);
  s.right = (uint8_t*)p;
  p += pad16(nb);
  s.ends = (uint8_t*)p;
  p += pad16(nb);
  s.flags = (uint8_t*)p;
  return s;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Bytes of scratch enum_scan_launch needs for n rows.
long long enum_scan_scratch_bytes(long long n) {
  const long long nb = (n + TILE - 1) / TILE;
  return pad16(nb * 8) * 2 + pad16(nb) * 2 + nb * (TILE / 4);
}

// sk1, sk2, saux, order: i32[n] sorted columns (u32 keys as bit views);
// nv: device i32 scalar, the valid-row count; fill: poskey of unselected
// rows.  Outputs ids, poskey: i32[n]; totals: i32[2] = (n_groups, n_sel).
// Columns that are not all 16-byte aligned take 4-byte loads and stores.
// Launches on `stream` without synchronising; returns the first
// cudaGetLastError() that is not cudaSuccess, else 0.
int enum_scan_launch(const int* sk1, const int* sk2, const int* saux,
                     const int* order, long long n, const int* nv, int fill,
                     int* ids, int* poskey, int* totals, void* scratch,
                     void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n + TILE - 1) / TILE;
  const Scratch s = carve(scratch, nb);
  const int vec = aligned16(sk1) && aligned16(sk2) && aligned16(saux) &&
                  aligned16(order) && aligned16(ids) && aligned16(poskey);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  k_flags<<<(unsigned)nb, THREADS, 0, st>>>(sk1, sk2, saux, n, nv, vec,
                                            s.flags, s.rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_carries<<<1, CARRY_THREADS, 0, st>>>(s.rec, nb, nv, s.right, s.ends,
                                         s.counts, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_write<<<(unsigned)nb, THREADS, 0, st>>>(s.flags, order, s.rec, s.ends,
                                            s.counts, n, nv, fill, vec, ids,
                                            poskey);
  return (int)cudaGetLastError();
}

}  // extern "C"
