// Band DP of the LAGAN order stage and its traceback, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by kernels/order_device.py.
//
// Replaces the lax.scan of sibelia_tpu/kernels/order_device.py::_make_run
// (lines 98-171, jitted at 180, vmapped at 191): for one anchored pair,
// diagonals 2..nd of the 3-state (M/N/O) int32 recurrence over a band of at
// most wmax lanes, one uint8 pointer a lane a diagonal (bit 2: N extends,
// bit 3: O extends, bits 0-1: the best of M, N, O).  The JAX package walks
// the pointers back in its native library; here that walk is on the card
// too (the traceback below), so that only the moves leave the card, and
// the nine params columns are made on the card from the band's three
// (k_band_params).
//
// Bound: the chain.  A diagonal needs the two before it, so a pair of L
// bases is about 2 L dependent steps whatever the card's width; bytes (36 B
// of params and wmax B of pointers a diagonal) and operations (about 40 a
// lane) are far below what the card could move or do in that time.  The
// design therefore shortens a step, and runs pairs side by side.
//
// k_order_band_warp, wmax <= 32 (every pair of a real C-Sibelia run):
//   * one warp runs a pair's chain, a lane a band lane; the two previous
//     diagonals of M, N, O live in registers.  The three neighbour reads
//     have an offset that is uniform over the diagonal, so they are five
//     __shfl_sync, independent of each other, and the range test of the
//     plain version chooses DUMMY;
//   * a lone warp issues an instruction every two to four cycles, so what
//     binds the step is the number of instructions in it.  Everything that
//     does not depend on the band's values is therefore taken out of the
//     chain's warp: a second warp of the block (the producer) reads params
//     and both sequences and packs, for every lane and diagonal, the three
//     source lanes, the range tests, the in-band and contig-break flags,
//     the neck flag and the substitution score into ONE 32-bit word in
//     shared memory; the chain's warp reads one word a step;
//   * the producer works a tile of 32 diagonals ahead (two tiles of words
//     in shared memory); the two warps meet at one barrier a tile.  No
//     barrier and no shared-memory band in the diagonal loop; a neck is one
//     __reduce_max_sync and a renormalisation of both diagonals' registers;
//   * a block a pair (two warps), the longest chains first;
//   * the pointer byte of a lane goes out as one coalesced store a diagonal.
//
// k_order_band_reg, wmax 64..4096, and k_order_band, 8192 (divergent
// pairs; the toolkit's draft flow, whose wrong strands have no anchor and a
// band the size of the matrix):
//   * a block a pair.  One SM then does all of a step's lanes; a step is
//     bound not by bytes or operations but by the latency of its
//     instructions and the chain's barrier, so what counts is the
//     instructions on a step's path: only lanes inside the band are
//     computed and written, and nothing on the path is a jump table;
//   * whatever does not depend on the band's values is made before the
//     chain, on the whole card: k_band_words writes one 16-bit word a lane
//     a diagonal (the substitution score, the two contig-break flags) into
//     a buffer of two bytes a pointer byte, and the block is the chain
//     alone (producer warps in the block held it up).  The words and the
//     diagonal's params row arrive diagonals ahead by cp.async into rings
//     in shared memory;
//   * up to 4096 lanes a chain thread holds K adjacent lanes (2, 4 or 8) of
//     the two
//     diagonals before the step in registers, DUMMY outside the band, and
//     writes the new one over the older.  Nearly every diagonal has one of
//     four (dd, up) pairs, each a specialised step (chosen without a jump
//     table): a neighbour is a register of the thread or, across its edge, a
//     shuffle, and across a warp's edge the lane its neighbour warp left in
//     shared memory on the step before; one chain barrier a step.  A
//     diagonal with other offsets (a band's jump) takes both diagonals
//     through shared memory and the plain version's range tests, one barrier
//     more;
//   * at 8192 the values of two diagonals (192 KB) stay in shared memory (a
//     thread's share does not fit its registers), a chain thread the lanes
//     tid, tid + 512, ..., two barriers a step;
//   * a neck is a warp reduction and an atomicMax into one shared slot
//     (two slots in turn), read after the chain's barrier, and one barrier
//     more;
//   * a launch holds every pair of its wmax (kernels/order_device.py packs
//     as many as half the card's free memory holds), so wide pairs run side
//     by side on as many SMs.
//
// The traceback: the walk of order_finish_mfa (native/lagan_order.cpp)
// from (d1, d2) back to an edge, one move byte a step (0 mismatch, 1 match,
// 2, 3), written from the end of the pair's buffer backwards, plus the
// count.  Every step is a load that depends on the one before, so one
// walk is a chain of some 130 cycles a step.  The walk is in (row, lane)
// coordinates: the lane of the next cell is the lane in hand plus the DP's
// own neighbour offset of that row (dd to (x - 1, y - 1), up to (x - 1, y),
// up + 1 to (x, y - 1)), inside the band when below that row's size;
// offsets and sizes of a row are one word beside its pointers.  A step
// depends only on (row, lane, run state), the pointer there and the row's
// word.  The move bytes are made 32 steps at a time, a lane a step (the
// match flag of a diagonal move needs two codes, which no step waits for).
//   * wmax <= 32 (every pair of a real C-Sibelia run): the walk is cut into
//     segments of seg_rows rows walked side by side, so that a batch takes
//     about as long as a segment and not as its longest pair.  A walk
//     enters a segment at its top row (run state 0, 1 or 2) or, by a
//     diagonal step, the row below (run state 0), in one of 32 lanes: 128
//     entry codes.  k_walk_tables, a block a segment (its rows and words in
//     shared memory, a thread a code): each code's steps inside the segment
//     and the code it leaves by (a pair's top segment only from the start);
//     k_walk_compose, a thread a pair: one lookup a segment from the top
//     gives each segment its true entry and, summed, the index of its first
//     move; k_walk_replay, a warp a segment: the walk from that entry, all
//     lanes together over windows of 32 rows in shared memory (cp.async,
//     the window below already on its way), its bytes written.
//   * wider bands (k_order_moves_wide), a warp a pair, the same walk over
//     windows of 32 rows of SLICE lanes around the walk's lane (cp.async,
//     the window below asked for, centred on the lane in hand, when the
//     walk enters one) with each row's offsets and sizes beside them; a
//     step's lane moves by a few lanes a row, so a slice serves the window,
//     and a cell outside it is read from device memory.
// Diagonal 1 reads as pointer 0 inside its band.
//
// One launch of each kernel serves all pairs of one wmax.
//
// All sums wrap as int32 does under XLA (unsigned arithmetic here): DUMMY
// + gap and DUMMY - norm must give the same bits as the plain version.
// Only lanes inside the band (j < size) are part of the contract, as the
// traceback reads no other: the narrow form writes every lane of a row,
// the wide one those inside the band.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SHARED_LIMIT = 227 * 1024;  // shared memory of an SM's blocks
constexpr int PAIR_WARPS = 4;  // pairs a block in the traceback, a warp each
// a mapped sequence is numlets + 17 codes, and d = numlets + 1
constexpr int SEQ_PAD = 16;
// int64 columns of the per-pair table (kernels/order_device.py)
enum { T_S1, T_N1, T_S2, T_N2, T_PARAMS, T_DIAGS, T_INIT, T_ROWS, T_WMAX,
       T_MOVES, T_PAIR, T_BAND, T_DIAG1, N_TABLE };
enum { P_SIZE, P_DD, P_UP, P_LF, P_X0, P_Y0, P_NECK, P_SP1, P_SP2,
       N_PARAMS };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

struct Consts {
  int gap_start, gap_cont, dummy, cb_code;
};

struct Pair {
  const uint8_t* s1;
  const uint8_t* s2;
  int n1, n2;
};

struct Row {
  int v[N_PARAMS];
};

__device__ __forceinline__ Row load_row(const int* params, long long t,
                                        long long n) {
  Row r;
  if (t < n) {
#pragma unroll
    for (int c = 0; c < N_PARAMS; ++c) r.v[c] = __ldg(params + t * N_PARAMS + c);
  } else {
#pragma unroll
    for (int c = 0; c < N_PARAMS; ++c) r.v[c] = 0;
  }
  return r;
}

__device__ __forceinline__ int clampi(int x, int hi) {
  return min(max(x, 0), hi);
}

__device__ __forceinline__ int code1(const Pair& p, const Row& r, int j) {
  return __ldg(p.s1 + clampi(r.v[P_X0] - 1 + j, p.n1 - 1));
}
__device__ __forceinline__ int code2(const Pair& p, const Row& r, int j) {
  return __ldg(p.s2 + clampi(r.v[P_Y0] - 1 - j, p.n2 - 1));
}

// diagmatrix.c:268-293: with a non-positive normaliser the N and O clamps
// read the M that was just updated.
__device__ __forceinline__ void renorm(int& m, int& n, int& o, int norm) {
  const int t = wsub(m, norm);
  const int m2 = norm > 0 ? min(m, t) : max(m, t);
  const int tn = wsub(n, norm);
  n = norm > 0 ? min(n, tn) : max(m2, tn);
  const int to = wsub(o, norm);
  o = norm > 0 ? min(o, to) : max(m2, to);
  m = m2;
}

// ---- wmax 64..8192: a block a pair --------------------------------------

// What a chain thread needs of a lane of a diagonal apart from the band's
// values, in 16 bits (made by k_band_words):
//   bits 0-8  the substitution score, signed;
//   bit 9, 10 whether code 1 / code 2 is NOT the contig break.
constexpr int B_NB1 = 9, B_NB2 = 10;
// (dd, up) of nearly every diagonal of a band (lf is up + 1): (0, 0), (0,
// -1), (-1, -1), (1, 0); C_ANY any other, at a band's jump.
enum { C_00, C_0M, C_MM, C_10, C_ANY };
constexpr int CHAIN_BAR = 1;  // the chain's named barrier

// Without a branch (a switch here becomes a jump table on the step's
// critical path): (dd + 1) * 2 + up + 1 picks a nibble of CASES.
constexpr unsigned CASES = C_MM | C_ANY << 4 | C_0M << 8 | C_00 << 12
                           | C_ANY << 16 | C_10 << 20;
__device__ __forceinline__ int offsets_case(int dd, int up, int lf) {
  const bool near = (unsigned)(dd + 1) <= 2u && (unsigned)(up + 1) <= 1u
                    && lf == up + 1;
  return near ? (int)(CASES >> (4 * ((dd + 1) * 2 + up + 1)) & 15u) : C_ANY;
}

// The chain's barrier: its warps alone.
__device__ __forceinline__ void chain_sync(int nchain) {
  asm volatile("bar.sync %0, %1;" ::"n"(CHAIN_BAR), "r"(nchain) : "memory");
}

// One cell of the chain from its word: returns the pointer, the new M, N, O
// in m, n, o.  dm.. lo are the neighbours, DUMMY where out of range.
__device__ __forceinline__ int cell_word(unsigned wd, int dm, int dn, int dO,
                                        int un, int lo, unsigned gc,
                                        unsigned gs, int& m, int& n, int& o) {
  const int score = (int)(wd << 23) >> 23;
  const unsigned nb1 = (wd >> B_NB1) & 1u, nb2 = (wd >> B_NB2) & 1u;
  // a gap term is 0 at a contig break: the flag times the penalty
  const int s2v = (int)((unsigned)dn + nb2 * gc);
  const int s3v = (int)((unsigned)dO + nb1 * gc);
  const int cm = wadd(score, max(dm, max(s2v, s3v)));
  const int t1 = (int)((unsigned)cm + nb2 * gs);
  const int t2 = (int)((unsigned)un + nb2 * gc);
  const int u1 = (int)((unsigned)cm + nb1 * gs);
  const int u2 = (int)((unsigned)lo + nb1 * gc);
  const bool takes_n = t1 >= t2, takes_o = u1 >= u2;
  const int cn = max(t1, t2), co = max(u1, u2);
  m = cm;
  n = cn;
  o = co;
  return (takes_n ? 0 : 4) | (takes_o ? 0 : 8)
         | (cm >= cn ? (cm < co ? 2 : 0) : (cn >= co ? 1 : 2));
}

// -- wmax 64..4096: K adjacent lanes a chain thread, in registers ----------
//
// Each thread has its K words (k_band_words) and the diagonal's row AHEAD
// diagonals on their way (cp.async into a ring in shared memory; the row by
// nine lanes of each warp into the warp's own ring).
//
// Chain thread t holds lanes t K .. t K + K - 1 of the two diagonals before
// the step (M, N, O; DUMMY outside the band, so that a read there needs no
// range test) and writes the new one over the older.  On a diagonal of the
// four cases a neighbour is a register of the same thread or, across the
// thread's edge, one lane of the next thread: a shuffle, and across a
// warp's edge the warp's first or last lane that its neighbour warp left in
// shared memory on the step before (s_edge, three diagonals in turn).  A
// diagonal of C_ANY (a jump of the band) takes the two diagonals through
// shared memory, with the range tests of the plain version.  Up to 256
// lanes the block is one warp (SOLO): no edges, the warp's own barrier,
// a neck's norm straight from the warp's reduction.
constexpr int REG_CHAIN = 512;  // chain threads at wmax 4096 (K = 8)
constexpr int REG_WARPS = REG_CHAIN / 32;
constexpr int REG_MAX_W = 4096;
constexpr int AHEAD = 6;          // diagonals on their way
constexpr int RING = AHEAD + 1;   // slots of the words' and rows' rings
enum { E_LO, E_HI };  // a warp's first lane, its last

// The word of every lane inside the band of every diagonal of the pairs,
// pair b's at words[table[b][T_ROWS] - words_base + t w + j]: blocks over
// the diagonals (grid y: the pair), a thread a lane.
__global__ void __launch_bounds__(256)
k_band_words(const uint8_t* __restrict__ codes, const int* __restrict__ params,
             const long long* __restrict__ table, const int* __restrict__ sm,
             int w, int cb_code, long long words_base,
             uint16_t* __restrict__ words) {
  __shared__ int s_sm[64];
  if (threadIdx.x < 64) s_sm[threadIdx.x] = sm[threadIdx.x];
  __syncthreads();
  const long long* tab = table + (long long)blockIdx.y * N_TABLE;
  Pair pair;
  pair.s1 = codes + tab[T_S1];
  pair.n1 = (int)tab[T_N1];
  pair.s2 = codes + tab[T_S2];
  pair.n2 = (int)tab[T_N2];
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const long long nd1 = tab[T_DIAGS];
  uint16_t* out = words + (tab[T_ROWS] - words_base);
  for (long long t = blockIdx.x; t < nd1; t += gridDim.x) {
    const Row r = load_row(par, t, nd1);
    const int size = min(r.v[P_SIZE], w);
    for (int j = threadIdx.x; j < size; j += blockDim.x) {
      const int c1 = code1(pair, r, j), c2 = code2(pair, r, j);
      out[t * w + j] = (uint16_t)((s_sm[c1 * 8 + c2] & 0x1ff)
                                  | (c1 != cb_code) << B_NB1
                                  | (c2 != cb_code) << B_NB2);
    }
  }
}

template <int K>
struct Lanes {
  int m[K], n[K], o[K];
};

// A neighbour one lane below the thread: the last lane of the thread below
// (a shuffle), the warp below's last lane at a warp's first thread (DUMMY
// when the warp is the block, SOLO).
template <bool SOLO>
__device__ __forceinline__ int from_below(int last, const int* edge,
                                          int lane, int dummy) {
  const int v = __shfl_up_sync(FULL, last, 1);
  return lane == 0 ? (SOLO ? dummy : *edge) : v;
}
// One lane above: the first lane of the thread above, the warp above's
// first lane at a warp's last thread.
template <bool SOLO>
__device__ __forceinline__ int from_above(int first, const int* edge,
                                          int lane, int dummy) {
  const int v = __shfl_down_sync(FULL, first, 1);
  return lane == 31 ? (SOLO ? dummy : *edge) : v;
}
// The chain's barrier; a warp's own when the warp is the block.
template <bool SOLO>
__device__ __forceinline__ void sync_chain(int nchain) {
  if constexpr (SOLO) __syncwarp();
  else chain_sync(nchain);
}

// The new diagonal over p2, for a diagonal whose offsets are dd = DD, up =
// UP, lf = UP + 1.  (em, en, eo): p2's lane just outside the thread on DD's
// side; e1: p1's N one lane below (UP = -1) or p1's O one lane above (UP =
// 0).
template <int K, int DD, int UP>
__device__ __forceinline__ void cells(const Lanes<K>& p1, Lanes<K>& p2,
                                      int em, int en, int eo, int e1,
                                      const unsigned (&wd)[K], unsigned gc,
                                      unsigned gs, int (&ptr)[K]) {
  int nm[K], nn[K], no[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = i + DD, u = i + UP, l = i + UP + 1;
    const bool out = s < 0 || s >= K;
    const int sc = out ? 0 : s;
    const int dm = out ? em : p2.m[sc];
    const int dn = out ? en : p2.n[sc];
    const int dO = out ? eo : p2.o[sc];
    const int un = u < 0 ? e1 : p1.n[u < 0 ? 0 : u];
    const int lo = l >= K ? e1 : p1.o[l >= K ? 0 : l];
    ptr[i] = cell_word(wd[i], dm, dn, dO, un, lo, gc, gs, nm[i], nn[i],
                       no[i]);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    p2.m[i] = nm[i];
    p2.n[i] = nn[i];
    p2.o[i] = no[i];
  }
}

// A diagonal of C_ANY: p2's M, N, O and p1's N, O of every lane are in
// shared memory (g, five rows of w); the neighbours of the plain version,
// DUMMY outside their diagonal's band.
template <int K>
__device__ __forceinline__ void cells_any(const int* g, int w, int dd, int up,
                                          int lf, int sp1, int sp2, int base,
                                          int dummy, const unsigned (&wd)[K],
                                          unsigned gc, unsigned gs,
                                          Lanes<K>& p2, int (&ptr)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = base + i;
    int idx = j + dd;
    const bool okd = (unsigned)idx < (unsigned)sp2;
    const int dm = okd ? g[idx] : dummy;
    const int dn = okd ? g[w + idx] : dummy;
    const int dO = okd ? g[2 * w + idx] : dummy;
    idx = j + up;
    const int un = (unsigned)idx < (unsigned)sp1 ? g[3 * w + idx] : dummy;
    idx = j + lf;
    const int lo = (unsigned)idx < (unsigned)sp1 ? g[4 * w + idx] : dummy;
    ptr[i] = cell_word(wd[i], dm, dn, dO, un, lo, gc, gs, p2.m[i], p2.n[i],
                       p2.o[i]);
  }
}

// The thread's K words (K / 2 32-bit halves pairs) from the ring.
template <int K>
__device__ __forceinline__ void load_words(const uint16_t* words,
                                           unsigned (&wd)[K]) {
  unsigned v[K / 2];
  if constexpr (K == 8) {
    const uint4 q = *(const uint4*)words;
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (K == 4) {
    const uint2 q = *(const uint2*)words;
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *(const unsigned*)words;
  }
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    wd[2 * i] = v[i] & 0xffffu;
    wd[2 * i + 1] = v[i] >> 16;
  }
}

// The K pointer bytes of the thread, one store.
template <int K>
__device__ __forceinline__ void store_ptrs(uint8_t* at, const int (&ptr)[K]) {
  unsigned v[(K + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < K; ++i) v[i / 4] |= (unsigned)ptr[i] << (8 * (i & 3));
  if constexpr (K == 8) *(uint2*)at = make_uint2(v[0], v[1]);
  else if constexpr (K == 4) *(unsigned*)at = v[0];
  else *(uint16_t*)at = (uint16_t)v[0];
}

// The edge lanes of a diagonal for the warps beside: lane 0 leaves the
// warp's first lane, lane 31 its last, in slot `edge` (this warp's row).
template <int K>
__device__ __forceinline__ void publish(int (*edge)[4], int lane,
                                        const Lanes<K>& d) {
  if (lane == 0) {
    edge[E_LO][0] = d.m[0];
    edge[E_LO][1] = d.n[0];
    edge[E_LO][2] = d.o[0];
  } else if (lane == 31) {
    edge[E_HI][0] = d.m[K - 1];
    edge[E_HI][1] = d.n[K - 1];
    edge[E_HI][2] = d.o[K - 1];
  }
}

// What a chain thread of the register form reads besides its registers.
struct RegChain {
  const uint16_t* words;  // the pair's words
  const int* par;         // the pair's params rows
  uint16_t* s_words;      // RING diagonals of w words
  int (*s_row)[N_PARAMS]; // this warp's RING rows
  int (*s_edge)[REG_WARPS + 2][2][4];  // [slot][warp + 1]: dummies around
  int* g;
  int* s_neck;
  uint8_t* out;
  int nd1, w, nchain, base, lane, wp, tid;
  Consts k;
  unsigned gc, gs;
};

// Diagonal t's words (the thread's K) and row (lanes 0-8 of each warp) on
// their way into ring slot `slot` (t % RING); a group is committed whatever
// t.
template <int K>
__device__ __forceinline__ void fetch(const RegChain& c, int t, int slot) {
  if (t < c.nd1) {
    __pipeline_memcpy_async(c.s_words + slot * c.w + c.base,
                            c.words + (size_t)t * c.w + c.base, 2 * K);
    if (c.lane < N_PARAMS)
      __pipeline_memcpy_async(&c.s_row[slot][c.lane],
                              c.par + t * N_PARAMS + c.lane, 4);
  }
  __pipeline_commit();
}

// One diagonal, row t in ring slot `slot`: p1 the diagonal before, p2 the
// one before that and, after the step, the new one; s0, s1, s2: the edge
// slots of the new diagonal, p1 and p2 (SOLO, one warp: no edges, no
// barrier but the warp's own).
template <int K, bool SOLO>
__device__ __forceinline__ void reg_step(const RegChain& c, int t,
                                         int slot, Lanes<K>& p1, Lanes<K>& p2,
                                         int s0, int s1, int s2,
                                         int& parity) {
  __pipeline_wait_prior(AHEAD - 1);  // diagonal t has arrived
  __syncwarp();
  const int* row = c.s_row[slot];
  const int size = min(row[P_SIZE], c.w), sp1 = row[P_SP1];
  const int dd = row[P_DD], up = row[P_UP], lf = row[P_LF];
  const bool neck = row[P_NECK] == 1;
  const bool live = c.base < size;
  unsigned wd[K];
  load_words<K>(c.s_words + slot * c.w + c.base, wd);
  fetch<K>(c, t + AHEAD, slot == 0 ? AHEAD : slot - 1);  // t - 1's slot
  int ptr[K];
  // the neighbour rows of this warp in the edge slots
  const int(*below1)[4] = c.s_edge[s1][c.wp];
  const int(*above1)[4] = c.s_edge[s1][c.wp + 2];
  const int(*below2)[4] = c.s_edge[s2][c.wp];
  const int(*above2)[4] = c.s_edge[s2][c.wp + 2];
  // uniform branches, the common cases first (no jump table)
  const int cs = offsets_case(dd, up, lf);
  if (cs == C_MM) {
    const int em = from_below<SOLO>(p2.m[K - 1], &below2[E_HI][0], c.lane,
                                     c.k.dummy);
    const int en = from_below<SOLO>(p2.n[K - 1], &below2[E_HI][1], c.lane,
                                     c.k.dummy);
    const int eo = from_below<SOLO>(p2.o[K - 1], &below2[E_HI][2], c.lane,
                                     c.k.dummy);
    const int e1 = from_below<SOLO>(p1.n[K - 1], &below1[E_HI][1], c.lane,
                                     c.k.dummy);
    if (live) cells<K, -1, -1>(p1, p2, em, en, eo, e1, wd, c.gc, c.gs, ptr);
  } else if (cs == C_10) {
    const int em = from_above<SOLO>(p2.m[0], &above2[E_LO][0], c.lane,
                                     c.k.dummy);
    const int en = from_above<SOLO>(p2.n[0], &above2[E_LO][1], c.lane,
                                     c.k.dummy);
    const int eo = from_above<SOLO>(p2.o[0], &above2[E_LO][2], c.lane,
                                     c.k.dummy);
    const int e1 = from_above<SOLO>(p1.o[0], &above1[E_LO][2], c.lane,
                                     c.k.dummy);
    if (live) cells<K, 1, 0>(p1, p2, em, en, eo, e1, wd, c.gc, c.gs, ptr);
  } else if (cs == C_00) {
    const int e1 = from_above<SOLO>(p1.o[0], &above1[E_LO][2], c.lane,
                                     c.k.dummy);
    if (live) cells<K, 0, 0>(p1, p2, 0, 0, 0, e1, wd, c.gc, c.gs, ptr);
  } else if (cs == C_0M) {
    const int e1 = from_below<SOLO>(p1.n[K - 1], &below1[E_HI][1], c.lane,
                                     c.k.dummy);
    if (live) cells<K, 0, -1>(p1, p2, 0, 0, 0, e1, wd, c.gc, c.gs, ptr);
  } else {
    int* g = c.g + c.base;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      g[i] = p2.m[i];
      g[c.w + i] = p2.n[i];
      g[2 * c.w + i] = p2.o[i];
      g[3 * c.w + i] = p1.n[i];
      g[4 * c.w + i] = p1.o[i];
    }
    sync_chain<SOLO>(c.nchain);
    if (live)
      cells_any<K>(c.g, c.w, dd, up, lf, sp1, row[P_SP2], c.base, c.k.dummy,
                   wd, c.gc, c.gs, p2, ptr);
  }
  if (live) {
    store_ptrs<K>(c.out + (size_t)t * c.w + c.base, ptr);
    if (c.base + K > size) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (c.base + i >= size) p2.m[i] = p2.n[i] = p2.o[i] = c.k.dummy;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p2.m[i] = p2.n[i] = p2.o[i] = c.k.dummy;
  }
  if (neck) {
    // the new diagonal's best M over the block, both diagonals
    // renormalised inside their bands (p1's edges left again)
    int best = p2.m[0];
#pragma unroll
    for (int i = 1; i < K; ++i) best = max(best, p2.m[i]);
    best = __reduce_max_sync(FULL, best);
    int norm = best;
    if constexpr (!SOLO) {
      if (c.lane == 0) atomicMax(&c.s_neck[parity], best);
      chain_sync(c.nchain);
      norm = c.s_neck[parity];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (c.base + i < size) renorm(p2.m[i], p2.n[i], p2.o[i], norm);
      if (c.base + i < sp1) renorm(p1.m[i], p1.n[i], p1.o[i], norm);
    }
    if constexpr (!SOLO) {
      if (c.tid == 0) c.s_neck[parity ^ 1] = c.k.dummy;
      parity ^= 1;
      publish<K>(c.s_edge[s1][c.wp + 1], c.lane, p1);
    }
  }
  if constexpr (!SOLO) publish<K>(c.s_edge[s0][c.wp + 1], c.lane, p2);
  sync_chain<SOLO>(c.nchain);
}

template <int K, bool SOLO>
__global__ void __launch_bounds__(REG_CHAIN, 1)
k_order_band_reg(const int* __restrict__ params, const int* __restrict__ init,
                 const long long* __restrict__ table,
                 const uint16_t* __restrict__ words, long long words_base,
                 int w, Consts k, uint8_t* __restrict__ rows) {
  extern __shared__ __align__(16) int s_dyn[];
  __shared__ int s_neck[2];
  __shared__ int s_row[REG_WARPS][RING][N_PARAMS];
  __shared__ int s_edge[3][REG_WARPS + 2][2][4];
  const long long* tab = table + (long long)blockIdx.x * N_TABLE;
  const int tid = threadIdx.x, nchain = blockDim.x;
  RegChain c;
  c.words = words + (tab[T_ROWS] - words_base);
  c.par = params + tab[T_PARAMS] * N_PARAMS;
  c.s_words = (uint16_t*)(s_dyn + 5 * w);
  c.s_row = s_row[tid >> 5];
  c.s_edge = s_edge;
  c.g = s_dyn;
  c.s_neck = s_neck;
  c.out = rows + tab[T_ROWS];
  c.nd1 = (int)tab[T_DIAGS];  // under 2^24: a pair's rows are at most
                              // 256 MB of at least 16 lanes
  c.w = w;
  c.nchain = nchain;
  c.base = tid * K;
  c.lane = tid & 31;
  c.wp = tid >> 5;
  c.tid = tid;
  c.k = k;
  c.gc = (unsigned)k.gap_cont;
  c.gs = (unsigned)k.gap_start;
  for (int t = 0; t < AHEAD; ++t) fetch<K>(c, t, t);
  if (tid < 2) s_neck[tid] = k.dummy;
  for (int x = tid; x < 3 * (REG_WARPS + 2) * 2 * 4; x += nchain)
    (&s_edge[0][0][0][0])[x] = k.dummy;
  // diagonal 1 (DUMMY outside its band) in A, diagonal 0 (all DUMMY) in B;
  // their edges in slots 0 and 2
  const int* ini = init + tab[T_INIT];
  const int size1 = __ldg(c.par + P_SP1);
  Lanes<K> A, B;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = c.base + i;
    const bool in = j < size1;
    A.m[i] = in ? ini[j] : k.dummy;
    A.n[i] = in ? ini[w + j] : k.dummy;
    A.o[i] = in ? ini[2 * w + j] : k.dummy;
    B.m[i] = B.n[i] = B.o[i] = k.dummy;
  }
  __syncthreads();
  if constexpr (!SOLO) publish<K>(s_edge[0][c.wp + 1], c.lane, A);
  __syncthreads();

  int s0 = 1, s1 = 0, s2 = 2, parity = 0, slot = 0;
  bool flip = false;  // B holds p1 (A the older diagonal)
  for (int t = 0; t < c.nd1; ++t) {
    if (flip) reg_step<K, SOLO>(c, t, slot, B, A, s0, s1, s2, parity);
    else reg_step<K, SOLO>(c, t, slot, A, B, s0, s1, s2, parity);
    flip = !flip;
    slot = slot == AHEAD ? 0 : slot + 1;
    const int s = s2;
    s2 = s1;
    s1 = s0;
    s0 = s;
  }
  __pipeline_wait_prior(0);
}

// -- wmax 8192: the band's values in shared memory ---------------------------
//
// 8192 lanes of M, N, O for two diagonals do not fit a block's registers:
// two diagonals in shared memory (192 KB), the block the chain alone, a
// thread the lanes tid, tid + CHAIN_MAX, ..., the new diagonal in registers
// until every read of the older is done, two barriers a step.  The words
// (k_band_words) and the params row come a diagonal ahead by cp.async,
// into two slots: what fits beside the band.
constexpr int CHAIN_MAX = 512;
constexpr int NEW_ITEMS = 8192 / CHAIN_MAX;  // lanes a chain thread keeps

// What a diagonal's step reads of its row, in registers.
struct Rec {
  int dd, up, lf, sp1, sp2;
};
// The neighbours of lane j: p2's M, N, O at j + dd, p1's N at j + up and O at
// j + lf, each DUMMY outside its diagonal's band.
struct Hood {
  int dm, dn, dO, un, lo;
};
__device__ __forceinline__ Hood hood(const int* p1, const int* p2, int w,
                                     const Rec& rc, int j, int dummy) {
  Hood h;
  int idx = j + rc.dd;
  const bool okd = (unsigned)idx < (unsigned)rc.sp2;
  h.dm = okd ? p2[idx] : dummy;
  h.dn = okd ? p2[w + idx] : dummy;
  h.dO = okd ? p2[2 * w + idx] : dummy;
  idx = j + rc.up;
  h.un = (unsigned)idx < (unsigned)rc.sp1 ? p1[w + idx] : dummy;
  idx = j + rc.lf;
  h.lo = (unsigned)idx < (unsigned)rc.sp1 ? p1[2 * w + idx] : dummy;
  return h;
}

__global__ void __launch_bounds__(CHAIN_MAX, 1)
k_order_band(const int* __restrict__ params, const int* __restrict__ init,
             const long long* __restrict__ table,
             const uint16_t* __restrict__ words, long long words_base, int w,
             Consts k, uint8_t* __restrict__ rows) {
  extern __shared__ __align__(16) int s_dyn[];
  __shared__ int s_neck[2];
  __shared__ int s_row[2][N_PARAMS];
  const long long* tab = table + (long long)blockIdx.x * N_TABLE;
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const int nd1 = (int)tab[T_DIAGS];
  const int* ini = init + tab[T_INIT];
  const uint16_t* wpair = words + (tab[T_ROWS] - words_base);
  uint8_t* out = rows + tab[T_ROWS];
  const int tid = threadIdx.x, nchain = blockDim.x;
  int* p1 = s_dyn;
  int* p2 = s_dyn + 3 * w;
  uint16_t* s_word = (uint16_t*)(s_dyn + 6 * w);
  // diagonal t's words (16 bytes a copy) and row into slot t & 1
  auto fetch = [&](int t) {
    if (t < nd1) {
      const int slot = t & 1;
      for (int x = tid; x < w / 8; x += nchain)
        __pipeline_memcpy_async(s_word + slot * w + 8 * x,
                                wpair + (size_t)t * w + 8 * x, 16);
      if (tid < N_PARAMS)
        __pipeline_memcpy_async(&s_row[slot][tid],
                                par + t * N_PARAMS + tid, 4);
    }
    __pipeline_commit();
  };
  fetch(0);
  fetch(1);
  if (tid < 2) s_neck[tid] = k.dummy;
  for (int x = tid; x < 3 * w; x += nchain) {
    p1[x] = ini[x];
    p2[x] = k.dummy;
  }
  __pipeline_wait_prior(1);
  __syncthreads();  // diagonal 0's words and row, diagonal 1's values

  const unsigned gc = (unsigned)k.gap_cont, gs = (unsigned)k.gap_start;
  const int lane = tid & 31;
  int parity = 0;  // the slot of s_neck the next neck takes
  for (int t = 0; t < nd1; ++t) {
    const int* row = s_row[t & 1];
    const uint16_t* wrow = s_word + (t & 1) * w;
    const int size = min(row[P_SIZE], w);
    const bool neck = row[P_NECK] == 1;
    const Rec rc{row[P_DD], row[P_UP], row[P_LF], row[P_SP1], row[P_SP2]};
    uint8_t* orow = out + (size_t)t * w;
    int best = k.dummy;
    int rm[NEW_ITEMS], rn[NEW_ITEMS], ro[NEW_ITEMS];
#pragma unroll
    for (int i = 0; i < NEW_ITEMS; ++i) {
      const int j = tid + i * CHAIN_MAX;
      if (j < size) {
        const Hood h = hood(p1, p2, w, rc, j, k.dummy);
        orow[j] = (uint8_t)cell_word(wrow[j], h.dm, h.dn, h.dO, h.un, h.lo,
                                     gc, gs, rm[i], rn[i], ro[i]);
        best = max(best, rm[i]);
      }
    }
    if (neck) {
      best = __reduce_max_sync(FULL, best);
      if (lane == 0) atomicMax(&s_neck[parity], best);
    }
    __syncthreads();  // every read of p1, p2 and slot t & 1 is done
    fetch(t + 2);
    const int norm = neck ? s_neck[parity] : 0;
    if (neck) {
      for (int j = tid; j < rc.sp1; j += nchain)
        renorm(p1[j], p1[w + j], p1[2 * w + j], norm);
      if (tid == 0) s_neck[parity ^ 1] = k.dummy;
      parity ^= 1;
    }
    // the new diagonal takes p2's place
#pragma unroll
    for (int i = 0; i < NEW_ITEMS; ++i) {
      const int j = tid + i * CHAIN_MAX;
      if (j < size) {
        if (neck) renorm(rm[i], rn[i], ro[i], norm);
        p2[j] = rm[i];
        p2[w + j] = rn[i];
        p2[2 * w + j] = ro[i];
      }
    }
    __pipeline_wait_prior(1);  // this thread's copies of diagonal t + 1
    __syncthreads();
    int* s = p1;
    p1 = p2;
    p2 = s;
  }
  __pipeline_wait_prior(0);
}


// ---- wmax <= 32: a warp a pair, the band in registers ----------------------

// What a lane needs of a diagonal apart from the band's values, in one word
// (made by the producer warps, read by the chain's warp):
//   bits 0-4, 5-9, 10-14  the lanes it takes p2 (M, N, O), p1's N and p1's O
//                         from (a shuffle reads the low five bits);
//   bits 15, 16, 17       whether each of those lies inside its diagonal;
//   bit 18                whether the lane itself lies inside the band;
//   bits 19, 20           whether code 1 / code 2 is NOT the contig break;
//   bit 21                a neck diagonal;
//   bits 23-31            the substitution score, signed.
constexpr int W_UP = 5, W_LF = 10, W_OKD = 15, W_OKU = 16, W_OKL = 17,
              W_IN = 18, W_NB1 = 19, W_NB2 = 20, W_NECK = 21, W_SCORE = 23;
constexpr int PRODUCERS = 1;             // warps that make the words
constexpr int HALF = 32;                 // diagonals a producer a tile
constexpr int CH_TILE = PRODUCERS * HALF;  // diagonals a tile of words

// A producer's half of tile `tile`: one word a lane for each of its 32
// diagonals.  Lane l fetches the params row of diagonal l of the half, the
// rows go round by shuffle; every load of the loop is independent of the
// others, so they overlap.
__device__ __forceinline__ void produce_words(
    unsigned (*words)[32], const Pair& pair, const int* par, int nd1, int tile,
    int half, const int* s_sm, int cb_code, int lane) {
  const int base = tile * CH_TILE + half * HALF;
  Row mine;
  const int row = base + lane;
#pragma unroll
  for (int c = 0; c < N_PARAMS; ++c)
    mine.v[c] = row < nd1 ? __ldg(par + (long long)row * N_PARAMS + c) : 0;
  const int n = min(HALF, nd1 - base);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    Row r;
#pragma unroll
    for (int c = 0; c < N_PARAMS; ++c) r.v[c] = __shfl_sync(FULL, mine.v[c], i);
    const int c1 = code1(pair, r, lane), c2 = code2(pair, r, lane);
    const int dd = lane + r.v[P_DD], up = lane + r.v[P_UP],
              lf = lane + r.v[P_LF];
    unsigned word = (unsigned)(dd & 31) | (unsigned)(up & 31) << W_UP
                    | (unsigned)(lf & 31) << W_LF;
    word |= (unsigned)(dd >= 0 && dd < r.v[P_SP2]) << W_OKD;
    word |= (unsigned)(up >= 0 && up < r.v[P_SP1]) << W_OKU;
    word |= (unsigned)(lf >= 0 && lf < r.v[P_SP1]) << W_OKL;
    word |= (unsigned)(lane < r.v[P_SIZE]) << W_IN;
    word |= (unsigned)(c1 != cb_code) << W_NB1;
    word |= (unsigned)(c2 != cb_code) << W_NB2;
    word |= (unsigned)(r.v[P_NECK] == 1) << W_NECK;
    word |= (unsigned)s_sm[c1 * 8 + c2] << W_SCORE;
    words[half * HALF + i][lane] = word;
  }
}

// One pair a block: warp 0 runs the chain, the other makes the words of the
// next tile meanwhile; one barrier a tile of 32 diagonals, none in the
// diagonal loop.
__global__ void __launch_bounds__((1 + PRODUCERS) * 32)
k_order_band_warp(const uint8_t* __restrict__ codes,
                  const int* __restrict__ params, const int* __restrict__ init,
                  const long long* __restrict__ table,
                  const int* __restrict__ sm, int w, Consts k,
                  uint8_t* __restrict__ rows) {
  __shared__ int s_sm[64];
  __shared__ unsigned s_words[2][CH_TILE][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 64) s_sm[threadIdx.x] = sm[threadIdx.x];
  const long long* tab = table + (long long)blockIdx.x * N_TABLE;
  Pair pair;
  pair.s1 = codes + tab[T_S1];
  pair.n1 = (int)tab[T_N1];
  pair.s2 = codes + tab[T_S2];
  pair.n2 = (int)tab[T_N2];
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const int nd1 = (int)tab[T_DIAGS];
  const int tiles = (nd1 + CH_TILE - 1) / CH_TILE;
  __syncthreads();
  if (warp > 0)
    produce_words(s_words[0], pair, par, nd1, 0, warp - 1, s_sm, k.cb_code,
                  lane);
  __syncthreads();
  if (warp > 0) {
    for (int tile = 0; tile < tiles; ++tile) {
      if (tile + 1 < tiles)
        produce_words(s_words[(tile + 1) & 1], pair, par, nd1, tile + 1,
                      warp - 1, s_sm, k.cb_code, lane);
      __syncthreads();
    }
    return;
  }

  const int* ini = init + tab[T_INIT];
  const bool writes = lane < w;
  uint8_t* po = rows + tab[T_ROWS] + lane;
  // diagonal 1 in p1, nothing before it
  int p1m = writes ? ini[lane] : k.dummy;
  int p1n = writes ? ini[w + lane] : k.dummy;
  int p1o = writes ? ini[2 * w + lane] : k.dummy;
  int p2m = k.dummy, p2n = k.dummy, p2o = k.dummy;
  bool p1_in = p1m != k.dummy;  // diagonal 1's M is 0 inside its band
  const unsigned gc = (unsigned)k.gap_cont, gs = (unsigned)k.gap_start;
  for (int tile = 0; tile < tiles; ++tile) {
    const unsigned (*words)[32] = s_words[tile & 1];
    const int n = min(CH_TILE, nd1 - tile * CH_TILE);
    for (int i = 0; i < n; ++i) {
      const unsigned word = words[i][lane];
      // the chain: five shuffles, then the cell
      int dm = __shfl_sync(FULL, p2m, (int)word);
      int dn = __shfl_sync(FULL, p2n, (int)word);
      int dO = __shfl_sync(FULL, p2o, (int)word);
      int un = __shfl_sync(FULL, p1n, (int)(word >> W_UP));
      int lo = __shfl_sync(FULL, p1o, (int)(word >> W_LF));
      const bool okd = word & (1u << W_OKD);
      dm = okd ? dm : k.dummy;
      dn = okd ? dn : k.dummy;
      dO = okd ? dO : k.dummy;
      un = (word & (1u << W_OKU)) ? un : k.dummy;
      lo = (word & (1u << W_OKL)) ? lo : k.dummy;
      // a gap term is 0 at a contig break: the flag times the penalty
      const unsigned nb1 = (word >> W_NB1) & 1u, nb2 = (word >> W_NB2) & 1u;
      const int s2v = (int)((unsigned)dn + nb2 * gc);
      const int s3v = (int)((unsigned)dO + nb1 * gc);
      const int cm = wadd((int)word >> W_SCORE, max(dm, max(s2v, s3v)));
      const int t1 = (int)((unsigned)cm + nb2 * gs);
      const int t2 = (int)((unsigned)un + nb2 * gc);
      const int u1 = (int)((unsigned)cm + nb1 * gs);
      const int u2 = (int)((unsigned)lo + nb1 * gc);
      const bool takes_n = t1 >= t2, takes_o = u1 >= u2;
      const int cn = max(t1, t2), co = max(u1, u2);
      const int ptr = (takes_n ? 0 : 4) | (takes_o ? 0 : 8)
                      | (cm >= cn ? (cm < co ? 2 : 0) : (cn >= co ? 1 : 2));
      if (writes) *po = (uint8_t)ptr;
      po += w;
      const bool inband = word & (1u << W_IN);
      int m = inband ? cm : k.dummy;
      int n_ = inband ? cn : k.dummy;
      int o = inband ? co : k.dummy;
      if (word & (1u << W_NECK)) {
        const int norm = __reduce_max_sync(FULL, m);
        if (inband) renorm(m, n_, o, norm);
        if (p1_in) renorm(p1m, p1n, p1o, norm);
      }
      p2m = p1m; p2n = p1n; p2o = p1o;
      p1m = m; p1n = n_; p1o = o;
      p1_in = inband;
    }
    __syncthreads();
  }
}

// ---- the traceback ---------------------------------------------------------

constexpr int TILE = 32;    // diagonals a window of the walk
constexpr int SLICE = 256;  // lanes a row of a window holds at w > 32
// the narrow walk's segments: entry codes (sel << 5 | lane; sel 0-2 the
// segment's top row in run state sel, 3 the row below it in run state 0),
// and the code of a walk that has ended
constexpr int WALK_ENTRIES = 128;
constexpr unsigned WALK_STOP = 255;

// cp.async of window `win` (32 diagonals) of the pair's pointer rows, and of
// each row's dd, up, sp1, sp2, into slot win & 1.
__device__ __forceinline__ void stage_window(
    uint8_t* s_rows, int* s_raw, const uint8_t* out, const int* par, int win,
    int nd1, int w, int lane) {
  const int slot = win & 1;
  const long long lo = (long long)win * TILE * w, end = (long long)nd1 * w;
  for (int x = lane * 16; x < TILE * w; x += 32 * 16)
    if (lo + x < end)
      __pipeline_memcpy_async(s_rows + slot * TILE * w + x, out + lo + x, 16);
  const int row = win * TILE + lane;
  if (row < nd1) {
    int* dst = s_raw + (slot * TILE + lane) * 4;
    const int* src = par + (long long)row * N_PARAMS;
    __pipeline_memcpy_async(dst, src + P_DD, 4);
    __pipeline_memcpy_async(dst + 1, src + P_UP, 4);
    __pipeline_memcpy_async(dst + 2, src + P_SP1, 4);
    __pipeline_memcpy_async(dst + 3, src + P_SP2, 4);
  }
  __pipeline_commit();
}

// What a step from a cell of a row needs, as one word: the lane offsets to
// (x - 1, y - 1) two rows down (bits 0-7, signed) and to (x - 1, y) one row
// down (bits 8-15; (x, y - 1) is one lane further), and those rows' sizes
// (bits 22-27 and 16-21).  An offset beyond +-64 leaves a band of 32 lanes
// wherever it starts, and is cut to that.  q: the row's dd, up, sp1, sp2.
__device__ __forceinline__ int step_word(const int* q) {
  const int dd = min(max(q[0], -64), 64), up = min(max(q[1], -64), 64);
  return (dd & 0xff) | (up & 0xff) << 8 | q[2] << 16 | q[3] << 22;
}

// Once window `win` has arrived: each row's step word.
__device__ __forceinline__ void settle_window(int* s_step, const int* s_raw,
                                              int win, int lane) {
  const int at = (win & 1) * TILE + lane;
  s_step[at] = step_word(s_raw + at * 4);
}

// The lane offset and the size of the row a step of kind `which` from a row
// with step word `step` goes to.
__device__ __forceinline__ int step_offset(int step, int which) {
  return which == 0 ? (int)((unsigned)step << 24) >> 24
                    : ((int)((unsigned)step << 16) >> 24) + (which == 2);
}
__device__ __forceinline__ int step_size(int step, int which) {
  return (which == 0 ? step >> 22 : step >> 16) & 63;
}

// The move a step takes from pointer `zz` in run state `inrun`: a run goes
// on where its continuation bit is set (bit 2 for a run of 1s, bit 3 for a
// run of 2s).
__device__ __forceinline__ int step_kind(int zz, int inrun) {
  return (inrun != 0 && ((zz >> (inrun + 1)) & 1)) ? inrun : (zz & 3);
}

// w > 32: a window is TILE rows of `slice` lanes (SLICE, or w if less) from
// a 16-byte boundary near the lane the walk had when it was asked for, and
// each row's dd, up, sp1, sp2.  Returns the window's first lane.
__device__ __forceinline__ int stage_slice(uint8_t* s_rows, int* s_raw,
                                           const uint8_t* out, const int* par,
                                           int win, int nd1, int w, int slice,
                                           int center, int lane) {
  const int slot = win & 1, chunks = slice / 16;
  const int lo = min(max((center - slice / 2) & ~15, 0), w - slice);
  for (int x = lane; x < TILE * chunks; x += 32) {
    const int rr = x / chunks, at = x - rr * chunks;
    const int row = win * TILE + rr;
    if (row < nd1)
      __pipeline_memcpy_async(s_rows + (slot * TILE + rr) * slice + at * 16,
                              out + (long long)row * w + lo + at * 16, 16);
  }
  const int row = win * TILE + lane;
  if (row < nd1) {
    int* dst = s_raw + (slot * TILE + lane) * 4;
    const int* src = par + (long long)row * N_PARAMS;
    __pipeline_memcpy_async(dst, src + P_DD, 4);
    __pipeline_memcpy_async(dst + 1, src + P_UP, 4);
    __pipeline_memcpy_async(dst + 2, src + P_SP1, 4);
    __pipeline_memcpy_async(dst + 3, src + P_SP2, 4);
  }
  __pipeline_commit();
  return lo;
}

// The moves of a walk, written from `mv_end` backwards 32 steps at a time:
// the walk keeps each step's move as two bits (in two masks) and the cell
// the chunk began at; then lane j finds the cell of step j by counting
// bits, loads its two codes and stores its byte, so that no step of the
// walk waits for a code or a store.  `count`: the moves written before.
struct Moves {
  const uint8_t* s1;  // s1[x] is the code of x - 1
  const uint8_t* s2;
  uint8_t* mv_end;
  int count, held, xs, ys;
  unsigned m_lo, m_hi;

  __device__ __forceinline__ void take(int which) {
    m_lo |= (unsigned)(which & 1) << held;
    m_hi |= (unsigned)(which >> 1) << held;
    ++held;
  }
  __device__ __forceinline__ void flush(int x, int y, int lane) {
    if (lane < held) {
      const unsigned below = (1u << lane) - 1;
      const int which = ((m_lo >> lane) & 1) | ((m_hi >> lane) & 1) << 1;
      // x went down at every earlier step that was not 2, y at every one
      // that was not 1
      const int xb = xs - __popc(~m_hi & below);
      const int yb = ys - __popc(~m_lo & below);
      mv_end[-1 - (count + lane)] =
          which == 0 ? (__ldg(s1 + xb) == __ldg(s2 + yb) ? 1 : 0)
                     : (uint8_t)(which + 1);
    }
    count += held;
    held = 0;
    m_lo = m_hi = 0;
    xs = x;
    ys = y;
  }
};

// The pair `p` of segment g: first_seg (int32 [n_pairs + 1]) holds the first
// segment of each pair, in the class table's order.
__device__ __forceinline__ int pair_of_segment(const int* first_seg,
                                               int n_pairs, int g) {
  int lo = 0, hi = n_pairs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(first_seg + mid) <= g) lo = mid;
    else hi = mid;
  }
  return lo;
}

// The cell (x, y) of lane `ln` of row r (diagonal r + 2).
__device__ __forceinline__ void cell_of(const int* par, int r, int ln, int d2,
                                        int& x, int& y) {
  const int* q = par + (long long)r * N_PARAMS;
  if (r + 2 < d2) {
    x = __ldg(q + P_X0) + ln;
    y = r + 3 - x;
  } else {
    y = __ldg(q + P_Y0) - ln;
    x = r + 3 - y;
  }
}

// The entry code of the walk's start (d1, d2) on the pair's last row.
__device__ __forceinline__ unsigned start_code(const int* par, int nd1, int d1,
                                               int d2) {
  const int* q = par + (long long)(nd1 - 1) * N_PARAMS;
  const int ln = nd1 + 1 < d2 ? d1 - __ldg(q + P_X0) : __ldg(q + P_Y0) - d2;
  return (unsigned)ln < 32u ? (unsigned)ln : WALK_STOP;
}

// The narrow walk (w <= 32), step 1: a block a segment of seg_rows rows
// (pair b's from row k * seg_rows up), its pointer rows and step words in
// shared memory, a thread an entry code.  Each walks inside the segment
// until it stops or leaves it, and writes (steps << 8 | exit code) to
// tables[g * WALK_ENTRIES + code].  A pair's top segment is entered only at
// the walk's start: its other codes are not walked.
__global__ void __launch_bounds__(WALK_ENTRIES)
k_walk_tables(const int* __restrict__ params,
              const long long* __restrict__ table,
              const uint8_t* __restrict__ rows,
              const int* __restrict__ first_seg, int n_pairs, int seg_rows,
              unsigned* __restrict__ tables) {
  extern __shared__ __align__(16) uint8_t s_seg[];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int b = pair_of_segment(first_seg, n_pairs, g);
  const long long* tab = table + (long long)b * N_TABLE;
  const int w = (int)tab[T_WMAX], nd1 = (int)tab[T_DIAGS];
  const int d1 = (int)tab[T_N1] - SEQ_PAD, d2 = (int)tab[T_N2] - SEQ_PAD;
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const int lo = (g - __ldg(first_seg + b)) * seg_rows;
  const int hi = min(nd1, lo + seg_rows);
  const bool top = hi == nd1;
  // rows [lo, hi): w bytes each, then a step word each
  uint8_t* s_ptr = s_seg;
  int* s_step = reinterpret_cast<int*>(s_seg + (size_t)seg_rows * 32);
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        rows + tab[T_ROWS] + (long long)lo * w);
    uint4* dst = reinterpret_cast<uint4*>(s_ptr);
    const int n16 = (hi - lo) * w / 16;
    for (int i = tid; i < n16; i += blockDim.x) dst[i] = src[i];
    for (int r = lo + tid; r < hi; r += blockDim.x) {
      const int* q = par + (long long)r * N_PARAMS;
      const int raw[4] = {__ldg(q + P_DD), __ldg(q + P_UP), __ldg(q + P_SP1),
                          __ldg(q + P_SP2)};
      s_step[r - lo] = step_word(raw);
    }
  }
  __syncthreads();
  const unsigned code = (unsigned)tid;
  if (top && code != start_code(par, nd1, d1, d2)) return;
  const int diag1 = tab[T_DIAG1] != 0 ? 0 : 0xF;
  const int sel = tid >> 5;
  int ln = tid & 31, r = sel < 3 ? hi - 1 : hi - 2, inrun = sel < 3 ? sel : 0;
  int x, y;
  cell_of(par, r, ln, d2, x, y);
  int zz = ln < __ldg(par + (long long)r * N_PARAMS + P_SIZE)
               ? s_ptr[(r - lo) * w + ln] : 0xF;
  int step = s_step[r - lo], steps = 0;
  unsigned exit = WALK_STOP;
  while ((zz & 3) != 3) {
    const int which = step_kind(zz, inrun);
    ++steps;
    x -= which != 2;
    y -= which != 1;
    inrun = which;
    if (x <= 0 || y <= 0) break;
    ln += step_offset(step, which);
    const bool inside = (unsigned)ln < (unsigned)step_size(step, which);
    r -= which == 0 ? 2 : 1;
    if (r < lo) {
      if (r < 0) {  // diagonal 1, from which every move leaves the matrix
        zz = r == -1 ? diag1 : 0xF;
        continue;
      }
      if (inside) exit = (unsigned)((r == lo - 1 ? inrun : 3) << 5 | ln);
      break;
    }
    step = s_step[r - lo];
    zz = inside ? s_ptr[(r - lo) * w + ln] : 0xF;
  }
  tables[(long long)g * WALK_ENTRIES + code] = (unsigned)steps << 8 | exit;
}

// Step 2: a thread a pair goes down its segments from the top, a lookup
// each, and writes each segment's true entry code and the index of its
// first move (WALK_STOP: the walk ended above it), and the pair's count.
__global__ void k_walk_compose(const int* __restrict__ params,
                               const long long* __restrict__ table,
                               const int* __restrict__ first_seg, int n_pairs,
                               const unsigned* __restrict__ tables,
                               int2* __restrict__ seg_entry,
                               int* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_pairs) return;
  const long long* tab = table + (long long)b * N_TABLE;
  const int nd1 = (int)tab[T_DIAGS];
  const int d1 = (int)tab[T_N1] - SEQ_PAD, d2 = (int)tab[T_N2] - SEQ_PAD;
  unsigned state =
      start_code(params + tab[T_PARAMS] * N_PARAMS, nd1, d1, d2);
  const int g0 = first_seg[b];
  int total = 0;
  for (int g = first_seg[b + 1] - 1; g >= g0; --g) {
    seg_entry[g] = make_int2((int)state, total);
    if (state == WALK_STOP) continue;
    const unsigned e = tables[(long long)g * WALK_ENTRIES + state];
    total += (int)(e >> 8);
    state = e & 0xff;
  }
  counts[tab[T_PAIR]] = total;
}

// Step 3: a warp a segment walks from its true entry code until the walk
// stops or leaves the segment, over windows of 32 rows in shared memory
// (cp.async, the window below already on its way), and writes its moves
// from the index of its first.  All lanes walk the same cells.
__global__ void __launch_bounds__(PAIR_WARPS * 32)
k_walk_replay(const uint8_t* __restrict__ codes,
              const int* __restrict__ params,
              const long long* __restrict__ table, const uint8_t* rows,
              const int* __restrict__ first_seg, int n_pairs, int n_segs,
              int seg_rows, const int2* __restrict__ seg_entry,
              uint8_t* __restrict__ moves) {
  __shared__ __align__(16) uint8_t s_rows_all[PAIR_WARPS][2 * TILE * 32];
  __shared__ int s_raw_all[PAIR_WARPS][2 * TILE * 4];
  __shared__ int s_step_all[PAIR_WARPS][2 * TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * PAIR_WARPS + warp;
  if (g >= n_segs) return;
  const int2 entry = seg_entry[g];
  if ((unsigned)entry.x == WALK_STOP) return;
  const int b = pair_of_segment(first_seg, n_pairs, g);
  const long long* tab = table + (long long)b * N_TABLE;
  const int w = (int)tab[T_WMAX], nd1 = (int)tab[T_DIAGS], nd = nd1 + 1;
  const int d2 = (int)tab[T_N2] - SEQ_PAD;
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const uint8_t* out = rows + tab[T_ROWS];
  const int lo = (g - __ldg(first_seg + b)) * seg_rows;
  const int hi = min(nd1, lo + seg_rows);
  uint8_t* s_rows = s_rows_all[warp];
  int* s_raw = s_raw_all[warp];
  int* s_step = s_step_all[warp];
  const int diag1 = tab[T_DIAG1] != 0 ? 0 : 0xF;
  const int sel = entry.x >> 5;
  int ln = entry.x & 31, r = sel < 3 ? hi - 1 : hi - 2;
  int inrun = sel < 3 ? sel : 0, x, y;
  cell_of(par, r, ln, d2, x, y);
  int zz = ln < __ldg(par + (long long)r * N_PARAMS + P_SIZE)
               ? out[(long long)r * w + ln] : 0xF;
  Moves mv{codes + tab[T_S1] - 1, codes + tab[T_S2] - 1,
           moves + tab[T_MOVES] + nd, entry.y, 0, x, y, 0u, 0u};

  // windows from `have` up are done with; window `win` into shared memory
  // (the walk only goes down, and the window below is already on its way)
  int have = (r >> 5) + 1;
  stage_window(s_rows, s_raw, out, par, have - 1, nd1, w, lane);
  auto enter = [&](int win) {
    __pipeline_wait_prior(0);
    have = win;
    settle_window(s_step, s_raw, have, lane);
    __syncwarp();
    if (have > 0)
      stage_window(s_rows, s_raw, out, par, have - 1, nd1, w, lane);
  };
  enter(r >> 5);
  int step = s_step[r & (2 * TILE - 1)];
  // One taken branch a step: a lone warp waits out every one.  The rare
  // cases (a chunk of moves full, a new window, the segment's end) sit
  // behind branches that are as a rule not taken.
  bool go = (zz & 3) != 3;
  while (go) {
    const int which = step_kind(zz, inrun);
    mv.take(which);
    x -= which != 2;
    y -= which != 1;
    inrun = which;
    if (mv.held == 32) mv.flush(x, y, lane);
    const int size = step_size(step, which);
    ln += step_offset(step, which);
    r -= which == 0 ? 2 : 1;
    if (r < have * TILE) {
      if (r < lo) {
        // the segment below goes on from here; below row 0, diagonal 1,
        // from which every move leaves the matrix
        zz = r == -1 ? diag1 : 0xF;
        go = lo == 0 && x > 0 && y > 0 && zz != 0xF;
        continue;
      }
      enter(r >> 5);
    }
    const int at = r & (2 * TILE - 1);
    step = s_step[at];
    zz = s_rows[at * w + (ln & 31)];
    zz = (unsigned)ln < (unsigned)size ? zz : 0xF;
    go = x > 0 && y > 0 && (zz & 3) != 3;
  }
  mv.flush(x, y, lane);
  __pipeline_wait_prior(0);
}

// The wide walk (w > 32), a warp a pair from (d1, d2) back to an edge, in
// (row, lane) coordinates: the lane of the next cell is the lane in hand
// plus the DP's own neighbour offset of the row in hand.  A window holds a
// slice of the rows around the walk's lane (dynamic shared memory, `slice`
// lanes a row); a cell outside the slice is read from device memory.
__global__ void __launch_bounds__(PAIR_WARPS * 32)
k_order_moves_wide(const uint8_t* __restrict__ codes,
                   const int* __restrict__ params,
                   const long long* __restrict__ table, const uint8_t* rows,
                   int n_pairs, int w, int slice,
                   uint8_t* __restrict__ moves, int* __restrict__ counts) {
  __shared__ int s_raw_all[PAIR_WARPS][2 * TILE * 4];
  extern __shared__ __align__(16) uint8_t s_slices[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * PAIR_WARPS + warp;
  if (b >= n_pairs) return;
  const long long* tab = table + (long long)b * N_TABLE;
  const int d1 = (int)tab[T_N1] - SEQ_PAD, d2 = (int)tab[T_N2] - SEQ_PAD;
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const int nd1 = (int)tab[T_DIAGS], nd = nd1 + 1;
  const uint8_t* out = rows + tab[T_ROWS];
  uint8_t* s_rows = s_slices + (size_t)warp * 2 * TILE * slice;
  int* s_raw = s_raw_all[warp];
  // diagonal 1 holds (1, 1) alone, element 0
  const int diag1 = tab[T_DIAG1] != 0 ? 0 : 0xF;

  int have = ((nd1 - 1) >> 5) + 1;  // windows from `have` up are done with

  // The pointer of (x, y) from device memory, and its lane in `ln`: the
  // lane of (x, y) on diagonal dn = x + y - 1 is x - x0(dn) below the d2
  // corner and y0(dn) - y from it on.
  int ln = 0;
  auto get_ptr = [&](int x, int y) -> int {
    const int r = x + y - 3;  // the row of diagonal dn
    if (r < 0 || r >= nd1) return (r == -1) ? diag1 : 0xF;
    const int* q = par + (long long)r * N_PARAMS;
    ln = r + 2 < d2 ? x - __ldg(q + P_X0) : __ldg(q + P_Y0) - y;
    if (ln < 0 || ln >= __ldg(q + P_SIZE)) return 0xF;
    return out[(long long)r * w + ln];
  };
  // Window `win` into shared memory (the walk only goes down, and the
  // window below is already on its way), and the next one asked for,
  // centred on the lane in hand.
  int lo0 = 0, lo1 = 0;  // the first lane of the slice in slot 0, 1
  auto enter = [&](int win) {
    __pipeline_wait_prior(0);
    have = win;
    __syncwarp();
    if (have > 0) {
      const int lo = stage_slice(s_rows, s_raw, out, par, have - 1, nd1, w,
                                 slice, ln, lane);
      if ((have - 1) & 1) lo1 = lo;
      else lo0 = lo;
    }
  };

  int x = d1, y = d2, inrun = 0;
  Moves mv{codes + tab[T_S1] - 1, codes + tab[T_S2] - 1,
           moves + tab[T_MOVES] + nd, 0, 0, x, y, 0u, 0u};
  int zz = get_ptr(x, y);
  // the row of the cell in hand
  int r = nd1 - 1;
  {
    const int lo = stage_slice(s_rows, s_raw, out, par, have - 1, nd1, w,
                               slice, ln, lane);
    if ((have - 1) & 1) lo1 = lo;
    else lo0 = lo;
  }
  enter(r >> 5);
  bool go = (zz & 3) != 3;  // 3: off the band
  while (go) {
    const int which = step_kind(zz, inrun);
    mv.take(which);
    x -= which != 2;
    y -= which != 1;
    inrun = which;
    if (mv.held == 32) mv.flush(x, y, lane);
    const int* q = s_raw + (r & (2 * TILE - 1)) * 4;  // dd, up, sp1, sp2
    const int off = which == 0 ? q[0] : q[1] + (which == 2);
    const int size = which == 0 ? q[3] : q[2];
    r -= which == 0 ? 2 : 1;
    ln += off;
    if (r < have * TILE) {
      if (r < 0) {
        zz = r == -1 ? diag1 : 0xF;
        go = x > 0 && y > 0 && zz != 0xF;
        continue;
      }
      enter(r >> 5);
    }
    const int rel = ln - ((r >> 5) & 1 ? lo1 : lo0);
    if ((unsigned)ln >= (unsigned)size) zz = 0xF;
    else if ((unsigned)rel < (unsigned)slice)
      zz = s_rows[(r & (2 * TILE - 1)) * slice + rel];
    else
      zz = out[(long long)r * w + ln];
    go = x > 0 && y > 0 && (zz & 3) != 3;
  }
  mv.flush(x, y, lane);
  __pipeline_wait_prior(0);
  if (lane == 0) counts[tab[T_PAIR]] = mv.count;
}

// ---- params on the card ----------------------------------------------------

// The nine params columns of diagonals 2..nd from the band's starts, ends
// and isneck (int32 [3, nd] a pair at table[T_BAND]): the algebra of
// kernels/order_device.py::band_params_plain, a thread a diagonal.
__global__ void k_band_params(const int* __restrict__ band,
                              const long long* __restrict__ table,
                              int* __restrict__ params) {
  const long long* tab = table + (long long)blockIdx.y * N_TABLE;
  const long long nd1 = tab[T_DIAGS], nd = nd1 + 1;
  const int d2 = (int)tab[T_N2] - SEQ_PAD;
  const int* starts = band + tab[T_BAND];
  const int* ends = starts + nd;
  const int* isneck = ends + nd;
  int* out = params + tab[T_PARAMS] * N_PARAMS;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nd1;
       i += (long long)gridDim.x * blockDim.x) {
    const long long diag = i + 2;  // the diagonal's number, 2..nd
    // starts and size of diagonals diag, diag - 1, diag - 2 (0 outside 1..nd)
    const int st = starts[diag - 1], size = ends[diag - 1] - st + 1;
    const int st1 = starts[diag - 2], sz1 = ends[diag - 2] - st1 + 1;
    const bool has2 = diag - 2 >= 1;
    const int st2 = has2 ? starts[diag - 3] : 0;
    const int sz2 = has2 ? ends[diag - 3] - st2 + 1 : 0;
    const bool below = diag < d2;
    const int x0 = below ? st + 1 : (int)(diag - d2) + st + 1;
    const int y0 = below ? (int)diag - st : d2 - st;
    const int e_dd = diag - 2 < d2 ? x0 - 2 : d2 - y0 + 1;
    const int e_up = diag - 1 < d2 ? x0 - 2 : d2 - y0;
    const int e_lf = diag - 1 < d2 ? x0 - 1 : d2 - y0 + 1;
    int* o = out + i * N_PARAMS;
    o[P_SIZE] = size;
    o[P_DD] = e_dd - st2;
    o[P_UP] = e_up - st1;
    o[P_LF] = e_lf - st1;
    o[P_X0] = x0;
    o[P_Y0] = y0;
    o[P_NECK] = isneck[diag - 1];
    o[P_SP1] = sz1;
    o[P_SP2] = sz2;
  }
}

}  // namespace

// One launch for `n_pairs` pairs of one band width `wmax` (a power of two,
// 16..8192), a block each; table: int64 [n_pairs, N_TABLE].  Above 32
// lanes `words` (int16, pair b's from table[b][T_ROWS] - words_base, as many
// as its pointer bytes) takes the words first, in a launch of its own on
// the same stream; at 32 and below it is not read.  Returns the CUDA error of the
// launches, 0 when they were accepted.
extern "C" int order_band_launch(const void* codes, const void* params,
                                 const void* init, const void* table,
                                 const void* sm, int n_pairs, int wmax,
                                 int gap_start, int gap_cont, int dummy,
                                 int cb_code, void* rows, void* words,
                                 long long words_base, void* stream) {
  if (n_pairs <= 0) return 0;
  const Consts k{gap_start, gap_cont, dummy, cb_code};
  const cudaStream_t st = (cudaStream_t)stream;
  if (wmax <= 32) {
    // A chain's warp is slower beside others on its SM: spread the blocks
    // over the card by asking for so much dynamic shared memory (unused)
    // that no SM takes more than its even share of them.
    int device = 0, sms = 1;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int share = (n_pairs + sms - 1) / sms;
    const int fixed = (int)sizeof(int) * 64 + 2 * CH_TILE * 32 * 4 + 1024;
    int pad = SHARED_LIMIT / share - fixed;
    if (pad < 0 || share >= 12) pad = 0;
    cudaError_t err = cudaFuncSetAttribute(
        k_order_band_warp, cudaFuncAttributeMaxDynamicSharedMemorySize, pad);
    if (err != cudaSuccess) return (int)err;
    k_order_band_warp<<<n_pairs, (1 + PRODUCERS) * 32, pad, st>>>(
        (const uint8_t*)codes, (const int*)params, (const int*)init,
        (const long long*)table, (const int*)sm, wmax, k, (uint8_t*)rows);
    return (int)cudaGetLastError();
  }
  if (wmax > NEW_ITEMS * CHAIN_MAX) return cudaErrorInvalidValue;
  // the words on the whole card first
  if (words == nullptr || n_pairs > 65535) return cudaErrorInvalidValue;
  const int gx = max(1, min(4096, 8192 / n_pairs));
  k_band_words<<<dim3(gx, n_pairs), 256, 0, st>>>(
      (const uint8_t*)codes, (const int*)params, (const long long*)table,
      (const int*)sm, wmax, cb_code, words_base, (uint16_t*)words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (wmax <= REG_MAX_W) {
    // a block a pair of wmax / K chain threads (K = 2 at 64, 4 at 128, 8
    // above; one warp up to 256 lanes); shared memory: five rows of w ints
    // for a jump and the ring of words
    const int lanes = wmax >= 256 ? 8 : wmax / 32;
    const size_t shared = (size_t)5 * wmax * sizeof(int)
                          + (size_t)RING * wmax * sizeof(uint16_t);
    auto kernel = wmax > 256 ? k_order_band_reg<8, false>
                  : lanes == 8 ? k_order_band_reg<8, true>
                  : lanes == 4 ? k_order_band_reg<4, true>
                               : k_order_band_reg<2, true>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_pairs, wmax / lanes, shared, st>>>(
        (const int*)params, (const int*)init, (const long long*)table,
        (const uint16_t*)words, words_base, wmax, k, (uint8_t*)rows);
    return (int)cudaGetLastError();
  }
  // 8192: CHAIN_MAX threads, M, N, O of two diagonals and two diagonals of
  // words in shared memory
  const size_t shared = (size_t)6 * wmax * sizeof(int)
                        + (size_t)2 * wmax * sizeof(uint16_t);
  err = cudaFuncSetAttribute(
      k_order_band, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  k_order_band<<<n_pairs, CHAIN_MAX, shared, st>>>(
      (const int*)params, (const int*)init, (const long long*)table,
      (const uint16_t*)words, words_base, wmax, k, (uint8_t*)rows);
  return (int)cudaGetLastError();
}

// The traceback of `n_pairs` pairs of one `wmax` over the pointer rows that
// order_band_launch wrote: pair b's moves end at moves[table[b][T_MOVES] +
// nd], counts[table[b][T_PAIR]] of them.  At wmax <= 32 three kernels in a
// row: the segments' tables, the composition, the replay, over segments of
// seg_rows rows (a multiple of 32): first_seg int32 [n_pairs + 1] (pair b's
// segments are first_seg[b] .. first_seg[b + 1] - 1, n_segs in all), and
// the scratch tables (uint32 [n_segs * WALK_ENTRIES]) and seg_entry (int32
// [n_segs * 2]).  Above, one kernel; those four are not read.  split_ms
// (host float [3], or null): at wmax <= 32 the three kernels' ms, from
// events around each, the call waiting for the last.
extern "C" int order_moves_launch(const void* codes, const void* params,
                                  const void* table, const void* rows,
                                  int n_pairs, int wmax, int seg_rows,
                                  const void* first_seg, int n_segs,
                                  void* tables, void* seg_entry, void* moves,
                                  void* counts, void* stream,
                                  float* split_ms) {
  if (n_pairs <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wmax <= 32) {
    if (seg_rows < TILE || seg_rows % TILE != 0 || n_segs < n_pairs)
      return cudaErrorInvalidValue;
    const int shared = seg_rows * (32 + (int)sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(
        k_walk_tables, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    cudaEvent_t ev[4] = {};
    for (int i = 0; split_ms && i < 4 && err == cudaSuccess; ++i)
      err = cudaEventCreate(&ev[i]);
    if (split_ms && err == cudaSuccess) err = cudaEventRecord(ev[0], st);
    if (err == cudaSuccess) {
      k_walk_tables<<<n_segs, WALK_ENTRIES, shared, st>>>(
          (const int*)params, (const long long*)table, (const uint8_t*)rows,
          (const int*)first_seg, n_pairs, seg_rows, (unsigned*)tables);
      err = cudaGetLastError();
    }
    if (split_ms && err == cudaSuccess) err = cudaEventRecord(ev[1], st);
    if (err == cudaSuccess) {
      k_walk_compose<<<(n_pairs + 127) / 128, 128, 0, st>>>(
          (const int*)params, (const long long*)table, (const int*)first_seg,
          n_pairs, (const unsigned*)tables, (int2*)seg_entry, (int*)counts);
      err = cudaGetLastError();
    }
    if (split_ms && err == cudaSuccess) err = cudaEventRecord(ev[2], st);
    if (err == cudaSuccess) {
      k_walk_replay<<<(n_segs + PAIR_WARPS - 1) / PAIR_WARPS,
                      PAIR_WARPS * 32, 0, st>>>(
          (const uint8_t*)codes, (const int*)params, (const long long*)table,
          (const uint8_t*)rows, (const int*)first_seg, n_pairs, n_segs,
          seg_rows, (const int2*)seg_entry, (uint8_t*)moves);
      err = cudaGetLastError();
    }
    if (split_ms && err == cudaSuccess) {
      err = cudaEventRecord(ev[3], st);
      if (err == cudaSuccess) err = cudaEventSynchronize(ev[3]);
      for (int i = 0; i < 3 && err == cudaSuccess; ++i)
        err = cudaEventElapsedTime(split_ms + i, ev[i], ev[i + 1]);
    }
    for (int i = 0; i < 4; ++i)
      if (ev[i]) cudaEventDestroy(ev[i]);
    return (int)err;
  }
  const int blocks = (n_pairs + PAIR_WARPS - 1) / PAIR_WARPS;
  const int slice = min(wmax, SLICE);
  const int shared = PAIR_WARPS * 2 * TILE * slice;
  cudaError_t err = cudaFuncSetAttribute(
      k_order_moves_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (err != cudaSuccess) return (int)err;
  k_order_moves_wide<<<blocks, PAIR_WARPS * 32, shared, st>>>(
      (const uint8_t*)codes, (const int*)params, (const long long*)table,
      (const uint8_t*)rows, n_pairs, wmax, slice, (uint8_t*)moves,
      (int*)counts);
  return (int)cudaGetLastError();
}

// params int32 [*, 9] of `n_pairs` pairs from band int32 (starts, ends,
// isneck of each pair end to end); max_diags: the most diagonals of a pair.
extern "C" int band_params_launch(const void* band, const void* table,
                                  int n_pairs, long long max_diags,
                                  void* params, void* stream) {
  if (n_pairs <= 0 || max_diags <= 0) return 0;
  long long blocks = (max_diags + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  if (n_pairs > 65535) return cudaErrorInvalidValue;
  k_band_params<<<dim3((unsigned)blocks, (unsigned)n_pairs), 256, 0,
                  (cudaStream_t)stream>>>(
      (const int*)band, (const long long*)table, (int*)params);
  return (int)cudaGetLastError();
}
