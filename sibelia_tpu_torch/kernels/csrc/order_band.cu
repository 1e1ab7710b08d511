// Band DP of the LAGAN order stage, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by kernels/order_device.py.
//
// Replaces the lax.scan of sibelia_tpu/kernels/order_device.py::_make_run
// (lines 98-171, jitted at 180, vmapped at 191): for one anchored pair,
// diagonals 2..nd of the 3-state (M/N/O) int32 recurrence over a band of at
// most wmax lanes, one uint8 pointer a lane a diagonal (bit 2: N extends,
// bit 3: O extends, bits 0-1: the best of M, N, O).  The native library
// builds the band before and walks the pointers back after.
//
// Bound: the chain.  A diagonal needs the two before it, so a pair of L
// bases is about 2 L dependent steps whatever the card's width; bytes (36 B
// of params and wmax B of pointers a diagonal) and operations (about 40 a
// lane) are far below what the card could move or do in that time.  The
// design therefore shortens a step, and runs pairs side by side:
//   * one block a pair, the diagonal loop inside the kernel, a thread a
//     lane (a strided loop of lanes above 1024);
//   * the band in shared memory.  Up to wmax = 4096 three diagonals of
//     M, N, O rotate (36 wmax bytes), so a step writes the new diagonal
//     while others still read the two before it and needs ONE barrier;
//     at wmax = 8192 only two fit (192 KB of the 227 KB a block can ask
//     for), a thread keeps its 8 new lanes in registers and a step needs
//     two barriers;
//   * params two diagonals and the two sequence codes one diagonal ahead
//     in registers, so that no step waits for device memory;
//   * a neck diagonal takes a block-wide maximum (one more barrier) and
//     renormalises the new and the previous diagonal in place, each
//     thread its own lanes;
//   * one launch serves all pairs of one wmax, the longest chain first.
//
// All sums wrap as int32 does under XLA (unsigned arithmetic here): DUMMY
// + gap and DUMMY - norm must give the same bits as the plain version.
// Every lane of a row is written; only lanes inside the band (j < size)
// are part of the contract, as the traceback reads no other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int WIDE_ITEMS = 8;  // lanes a thread at wmax = 8192
// int64 columns of the per-pair table (kernels/order_device.py)
enum { T_S1, T_N1, T_S2, T_N2, T_PARAMS, T_DIAGS, T_INIT, T_ROWS, T_WMAX,
       N_TABLE };
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

// One cell: lane j of the diagonal `r` from the previous diagonal p1 and
// the one before, p2 (each M, N, O at stride w).  Returns the pointer;
// m, n, o are masked to DUMMY outside the band.
__device__ __forceinline__ int cell(const Row& r, int j, int c1, int c2,
                                    const int* p1, const int* p2, int w,
                                    const int* sm, const Consts& k, int& m,
                                    int& n, int& o) {
  int idx = j + r.v[P_DD];
  const bool okd = idx >= 0 && idx < r.v[P_SP2];
  const int dm = okd ? p2[idx] : k.dummy;
  const int dn = okd ? p2[w + idx] : k.dummy;
  const int dO = okd ? p2[2 * w + idx] : k.dummy;
  idx = j + r.v[P_UP];
  const int un = (idx >= 0 && idx < r.v[P_SP1]) ? p1[w + idx] : k.dummy;
  idx = j + r.v[P_LF];
  const int lo = (idx >= 0 && idx < r.v[P_SP1]) ? p1[2 * w + idx] : k.dummy;
  const bool cb1 = c1 == k.cb_code, cb2 = c2 == k.cb_code;
  const int g_cont1 = cb1 ? 0 : k.gap_cont, g_cont2 = cb2 ? 0 : k.gap_cont;
  const int s1v = dm, s2v = wadd(dn, g_cont2), s3v = wadd(dO, g_cont1);
  const int best = s1v >= s2v ? (s1v >= s3v ? s1v : s3v)
                              : (s2v >= s3v ? s2v : s3v);
  const int cm = wadd(sm[c1 * 8 + c2], best);
  const int t1 = wadd(cm, cb2 ? 0 : k.gap_start), t2 = wadd(un, g_cont2);
  const bool takes_n = t1 >= t2;
  const int cn = takes_n ? t1 : t2;
  const int u1 = wadd(cm, cb1 ? 0 : k.gap_start), u2 = wadd(lo, g_cont1);
  const bool takes_o = u1 >= u2;
  const int co = takes_o ? u1 : u2;
  const int ptr = (takes_n ? 0 : 4) | (takes_o ? 0 : 8)
                  | (cm >= cn ? (cm < co ? 2 : 0) : (cn >= co ? 1 : 2));
  const bool inband = j < r.v[P_SIZE];
  m = inband ? cm : k.dummy;
  n = inband ? cn : k.dummy;
  o = inband ? co : k.dummy;
  return ptr;
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

// The maximum of v over the block; holds one barrier.  s_part is not
// written again before the next barrier of the caller.
__device__ __forceinline__ int block_max(int v, int* s_part, int dummy) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  v = __reduce_max_sync(FULL, v);
  if (lane == 0) s_part[threadIdx.x >> 5] = v;
  __syncthreads();
  return __reduce_max_sync(FULL, lane < warps ? s_part[lane] : dummy);
}

// WIDE false: three rotating diagonals in shared memory, one barrier a
// step, any number of lanes a thread.  WIDE true: two diagonals, the new
// one in registers (WIDE_ITEMS lanes a thread), two barriers a step.
template <bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS)
k_order_band(const uint8_t* __restrict__ codes, const int* __restrict__ params,
             const int* __restrict__ init, const long long* __restrict__ table,
             const int* __restrict__ sm, int w, Consts k,
             uint8_t* __restrict__ rows) {
  extern __shared__ int s_band[];
  __shared__ int s_sm[64];
  __shared__ int s_part[32];
  const long long* tab = table + (long long)blockIdx.x * N_TABLE;
  Pair pair;
  pair.s1 = codes + tab[T_S1];
  pair.n1 = (int)tab[T_N1];
  pair.s2 = codes + tab[T_S2];
  pair.n2 = (int)tab[T_N2];
  const int* par = params + tab[T_PARAMS] * N_PARAMS;
  const long long nd1 = tab[T_DIAGS];
  const int* ini = init + tab[T_INIT];
  uint8_t* out = rows + tab[T_ROWS];
  const int tid = threadIdx.x, nthreads = blockDim.x;

  int* p1 = s_band;
  int* p2 = s_band + 3 * w;
  int* nxt = WIDE ? nullptr : s_band + 6 * w;
  for (int x = tid; x < 64; x += nthreads) s_sm[x] = sm[x];
  for (int x = tid; x < 3 * w; x += nthreads) {
    p1[x] = ini[x];
    p2[x] = k.dummy;
  }
  Row cur = load_row(par, 0, nd1), nx = load_row(par, 1, nd1);
  // lane tid's codes, one diagonal ahead (further lanes load their own)
  int c1 = code1(pair, cur, tid), c2 = code2(pair, cur, tid);
  __syncthreads();

  for (long long t = 0; t < nd1; ++t) {
    const Row nx2 = load_row(par, t + 2, nd1);
    const int c1n = code1(pair, nx, tid), c2n = code2(pair, nx, tid);
    uint8_t* orow = out + t * w;
    int best = k.dummy;
    if constexpr (WIDE) {
      int rm[WIDE_ITEMS], rn[WIDE_ITEMS], ro[WIDE_ITEMS];
#pragma unroll
      for (int i = 0; i < WIDE_ITEMS; ++i) {
        const int j = tid + i * MAX_THREADS;
        const int a = i ? code1(pair, cur, j) : c1;
        const int b = i ? code2(pair, cur, j) : c2;
        orow[j] = (uint8_t)cell(cur, j, a, b, p1, p2, w, s_sm, k, rm[i],
                                rn[i], ro[i]);
        best = max(best, rm[i]);
      }
      const bool neck = cur.v[P_NECK] == 1;
      int norm = 0;
      if (neck) norm = block_max(best, s_part, k.dummy);
      else __syncthreads();
      // every read of p1 and p2 is done: the new diagonal takes p2's place
#pragma unroll
      for (int i = 0; i < WIDE_ITEMS; ++i) {
        const int j = tid + i * MAX_THREADS;
        if (neck) {
          if (j < cur.v[P_SIZE]) renorm(rm[i], rn[i], ro[i], norm);
          if (j < cur.v[P_SP1]) renorm(p1[j], p1[w + j], p1[2 * w + j], norm);
        }
        p2[j] = rm[i];
        p2[w + j] = rn[i];
        p2[2 * w + j] = ro[i];
      }
      __syncthreads();
      int* s = p1;
      p1 = p2;
      p2 = s;
    } else {
      for (int j = tid; j < w; j += nthreads) {
        const int a = j == tid ? c1 : code1(pair, cur, j);
        const int b = j == tid ? c2 : code2(pair, cur, j);
        int m, n, o;
        orow[j] = (uint8_t)cell(cur, j, a, b, p1, p2, w, s_sm, k, m, n, o);
        nxt[j] = m;
        nxt[w + j] = n;
        nxt[2 * w + j] = o;
        best = max(best, m);
      }
      if (cur.v[P_NECK] == 1) {
        // the barrier inside also ends every read of p1
        const int norm = block_max(best, s_part, k.dummy);
        for (int j = tid; j < w; j += nthreads) {
          if (j < cur.v[P_SIZE])
            renorm(nxt[j], nxt[w + j], nxt[2 * w + j], norm);
          if (j < cur.v[P_SP1]) renorm(p1[j], p1[w + j], p1[2 * w + j], norm);
        }
      }
      __syncthreads();
      int* s = p2;
      p2 = p1;
      p1 = nxt;
      nxt = s;
    }
    cur = nx;
    nx = nx2;
    c1 = c1n;
    c2 = c2n;
  }
}

}  // namespace

// One launch for `n_pairs` pairs of one band width `wmax` (a power of two,
// 16..8192), a block each; table: int64 [n_pairs, N_TABLE].  Returns the
// CUDA error of the launch, 0 when it was accepted.
extern "C" int order_band_launch(const void* codes, const void* params,
                                 const void* init, const void* table,
                                 const void* sm, int n_pairs, int wmax,
                                 int gap_start, int gap_cont, int dummy,
                                 int cb_code, void* rows, void* stream) {
  if (n_pairs <= 0) return 0;
  const Consts k{gap_start, gap_cont, dummy, cb_code};
  const bool wide = wmax > 4096;
  if (wide && wmax != WIDE_ITEMS * MAX_THREADS) return cudaErrorInvalidValue;
  const int threads = wmax < 32 ? 32 : (wmax > MAX_THREADS ? MAX_THREADS : wmax);
  const size_t shared = (size_t)(wide ? 6 : 9) * wmax * sizeof(int);
  auto kernel = wide ? k_order_band<true> : k_order_band<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_pairs, threads, shared, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int*)params, (const int*)init,
      (const long long*)table, (const int*)sm, wmax, k, (uint8_t*)rows);
  return (int)cudaGetLastError();
}
