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
// Bound: operations, 2n events of n lanes (bytes are O(n)); for small sets
// the chain of 2n dependent events.  The design:
//   * one block a hit set, the event loop inside the kernel, several sets
//     in one launch (an offsets table);
//   * a_e, sofar and alive in shared memory where 9 n bytes fit (n <=
//     shared_hits), else in device memory (sofar in its output array):
//     no size at which the sweep gives up;
//   * an event is a scan of each thread's lanes and a block-wide
//     lexicographic maximum in three hardware warp reductions a level
//     (a_e, then sofar as order-preserving bits, then the index), one
//     barrier between the two levels and one after the update;
//   * an event's hit, key and score are loaded one and two events ahead.
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

__global__ void __launch_bounds__(1024)
k_anchors_sweep(const int* __restrict__ a_s_all, const int* __restrict__ a_e_all,
                const float* __restrict__ score_all,
                const int* __restrict__ ev_hit_all,
                const int* __restrict__ ev_isstart_all,
                const long long* __restrict__ offsets, int shared_hits,
                int shared_cap, float* __restrict__ sofar_all,
                int* __restrict__ bk_all, int* __restrict__ best_out,
                float* __restrict__ best_val_out,
                uint8_t* __restrict__ alive_all) {
  extern __shared__ int s_dyn[];
  __shared__ int s_ae[32];
  __shared__ unsigned s_sb[32];
  __shared__ int s_idx[32];
  const long long lo = offsets[blockIdx.x];
  const int n = (int)(offsets[blockIdx.x + 1] - lo);
  const int* a_s = a_s_all + lo;
  const int* a_e = a_e_all + lo;
  const float* score = score_all + lo;
  const int* ev_hit = ev_hit_all + 2 * lo;
  const int* ev_isstart = ev_isstart_all + 2 * lo;
  float* sofar_out = sofar_all + lo;
  int* bk = bk_all + lo;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  const bool in_shared = n <= shared_hits;
  int* ae;
  float* sf;
  uint8_t* al;
  if (in_shared) {
    ae = s_dyn;
    sf = reinterpret_cast<float*>(s_dyn + shared_cap);
    al = reinterpret_cast<uint8_t*>(s_dyn + 2 * shared_cap);
  } else {
    ae = const_cast<int*>(a_e);  // read only
    sf = sofar_out;
    al = alive_all + lo;
  }
  for (int i = tid; i < n; i += nthreads) {
    if (in_shared) ae[i] = a_e[i];
    sf[i] = 0.0f;
    al[i] = 0;
    bk[i] = -1;
  }
  const int ne = 2 * n;
  // the event in hand, and the hit of the one after it
  int h = ev_hit[0], st = ev_isstart[0];
  int key = st == 1 ? a_s[h] : a_e[h];
  float sc = score[h];
  int h1 = ne > 1 ? ev_hit[1] : 0, st1 = ne > 1 ? ev_isstart[1] : 0;
  __syncthreads();

  for (int e = 0; e < ne; ++e) {
    const int key1 = st1 == 1 ? __ldg(a_s + h1) : __ldg(a_e + h1);
    const float sc1 = __ldg(score + h1);
    const int h2 = e + 2 < ne ? __ldg(ev_hit + e + 2) : 0;
    const int st2 = e + 2 < ne ? __ldg(ev_isstart + e + 2) : 0;

    Pick v{IMIN, 0u, IMAX};
    for (int i = tid; i < n; i += nthreads) {
      const int a = ae[i];
      if (al[i] && a < key) {
        const unsigned sb = ordered(sf[i]);
        // ascending i: a strict comparison keeps the first index
        if (a > v.ae || (a == v.ae && sb > v.sb)) v = Pick{a, sb, i};
      }
    }
    v = block_pick(v, s_ae, s_sb, s_idx);
    const bool any = v.idx != IMAX;
    const float hs = any ? unordered(v.sb) : NEG;
    if (st == 1) {
      if (tid == 0) {
        const bool chain = any && hs > 0.0f;
        sf[h] = sc + (chain ? hs : 0.0f);
        bk[h] = chain ? v.idx : -1;
      }
    } else {
      const float sfh = sf[h];
      const bool refuse = any && hs > sfh;
      // every thread has read sf[h] and al[] is written by its lanes' owner
      for (int i = tid; i < n; i += nthreads) {
        if (i == h) al[i] = refuse ? 0 : 1;
        else if (!refuse && al[i] && ae[i] >= key && sf[i] <= sfh) al[i] = 0;
      }
    }
    __syncthreads();
    h = h1; st = st1; key = key1; sc = sc1;
    h1 = h2; st1 = st2;
  }

  // final pick: the largest sofar among alive, the smallest a_e, the first
  Pick v{IMIN, 0u, IMAX};
  for (int i = tid; i < n; i += nthreads) {
    if (al[i]) {
      const unsigned sb = ordered(sf[i]);
      const int na = ~ae[i];  // the largest ~a_e is the smallest a_e
      if (sb > v.sb || (sb == v.sb && na > v.ae) || v.idx == IMAX)
        v = Pick{na, sb, i};
    }
  }
  // sofar leads here: hand block_pick (sb, ~a_e) in the places of (ae, sb)
  Pick w{(int)(v.sb ^ 0x80000000u), (unsigned)v.ae ^ 0x80000000u, v.idx};
  if (v.idx == IMAX) w = Pick{IMIN - 1, 0u, IMAX};
  w = block_pick(w, s_ae, s_sb, s_idx);
  if (tid == 0) {
    const bool any = w.idx != IMAX;
    best_out[blockIdx.x] = any ? w.idx : 0;
    best_val_out[blockIdx.x] =
        any ? unordered((unsigned)w.ae ^ 0x80000000u) : NEG;
  }
  if (in_shared)
    for (int i = tid; i < n; i += nthreads) sofar_out[i] = sf[i];
}

}  // namespace

// One launch for n_sets hit sets, a block each; offsets: int64
// [n_sets + 1] into the hits (events at twice the offset); max_hits: the
// largest set.  alive: n bytes of scratch.  Returns the CUDA error of the
// launch, 0 when it was accepted.
extern "C" int anchors_sweep_launch(
    const void* a_s, const void* a_e, const void* score, const void* ev_hit,
    const void* ev_isstart, const void* offsets, int n_sets, int max_hits,
    int shared_hits, void* sofar, void* bk, void* best, void* best_val,
    void* alive, void* stream) {
  if (n_sets <= 0) return 0;
  const int threads = max_hits <= 64 ? 32 : (max_hits <= 2048 ? 256 : 1024);
  // lanes of the shared arrays, a multiple of 4 so that each is aligned
  const int cap = ((max_hits < shared_hits ? max_hits : shared_hits) + 3) & ~3;
  const size_t shared = (size_t)cap * 9;
  cudaError_t err = cudaFuncSetAttribute(
      k_anchors_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  k_anchors_sweep<<<n_sets, threads, shared, (cudaStream_t)stream>>>(
      (const int*)a_s, (const int*)a_e, (const float*)score,
      (const int*)ev_hit, (const int*)ev_isstart, (const long long*)offsets,
      shared_hits, cap, (float*)sofar, (int*)bk, (int*)best, (float*)best_val,
      (uint8_t*)alive);
  return (int)cudaGetLastError();
}
