// Batched affine-gap global alignment (Gotoh) of short byte pairs, for
// Hopper (sm_90a): the DP, its direction bits and the traceback in one
// kernel, so that only the two aligned rows of each pair leave the card.
// Plain C interface, loaded with ctypes by kernels/gotoh.py.
//
// Replaces the Pallas TPU kernel sibelia_tpu/kernels/gotoh_pallas.py::_kernel
// (line 40; its pallas_call is at line 122 in batched_gotoh_dirs_pallas)
// together with the host traceback that follows it in batch_align_pallas
// (line 132): the TPU kernel writes four int8 planes of T x T cells, 64 KB
// a pair at T = 128, because Mosaic has no data-dependent walk.  This card
// has, so the planes never exist: a pair of lengths (n, m) reads n + m
// bytes and writes its two rows, at most 2 (n + m) bytes, and a length.
//
// Recurrence, for DP rows i = 1..n and columns j = 1..m, with S the LAGAN
// nucmatrix score (variants/scoring.py::_SM), GO = -400, GE = -25:
//
//   M[i,j]  = max(M, Ix, Iy)[i-1,j-1] + S(a[i-1], b[j-1])
//   Ix[i,j] = max(M[i-1,j] + GO + GE, Ix[i-1,j] + GE)
//   Iy[i,j] = GE*j + GO + max_{j'<j} (M[i,j'] - GE*j')
//           = max(M[i,j-1] + GO + GE, Iy[i,j-1] + GE)   for j >= 2
//
// with the borders of gotoh_pallas.py:42-46 (row 0: M = 0 at j = 0, Ix =
// NEG, Iy = GO + GE*j; column 0 of row i >= 1: M = Iy = NEG, Ix = GO +
// GE*i), so Iy[i,1] = NEG + GO + GE.  The TPU kernel takes the first form
// of Iy, a running maximum along the row, because it computes a whole row
// at once; the second form gives the same integers cell by cell, and is
// what a wavefront wants.  All values are int32, |values| < 2^29, and
// every comparison is >= as in the JAX code, so ties resolve identically.
// The score comes from a 5-class code (A, C, G, T, other) and a 5 x 5 table
// in shared memory: _SM is -43 for every pair that is not two uppercase
// ACGT.
//
// Direction bits.  The host traceback reads four planes: m_choice, ix_open,
// iy_open and cell_state.  Two of them are shifted copies of values a lane
// already holds, so four bits a cell carry the whole walk and no bit
// crosses a lane:
//   cs(i,j) = argmax(M, Ix, Iy)[i,j], ties 0 < 1 < 2        bits 0-1
//   xo(i,j) = ix_open(i,j): M[i-1,j] + GO + GE >= Ix[i-1,j] + GE   bit 2
//   yn(i,j) = iy_open(i,j+1): M[i,j] + GO + GE >= Iy[i,j] + GE     bit 3
//   m_choice(i,j) = cs(i-1,j-1) for i, j >= 2; in closed form on the
//   border: 0 at (1,1), 2 on the rest of row 1, 1 on the rest of column 1;
//   iy_open(i,1) = 0.
//
// Bound: neither bytes nor operations but latency: the chain of dependent
// steps of the longest pair of a batch, and the instructions one warp can
// issue on its own.  Design: one warp a pair, WARPS pairs a block, any
// B >= 1 (no padding), any T in 1..128, any n, m in 1..T; only rows 1..n
// and the lanes that own a column <= m do work that counts.  A lane owns
// CPL adjacent columns; each warp picks CPL = 1, 2 or 4 from its own m
// (m <= 32, <= 64, else), so a short pair does a quarter of the
// instructions of a long one, in the same launch.
//
// The rows run as a wavefront over the lanes: in step t lane l computes
// row t - l + 1 of its columns, n + lanes - 1 steps in all.  What a lane
// needs from its left neighbour is that neighbour's previous step: Iy of
// its own first column (the neighbour evaluates the recurrence one column
// further) and max(M, Ix, Iy) of the neighbour's last column, the diagonal
// predecessor of the lane's next row.  So a step has 2 shuffles, side by
// side and not one after the other, where the form that wrote planes had
// 11 on each row's chain and a running maximum of 5 dependent shuffle
// steps; between a step's shuffle and the next there is one fused
// add-and-maximum a column.  M, Ix and the best value of the previous row
// stay in registers; the scores of a lane's next row are loaded a step
// ahead.  Every lane takes part in every shuffle; a lane outside rows
// 1..n skips the step's arithmetic.
//
// The direction bits of a row go to shared memory, never to device memory:
// a byte a cell for CPL = 1 (32 bytes a row), a nibble a cell for CPL = 2
// and 4 (one byte or one 16-bit word a lane, 32 or 64 bytes a row; the
// lanes of a step write different rows and still hit 32 different banks),
// at most 8 KB a pair.  With the 896 bytes of sequence and row buffers a
// block of 4 pairs takes 35.5 KB of dynamic shared memory at T = 128, six
// blocks fit an SM, and 132 SMs hold 3168 pairs at once.
//
// Traceback: after the last step one lane walks from (n, m) as
// kernels/gotoh.py::traceback_from_dirs does (same start state, same
// rules), one load of direction bits a step and no branch on the state,
// while both i and j are above 0; it writes both rows backwards into
// shared memory.  From row 0 or column 0 on, every state of that traceback
// (its border rules and its last branch alike) writes the rest of one
// sequence against gaps, so the warp writes that prefix and the walked
// part forwards, together.  WRITE_DIRS, the same kernel body with one
// flag, also copies each computed cell's four bits as a byte of a
// [B, T, T] tensor: the wrapper batched_gotoh_dirs rebuilds the four
// planes from it so that every cell can be held against the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // pairs per block
constexpr int TMAX = 128;
constexpr int CLASSES = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DIR_ROW = 64;  // bytes of direction bits a DP row, at most
constexpr uint8_t GAP = '-';
// per pair, before the direction bits: a, b, the classes of a, two rows
constexpr int SEQ_BYTES = 3 * TMAX + 2 * 2 * TMAX;

struct PairMem {
  uint8_t* a;      // the bytes of a and of b
  uint8_t* b;
  uint8_t* a_cls;  // score class of each byte of a
  uint8_t* rev_a;  // the walked part of the aligned rows, last column first
  uint8_t* rev_b;
  uint8_t* dirs;   // direction bits of rows 1..n; the last, so that the
                   // unused read of row 0 falls into rev_b
};

template <int CPL, bool WRITE_DIRS>
__device__ void align_pair(const PairMem w, const uint8_t* s_class,
                           const int* s_score, int T, int n, int m, int lane,
                           int go, int ge, int neg,
                           uint8_t* __restrict__ dirs_out,
                           uint8_t* __restrict__ rows_out,
                           int* __restrict__ len_out) {
  constexpr int STRIDE = CPL == 4 ? DIR_ROW : DIR_ROW / 2;
  const int c0 = lane * CPL;              // DP columns c0+1 .. c0+CPL
  const int lanes = (m + CPL - 1) / CPL;  // lanes with a column <= m
  const int goge = go + ge;
  uint8_t* const dirs0 = w.dirs - STRIDE;  // row i >= 1 is at dirs0 + i*STRIDE
  // the score of a lane's next row against each of its columns, loaded a
  // step ahead, and the class of the row after it, two steps ahead, so
  // that no load stands on a step's dependent chain; before a lane's first
  // row both are row 1's, past its last they are unused
  const int* cb[CPL];  // the score table's column of b[j-1]
  int sc[CPL], Mp[CPL], Xp[CPL], Bp[CPL];
  int a_next = CLASSES * w.a_cls[min(1, n - 1)];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = c0 + k + 1;
    cb[k] = s_score + (j <= m ? s_class[w.b[j - 1]] : CLASSES - 1);
    sc[k] = cb[k][CLASSES * w.a_cls[0]];
    Mp[k] = neg;
    Xp[k] = neg;
    Bp[k] = go + ge * j;  // max(M, Ix, Iy) of row 0 is its Iy
  }
  // what a lane hands to its right neighbour after each of its rows:
  // max(M, Ix, Iy) of its last column, and Iy of the neighbour's first
  int b_out = Bp[CPL - 1], y_out = neg;
  int b_in = 0;  // max(M, Ix, Iy)[i-1, c0], received a step before its use

  // Lane l runs row t - l + 1 in step t: a wavefront over the lanes.
  for (int t = 0; t < n + lanes - 1; ++t) {
    int diag = b_in;
    b_in = __shfl_up_sync(FULL, b_out, 1);
    int Y = __shfl_up_sync(FULL, y_out, 1);  // Iy[i, c0+1]
    const int i = t - lane + 1;
    if (lane == 0) {  // the border column
      diag = i == 1 ? 0 : go + ge * (i - 1);
      Y = neg + goge;
    }
    if (i >= 1 && i <= n) {
      unsigned nib[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        bool xo, yn, c1, c2;
        const int M = diag + sc[k];
        diag = Bp[k];
        // Ix[i,j], and ix_open: M[i-1,j] + GO + GE >= Ix[i-1,j] + GE
        const int X = __vibmax_s32(Mp[k] + goge, Xp[k] + ge, &xo);
        // Y is Iy[i,j]; cs = argmax(M, Ix, Iy), ties 0 < 1 < 2
        const int xy = __vibmax_s32(X, Y, &c2);
        Bp[k] = __vibmax_s32(M, xy, &c1);
        // iy_open(i,j+1): M[i,j] + GO + GE >= Iy[i,j] + GE; then Iy[i,j+1]
        // in one fused add and maximum, the only step on the lanes' chain
        yn = M + goge >= Y + ge;
        Y = __viaddmax_s32(Y, ge, M + goge);
        nib[k] = (c1 ? 0u : (c2 ? 1u : 2u)) | (unsigned)xo << 2 |
                 (unsigned)yn << 3;
        Mp[k] = M;
        Xp[k] = X;
      }
      b_out = Bp[CPL - 1];
      y_out = Y;
      uint8_t* row = dirs0 + i * STRIDE;
      if constexpr (CPL == 1) {
        row[lane] = (uint8_t)nib[0];
      } else if constexpr (CPL == 2) {
        row[lane] = (uint8_t)(nib[0] | nib[1] << 4);
      } else {
        reinterpret_cast<uint16_t*>(row)[lane] = (uint16_t)(
            nib[0] | nib[1] << 4 | nib[2] << 8 | nib[3] << 12);
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) sc[k] = cb[k][a_next];  // row i + 1
    }
    a_next = CLASSES * w.a_cls[min(max(i + 1, 0), n - 1)];  // row i + 2
  }
  __syncwarp();

  // The bits of cell (i, j) in the low nibble.  Row 0 and column 0 are not
  // stored: they read bytes of this pair's buffers that nothing uses.
  auto cell = [&](int i, int j) -> unsigned {
    const uint8_t* row = dirs0 + i * STRIDE;
    if constexpr (CPL == 1) return row[j - 1];
    return row[(j - 1) >> 1] >> (((j - 1) & 1) * 4);
  };
  if constexpr (WRITE_DIRS) {
    for (int i = 1; i <= n; ++i)
      for (int j = lane + 1; j <= m; j += 32)
        dirs_out[(size_t)(i - 1) * T + j - 1] = (uint8_t)(cell(i, j) & 15u);
  }
  // One lane walks back from (n, m) while both i and j are above 0.  In
  // state 0 the next state is m_choice(i, j) = cs(i-1, j-1), in state 1 the
  // gap closes on ix_open(i, j), in state 2 on iy_open(i, j) = yn(i, j-1).
  // A step that reaches row 0 or column 0 reads no stored cell, and needs
  // none: from there on every state writes the rest of one sequence against
  // gaps (the border rules and the last branch of traceback_from_dirs).
  int L0 = 0, i = 0, j = 0;
  if (lane == 0) {
    i = n;
    j = m;
    unsigned state = cell(n, m) & 3u;
    while (i > 0 && j > 0) {
      const int di = state != 2, dj = state != 1;
      const unsigned v = cell(i - (state == 0), j - dj);
      w.rev_a[L0] = di ? w.a[i - 1] : GAP;
      w.rev_b[L0] = dj ? w.b[j - 1] : GAP;
      ++L0;
      i -= di;
      j -= dj;
      state = state == 0 ? (v & 3u)
                         : ((v >> (state + 1) & 1u) ? 0u : state);
    }
    *len_out = L0 + i + j;
  }
  L0 = __shfl_sync(FULL, L0, 0);
  i = __shfl_sync(FULL, i, 0);  // one of i, j is 0: a prefix of a or of b
  j = __shfl_sync(FULL, j, 0);  // is left, and opens both rows
  const int L = L0 + i + j;
  __syncwarp();
  for (int x = lane; x < L; x += 32) {
    const bool walked = x >= i + j;
    rows_out[x] = walked ? w.rev_a[L - 1 - x] : (i ? w.a[x] : GAP);
    rows_out[2 * T + x] = walked ? w.rev_b[L - 1 - x] : (j ? w.b[x] : GAP);
  }
}

template <bool WRITE_DIRS>
__global__ void __launch_bounds__(WARPS * 32, 6)
    k_gotoh_align(const uint8_t* __restrict__ a_codes,
                  const uint8_t* __restrict__ b_codes,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ byte_class,
                  const int* __restrict__ class_score, int B, int T, int go,
                  int ge, int neg, uint8_t* __restrict__ rows,
                  int* __restrict__ out_len, uint8_t* __restrict__ dirs_out) {
  extern __shared__ __align__(16) uint8_t s_pairs[];
  __shared__ uint8_t s_class[256];
  __shared__ int s_score[CLASSES * CLASSES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p = (long long)blockIdx.x * WARPS + warp;
  const bool live = p < B;  // whole warps only
  const int n = live ? lens[p] : 0, m = live ? lens[(long long)B + p] : 0;
  PairMem w;
  w.a = s_pairs + (size_t)warp * (SEQ_BYTES + T * DIR_ROW);
  w.b = w.a + TMAX;
  w.a_cls = w.b + TMAX;
  w.rev_a = w.a_cls + TMAX;
  w.rev_b = w.rev_a + 2 * TMAX;
  w.dirs = w.rev_b + 2 * TMAX;
  // the tables and the pair's bytes come in side by side
  for (int x = tid; x < 256; x += blockDim.x) s_class[x] = byte_class[x];
  if (tid < CLASSES * CLASSES) s_score[tid] = class_score[tid];
  for (int x = lane; x < n; x += 32) w.a[x] = a_codes[p * T + x];
  for (int x = lane; x < m; x += 32) w.b[x] = b_codes[p * T + x];
  __syncthreads();
  if (!live) return;  // after the block's last barrier
  for (int x = lane; x < n; x += 32) w.a_cls[x] = s_class[w.a[x]];
  __syncwarp();
  uint8_t* dirs_p = WRITE_DIRS ? dirs_out + (size_t)p * T * T : nullptr;
  uint8_t* rows_p = rows + (size_t)p * 4 * T;
  if (m <= 32)
    align_pair<1, WRITE_DIRS>(w, s_class, s_score, T, n, m, lane, go, ge, neg,
                              dirs_p, rows_p, out_len + p);
  else if (m <= 64)
    align_pair<2, WRITE_DIRS>(w, s_class, s_score, T, n, m, lane, go, ge, neg,
                              dirs_p, rows_p, out_len + p);
  else
    align_pair<4, WRITE_DIRS>(w, s_class, s_score, T, n, m, lane, go, ge, neg,
                              dirs_p, rows_p, out_len + p);
}

template <bool WRITE_DIRS>
int launch(const uint8_t* a_codes, const uint8_t* b_codes, const int* lens,
           const uint8_t* byte_class, const int* class_score, int B, int T,
           int go, int ge, int neg, uint8_t* rows, int* out_len,
           uint8_t* dirs_out, cudaStream_t stream) {
  const size_t shared = (size_t)WARPS * (T * DIR_ROW + SEQ_BYTES);
  // once: as much of the SM's memory as shared memory as a block may ask
  // for, so that six blocks are resident at T = 128
  static bool carved = false;
  if (!carved) {
    const cudaError_t err = cudaFuncSetAttribute(
        k_gotoh_align<WRITE_DIRS>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carved = true;
  }
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  k_gotoh_align<WRITE_DIRS><<<blocks, WARPS * 32, shared, stream>>>(
      a_codes, b_codes, lens, byte_class, class_score, B, T, go, ge, neg, rows,
      out_len, dirs_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_codes, b_codes: uint8 [B, T], the bytes of each pair (nothing is read
// past a pair's lengths); lens: int32 [2, B], n = len(a) then m = len(b),
// each in 1..T (the caller checks); byte_class: uint8 [256], the class of
// each byte value; class_score: int32 [5 * 5], the score of two classes.
// rows: uint8 [B, 2, 2T], the aligned rows of a and b ('-' for a gap),
// written up to out_len[p] <= n + m; out_len: int32 [B].  dirs_out: null,
// or uint8 [B, T, T]: bits 0-1 cs, bit 2 xo, bit 3 yn of every cell of
// rows 1..n and columns 1..m.  Launches on `stream` without synchronising;
// returns the first CUDA error, 0 for none.
int gotoh_align_launch(const uint8_t* a_codes, const uint8_t* b_codes,
                       const int* lens, const uint8_t* byte_class,
                       const int* class_score, int B, int T, int go, int ge,
                       int neg, uint8_t* rows, int* out_len,
                       uint8_t* dirs_out, void* stream) {
  if (B <= 0 || T < 1 || T > TMAX) return (int)cudaErrorInvalidValue;
  return dirs_out
             ? launch<true>(a_codes, b_codes, lens, byte_class, class_score,
                            B, T, go, ge, neg, rows, out_len, dirs_out,
                            (cudaStream_t)stream)
             : launch<false>(a_codes, b_codes, lens, byte_class, class_score,
                             B, T, go, ge, neg, rows, out_len, dirs_out,
                             (cudaStream_t)stream);
}

}  // extern "C"
