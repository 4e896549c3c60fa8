// Flash attention for training, forward and backward, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel     -> tc_fwd_kernel (bf16), fwd_kernel (fp32): out and
//                      the fp32 logsumexp
//   _bwd_dq_kernel  -> tc_dq_kernel, dq_kernel: dQ, looping over key tiles
//   _bwd_dkv_kernel -> tc_dkv_kernel, dkv_kernel: dK and dV, looping over
//                      query tiles
// and computes the same function over q/k/v in the model layout
// [B, T, H, D] (kv heads already repeated): out = softmax(q k^T * scale +
// mask) v with fp32 softmax. The forward also has the TPU kernel's masked,
// GQA-native mode (flash_attention_fwd_masked): k/v keep their Hkv heads
// (query head h reads kv head h / (H / Hkv)) and a key mask [B, Tk] int32
// (1 = real token) hides padded keys; it is forward-only. Causality is
// bottom-right aligned: row i sees column j iff i + (Tk - Tq) >= j; a
// window also needs i + (Tk - Tq) - j < window. lse = m + log(l) is
// [B, H, Tq] fp32. The backward recomputes P = exp(S - lse): dV = P^T dO,
// dP = dO V^T, dS = P (dP - delta) with delta = rowsum(dO * O) (a torch
// reduction in the wrapper), dQ = scale dS K, dK = scale dS^T Q. A row
// that sees no key gets zeros and lse = -inf (the port's convention; see
// ROADMAP.md Queue 3 for how the TPU kernel differs there).
//
// Bound: operations. At the training shape (T 1024, D 64, causal) a
// 64 x 64 tile of scores costs 4 * 64 * 64 * D FLOP for 2 * 64 * D * 2
// bytes of K and V, far above the card's ridge (~295 FLOP a byte in bf16),
// so the floor is FLOPs over the bf16 tensor-core peak.
//
// bf16 inputs (the training step, the generate and serving prefills, the
// long-context yardstick) run on the tensor cores: tc_fwd_kernel,
// tc_dq_kernel and tc_dkv_kernel.
// - Products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with their
//   operands brought from shared memory by ldmatrix (.trans where the
//   product reads a tile along its rows: V in P.V, K in dS.K, dO and Q in
//   the dK/dV products). Each warp owns 16 rows of the output.
// - Forward: the warp's Q rows stay in registers as A fragments for the
//   whole key loop. S = Q.K^T lands in accumulator fragments; the running
//   max and sum live beside them (a row is spread over the 4 lanes of a
//   quad: two shuffles reduce it), in log2 units (exp2 with the scale
//   folded). P is rounded to bf16 in registers and is the A operand of
//   P.V directly: the C layout of one m16n8 product pair is the A layout
//   of the next k-step, so nothing goes through shared memory.
// - dQ: one block per query tile holds Q and dO in shared memory and
//   walks the key tiles: S and dP = dO.V^T as above, dS = P (dP - delta)
//   with P = exp(S scale - lse) recomputed, dQ += bf16(dS).K.
// - dK/dV: one block per key tile holds K and V and walks the query
//   tiles in the transposed form: S^T = K.Q^T, P^T, dV += bf16(P^T).dO,
//   dP^T = V.dO^T, dS^T = P^T (dP^T - delta), dK += bf16(dS^T).Q. The two
//   kernels split the backward as the TPU kernels do: no atomics, the
//   result does not depend on scheduling.
// - Tiles are bf16 in shared memory. At D 64, 128 and 256 a row holds D
//   elements whose 16-byte chunk c sits at c ^ (row & 7), so the 8 rows
//   an ldmatrix phase reads fall on distinct banks; D 80 and 96 (10 and
//   12 chunks, which that XOR would carry past the row's end) pad each
//   row to D + 8 elements instead: 11 or 13 chunks a row, an odd count,
//   put 8 consecutive rows on 8 distinct bank groups with no swizzle
//   (tc_common.cuh tile_ld, swz). They arrive through a 2-stage ring of
//   16-byte cp.async copies (zero-filled past the sequence end): the next
//   tile is in flight while this one is multiplied.
// - These building blocks (cp.async, ldmatrix, mma, the swizzle, the
//   C -> A fragment conversion) live in tc_common.cuh, shared with the
//   block-sparse kernels.
// - Tile sizes: forward 128 query rows (8 warps) at D 64 and 64 (4 warps)
//   at D 80-256, key tiles of 64; dQ 64 query rows, key tiles of 64 (32 at
//   D 256); dK/dV 64 keys, query tiles of 64 (D 64) or 32 (D 80-256,
//   where the dK and dV accumulators take 80-128 registers a thread).
// - D 256: a warp's 16 x 256 fp32 output accumulator takes 128 registers
//   a lane, so the forward reads each k-step's Q fragment from shared
//   memory instead of keeping the warp's Q rows (64 registers) for the
//   walk; dQ walks key tiles of 32, so S and dP take 32 registers, not 64;
//   and dK/dV, whose two accumulators would take 256 registers, runs the
//   walk twice in one C call: dV (S^T, P^T, dV += P^T dO), then dK (S^T,
//   dP^T, dS^T, dK += dS^T Q). The second pass recomputes S^T, so D 256
//   does 5/4 of the dK/dV work; nothing is shared between blocks, so the
//   result still does not depend on scheduling.
// - Occupancy: the D 64 forward is bounded to 128 registers so two 8-warp
//   blocks share an SM (faster on the H100 than one block with more
//   registers); the other kernels take what they need without spilling
//   (two or three 4-warp blocks an SM; tighter bounds ran slower).
//   `nvcc -Xptxas -v` gives the figures; PERF.md records them.
// - Masking is per element only on tiles that need it (the causal
//   diagonal, a window edge, a ragged tail, a key mask that is not all
//   ones); the loop bounds skip the invisible tiles, and in the masked
//   mode a key tile that the mask hides completely is skipped before its
//   load (one 64-bit word of mask bits per key tile, built by ballots).
// - Grid: x = batch x head, y = tile; the forward and dQ walk y from the
//   last query tile, so the longest causal rows start first.
// Rounding points: S, dP and every accumulator are fp32; P (forward and
// backward) and dS are rounded to bf16 before their products, as the TPU
// kernels' fp32 dots run through the bf16 MXU; the row sum l is taken
// from the unrounded P.
//
// fp32 inputs keep the first design (fwd_kernel, dq_kernel, dkv_kernel):
// exact fp32 FMA on CUDA cores, which the 1e-5 fp32 tolerance needs
// (neither TF32 nor bf16 tensor cores meet it). One block per (64-row
// tile, batch x head) loops over the visible tiles with the running max,
// sum and accumulators in registers; tiles live in shared memory as fp32
// rows of stride D + 1, so both the score pattern (16 threads on 16 key
// rows) and the accumulate pattern (16 threads on 16 consecutive columns)
// read without bank conflicts; each thread holds a 4 x 4 block of scores
// and a 4 x D/16 block of the accumulators. At D 256 a tile is 65.8 KB,
// so dQ keeps K and V in one tile (K for S, V for dP, K read again for
// dS.K) and dK/dV keeps Q and dO in one (Q for S^T, dO for dP^T and dV,
// Q again for dK): three tiles and the score tiles fit in 227 KB.
//
// Both kinds skip causal and window tiles by their loop bounds, so the
// work is the visible triangle (or band), and mask ragged tails by the
// true lengths: nothing is padded in device memory. Each kernel instance
// raises its shared-memory limit once (cudaFuncSetAttribute), not on
// every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int BT = 64;        // rows of a query or key tile
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 1 of 16 columns
constexpr int PS = BT + 1;    // padded stride of a 64-wide score tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward only
  const float* lse;    // [B, H, Tq]; backward only
  const float* delta;  // [B, H, Tq]; backward only
  void* out;           // forward: out; dq kernel: dq; dkv kernel: dk
  void* out2;          // dkv kernel: dv
  float* lse_out;      // forward only
  const int* kmask;    // forward only: [B, Tk] key mask, or null
  int* runs;           // [1] or null: one is added per launch that runs
  int B, H, Hkv, Tq, Tk, causal, window;  // window <= 0: none; Hkv: heads
                                          // of k and v (H unless masked)
  float sm_scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows [row0, row0 + 64) of head h, batch b of a [B, T, H, D] tensor ->
// fp32 shared rows of stride D + 1; rows at or past T read as zeros
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* src, int b,
                                          int h, int row0, int T, int H) {
  const E* s = static_cast<const E*>(src);
  for (int e = threadIdx.x; e < BT * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < T) x = to_float(s[((static_cast<size_t>(b) * T + row) * H + h) * D + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// s[i][j] = sum_d X[4 ty + i][d] * Y[tx + 16 j][d]
template <int D>
__device__ __forceinline__ void tile_scores(float s[4][4], const float* X,
                                            const float* Y, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = X[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = Y[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], y[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[4 ty + i][c] * Z[c][tx + 16 j] over the 64 c of a
// tile; P has stride PS, Z stride D + 1
template <int D>
__device__ __forceinline__ void tile_accumulate(float acc[4][D / 16],
                                                const float* P, const float* Z,
                                                int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(4 * ty + i) * PS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float z = Z[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], z, acc[i][j]);
    }
  }
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  const int off = p.Tk - p.Tq;
  return row < p.Tq && col < p.Tk && (!p.causal || row + off >= col) &&
         (p.window <= 0 || row + off - col < p.window);
}

// key tiles [*lo, *hi) that query rows [row0, row0 + 64) can see
__device__ __forceinline__ void key_tiles(const Params& p, int row0, int* lo,
                                          int* hi) {
  const int off = p.Tk - p.Tq;
  const int last = min(row0 + BT, p.Tq) - 1;
  const int col_hi = p.causal ? min(p.Tk, last + off + 1) : p.Tk;
  const int col_lo = p.window > 0 ? max(0, row0 + off - p.window + 1) : 0;
  *lo = col_lo / BT;
  *hi = col_hi > col_lo ? (col_hi + BT - 1) / BT : *lo;
}

// sum (or max) of v over the 16 lanes that share ty
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  count_run(p.runs);
  const int row0 = blockIdx.x * BT;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BT * (D + 1);
  float* vs = ks + BT * (D + 1);
  float* ps = vs + BT * (D + 1);
  int* km = reinterpret_cast<int*>(ps + BT * PS);  // this tile's key mask
  const int hk = h / (p.H / p.Hkv);

  int t_lo, t_hi;
  key_tiles(p, row0, &t_lo, &t_hi);
  load_tile<E, D>(qs, p.q, b, h, row0, p.Tq, p.H);

  float acc[4][D / 16];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * BT;
    __syncthreads();  // the last tile's P.V is done with ks, vs and ps
    load_tile<E, D>(ks, p.k, b, hk, c0, p.Tk, p.Hkv);
    load_tile<E, D>(vs, p.v, b, hk, c0, p.Tk, p.Hkv);
    if (tid < BT)
      km[tid] = p.kmask == nullptr ||
                (c0 + tid < p.Tk &&
                 p.kmask[static_cast<size_t>(b) * p.Tk + c0 + tid] > 0);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(p, row, c0 + tx + 16 * j) && km[tx + 16 * j]
                      ? s[i][j] * p.sm_scale
                      : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(4 * ty + i) * PS + tx + 16 * j] = pj;
        sum += pj;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accumulate<D>(acc, ps, vs, ty, tx);
  }

  E* out = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= p.Tq) continue;
    const float l = l_run[i];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    E* dst = out + ((static_cast<size_t>(b) * p.Tq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) store(dst + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0)
      p.lse_out[static_cast<size_t>(blockIdx.y) * p.Tq + row] =
          l == 0.f ? -INFINITY : m_run[i] + logf(l);
  }
}

// fp32 tiles of stride D + 1 (bytes)
template <int D>
__host__ __device__ constexpr int fp32_tile() {
  return BT * (D + 1) * 4;
}

// dq_kernel's plan fits four tiles up to D 128; at D 256 (65.8 KB a tile)
// K and V share one tile (ONE_KV): K for S, V for dP, K again for dS.K
template <int D>
__host__ __device__ constexpr bool dq_one_kv() {
  return 4 * fp32_tile<D>() + BT * PS * 4 > MAX_SMEM;
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  count_run(p.runs);
  constexpr bool ONE_KV = dq_one_kv<D>();
  const int row0 = blockIdx.x * BT;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * (D + 1);
  float* ks = dos + BT * (D + 1);
  float* vs = ONE_KV ? ks : ks + BT * (D + 1);
  float* dss = vs + BT * (D + 1);

  int t_lo, t_hi;
  key_tiles(p, row0, &t_lo, &t_hi);
  load_tile<E, D>(qs, p.q, b, h, row0, p.Tq, p.H);
  load_tile<E, D>(dos, p.dout, b, h, row0, p.Tq, p.H);
  float lse[4], delta[4];
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    const size_t at = static_cast<size_t>(blockIdx.y) * p.Tq + row;
    lse[i] = row < p.Tq ? p.lse[at] : 0.f;
    delta[i] = row < p.Tq ? p.delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * BT;
    __syncthreads();
    load_tile<E, D>(ks, p.k, b, h, c0, p.Tk, p.H);
    if constexpr (!ONE_KV) load_tile<E, D>(vs, p.v, b, h, c0, p.Tk, p.H);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_scores<D>(s, qs, ks, ty, tx);
    if constexpr (ONE_KV) {
      __syncthreads();
      load_tile<E, D>(vs, p.v, b, h, c0, p.Tk, p.H);
      __syncthreads();
    }
    tile_scores<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = visible(p, row, c0 + tx + 16 * j)
                              ? expf(s[i][j] * p.sm_scale - lse[i])
                              : 0.f;
        dss[(4 * ty + i) * PS + tx + 16 * j] = pij * (dp[i][j] - delta[i]);
      }
    }
    if constexpr (ONE_KV) {
      __syncthreads();  // every thread is done with V
      load_tile<E, D>(ks, p.k, b, h, c0, p.Tk, p.H);
    }
    __syncthreads();
    tile_accumulate<D>(acc, dss, ks, ty, tx);
  }

  E* dq = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= p.Tq) continue;
    E* dst = dq + ((static_cast<size_t>(b) * p.Tq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store(dst + tx + 16 * j, acc[i][j] * p.sm_scale);
  }
}

// dkv_kernel's plan fits four tiles up to D 128; at D 256 Q and dO share
// one tile (ONE_QDO): Q for S^T, dO for dP^T and dV, Q again for dK
template <int D>
__host__ __device__ constexpr bool dkv_one_qdo() {
  return 4 * fp32_tile<D>() + 2 * BT * PS * 4 + 2 * BT * 4 > MAX_SMEM;
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  count_run(p.runs);
  constexpr bool ONE_QDO = dkv_one_qdo<D>();
  const int c0 = blockIdx.x * BT;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * (D + 1);
  float* qs = vs + BT * (D + 1);
  float* dos = ONE_QDO ? qs : qs + BT * (D + 1);
  float* pts = dos + BT * (D + 1);
  float* dss = pts + BT * PS;
  float* lse_s = dss + BT * PS;
  float* delta_s = lse_s + BT;

  // query tiles whose rows see some column of [c0, c0 + 64)
  const int off = p.Tk - p.Tq;
  const int last_col = min(c0 + BT, p.Tk) - 1;
  const int row_lo = p.causal ? max(0, c0 - off) : 0;
  const int row_hi =
      p.window > 0 ? min(p.Tq, last_col - off + p.window) : p.Tq;
  const int t_lo = row_lo / BT;
  const int t_hi = row_hi > row_lo ? (row_hi + BT - 1) / BT : t_lo;

  load_tile<E, D>(ks, p.k, b, h, c0, p.Tk, p.H);
  load_tile<E, D>(vs, p.v, b, h, c0, p.Tk, p.H);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int r0 = t * BT;
    __syncthreads();
    load_tile<E, D>(qs, p.q, b, h, r0, p.Tq, p.H);
    if constexpr (!ONE_QDO) load_tile<E, D>(dos, p.dout, b, h, r0, p.Tq, p.H);
    if (tid < BT) {
      const int row = r0 + tid;
      const size_t at = static_cast<size_t>(blockIdx.y) * p.Tq + row;
      lse_s[tid] = row < p.Tq ? p.lse[at] : 0.f;
      delta_s[tid] = row < p.Tq ? p.delta[at] : 0.f;
    }
    __syncthreads();
    // transposed tiles: row index i is a key (c0 + 4 ty + i), column j a
    // query (r0 + tx + 16 j)
    float st[4][4], dpt[4][4];
    tile_scores<D>(st, ks, qs, ty, tx);
    if constexpr (ONE_QDO) {
      __syncthreads();
      load_tile<E, D>(dos, p.dout, b, h, r0, p.Tq, p.H);
      __syncthreads();
    }
    tile_scores<D>(dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float pij = visible(p, r0 + r, col)
                              ? expf(st[i][j] * p.sm_scale - lse_s[r])
                              : 0.f;
        pts[(4 * ty + i) * PS + r] = pij;
        dss[(4 * ty + i) * PS + r] = pij * (dpt[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(dv, pts, dos, ty, tx);
    if constexpr (ONE_QDO) {
      __syncthreads();  // every thread is done with dO
      load_tile<E, D>(qs, p.q, b, h, r0, p.Tq, p.H);
      __syncthreads();
    }
    tile_accumulate<D>(dk, dss, qs, ty, tx);
  }

  E* dkp = static_cast<E*>(p.out);
  E* dvp = static_cast<E*>(p.out2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = c0 + 4 * ty + i;
    if (col >= p.Tk) continue;
    const size_t at = ((static_cast<size_t>(b) * p.Tk + col) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      store(dkp + at + tx + 16 * j, dk[i][j] * p.sm_scale);
      store(dvp + at + tx + 16 * j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int TN = 64;               // keys of a key tile (forward, dQ)

// does a tile of rows [r0, r0 + nr) x columns [c0, c0 + nc) need the
// per-element mask (a causal diagonal, a window edge, a ragged end)?
__device__ __forceinline__ bool edge_tile(const Params& p, int r0, int nr,
                                          int c0, int nc) {
  const int off = p.Tk - p.Tq;
  return r0 + nr > p.Tq || c0 + nc > p.Tk ||
         (p.causal && c0 + nc - 1 > r0 + off) ||
         (p.window > 0 && r0 + nr - 1 + off - c0 >= p.window);
}

// D 64: at most 128 registers, so two 8-warp blocks share an SM. Up to
// D 128 the warp's Q rows stay in registers (QREG); at D 256 they would
// take 64 registers beside the 128 of the output accumulator, so each
// k-step's Q fragment is read from shared memory instead.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, D == 64 ? 2 : 1)
    tc_fwd_kernel(Params p) {
  count_run(p.runs);
  constexpr int NT = NW * 32, BM = NW * 16, KT = D / 16, NS = TN / 8,
                ND = D / 8, LD = tile_ld<D>();
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* ks = qs + BM * LD;      // [2][TN][LD]
  bf16_t* vs = ks + 2 * TN * LD;  // [2][TN][LD]
  // masked mode: bit j of live[t] = key t * TN + j is real
  uint64_t* live = reinterpret_cast<uint64_t*>(vs + 2 * TN * LD);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = p.Tk - p.Tq;

  const int last = min(row0 + BM, p.Tq) - 1;
  const int col_hi = p.causal ? min(p.Tk, last + off + 1) : p.Tk;
  const int col_lo = p.window > 0 ? max(0, row0 + off - p.window + 1) : 0;
  const int t_lo = col_lo / TN;
  const int t_hi = col_hi > col_lo ? (col_hi + TN - 1) / TN : t_lo;

  if (p.kmask != nullptr) {
    const int* m = p.kmask + static_cast<size_t>(b) * p.Tk;
    for (int t = t_lo + warp; t < t_hi; t += NW) {
      const int c = t * TN + lane;
      const unsigned lo = __ballot_sync(~0u, c < p.Tk && m[c] > 0);
      const unsigned hi = __ballot_sync(~0u, c + 32 < p.Tk && m[c + 32] > 0);
      if (lane == 0) live[t] = lo | (static_cast<uint64_t>(hi) << 32);
    }
    __syncthreads();
  }
  // the first key tile at or after t that the key mask does not hide
  auto next = [&](int t) {
    if (p.kmask != nullptr)
      while (t < t_hi && live[t] == 0) ++t;
    return t;
  };

  load_rows<D, BM, NT>(qs, p.q, b, h, row0, p.Tq, p.H);
  cp_commit();
  int t = next(t_lo);
  if (t < t_hi) {
    load_rows<D, TN, NT>(ks, p.k, b, hk, t * TN, p.Tk, p.Hkv);
    load_rows<D, TN, NT>(vs, p.v, b, hk, t * TN, p.Tk, p.Hkv);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  uint32_t qf[QREG ? KT : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldsm(qf[kk], a_addr<D>(qs, warp * 16, kk, lane));
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  while (t < t_hi) {
    const int tn = next(t + 1);
    if (tn < t_hi) {
      load_rows<D, TN, NT>(ks + (stage ^ 1) * TN * LD, p.k, b, hk, tn * TN,
                           p.Tk, p.Hkv);
      load_rows<D, TN, NT>(vs + (stage ^ 1) * TN * LD, p.v, b, hk, tn * TN,
                           p.Tk, p.Hkv);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* kt = ks + stage * TN * LD;
    const bf16_t* vt = vs + stage * TN * LD;
    const int c0 = t * TN;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm(qa, a_addr<D>(qs, warp * 16, kk, lane));
      }
#pragma unroll
      for (int nj = 0; nj < NS / 2; ++nj) {
        uint32_t kb[4];
        ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
        mma(s[2 * nj], qa, kb[0], kb[1]);
        mma(s[2 * nj + 1], qa, kb[2], kb[3]);
      }
    }

    const uint64_t bits = p.kmask != nullptr ? live[t] : ~0ull;
    const bool edge = bits != ~0ull || edge_tile(p, row0, BM, c0, TN);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int row = row0 + warp * 16 + (lane >> 2) + 8 * (e >> 1);
          const int col = j * 8 + 2 * (lane & 3) + (e & 1);
          if (!visible(p, row, c0 + col) || !((bits >> col) & 1))
            x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = ex2(m_run[i] - base[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }

#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t vb[4];
        ldsm_t(vb, bt_addr<D>(vt, kk * 16, dj, lane));
        mma(o[2 * dj], a, vb[0], vb[1]);
        mma(o[2 * dj + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
    t = tn;
    stage ^= 1;
  }
  cp_wait<0>();

  bf16_t* out = static_cast<bf16_t*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * i;
    if (row >= p.Tq) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    bf16_t* dst = out +
                  ((static_cast<size_t>(b) * p.Tq + row) * p.H + h) * D +
                  2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    if ((lane & 3) == 0)
      p.lse_out[static_cast<size_t>(bh) * p.Tq + row] =
          l == 0.f ? -INFINITY : m_run[i] * LN2 + logf(l);
  }
}

// KN keys a tile: 64, or 32 at D 256, where dQ's accumulator takes 128
// registers and the S and dP tiles of 64 keys would take 64 more
template <int D, int NW, int KN>
__global__ void __launch_bounds__(NW * 32) tc_dq_kernel(Params p) {
  count_run(p.runs);
  constexpr int NT = NW * 32, BM = NW * 16, KT = D / 16, NS = KN / 8,
                ND = D / 8, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* dos = qs + BM * LD;
  bf16_t* ks = dos + BM * LD;     // [2][KN][LD]
  bf16_t* vs = ks + 2 * KN * LD;  // [2][KN][LD]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = p.Tk - p.Tq;

  const int last = min(row0 + BM, p.Tq) - 1;
  const int col_hi = p.causal ? min(p.Tk, last + off + 1) : p.Tk;
  const int col_lo = p.window > 0 ? max(0, row0 + off - p.window + 1) : 0;
  const int t_lo = col_lo / KN;
  const int t_hi = col_hi > col_lo ? (col_hi + KN - 1) / KN : t_lo;

  load_rows<D, BM, NT>(qs, p.q, b, h, row0, p.Tq, p.H);
  load_rows<D, BM, NT>(dos, p.dout, b, h, row0, p.Tq, p.H);
  if (t_lo < t_hi) {
    load_rows<D, KN, NT>(ks, p.k, b, h, t_lo * KN, p.Tk, p.H);
    load_rows<D, KN, NT>(vs, p.v, b, h, t_lo * KN, p.Tk, p.H);
  }
  cp_commit();

  float lse2[2], dl[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * i;
    const size_t at = static_cast<size_t>(bh) * p.Tq + row;
    lse2[i] = row < p.Tq ? p.lse[at] * LOG2E : 0.f;
    dl[i] = row < p.Tq ? p.delta[at] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  for (int t = t_lo; t < t_hi; ++t) {
    if (t + 1 < t_hi) {
      load_rows<D, KN, NT>(ks + (stage ^ 1) * KN * LD, p.k, b, h,
                           (t + 1) * KN, p.Tk, p.H);
      load_rows<D, KN, NT>(vs + (stage ^ 1) * KN * LD, p.v, b, h,
                           (t + 1) * KN, p.Tk, p.H);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* kt = ks + stage * KN * LD;
    const bf16_t* vt = vs + stage * KN * LD;
    const int c0 = t * KN;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], da[4];
      ldsm(qa, a_addr<D>(qs, warp * 16, kk, lane));
      ldsm(da, a_addr<D>(dos, warp * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < NS / 2; ++nj) {
        uint32_t kb[4], vb[4];
        ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
        mma(s[2 * nj], qa, kb[0], kb[1]);
        mma(s[2 * nj + 1], qa, kb[2], kb[3]);
        ldsm(vb, b_addr<D>(vt, nj * 16, kk, lane));
        mma(dp[2 * nj], da, vb[0], vb[1]);
        mma(dp[2 * nj + 1], da, vb[2], vb[3]);
      }
    }

    const bool edge = edge_tile(p, row0, BM, c0, KN);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
        if (edge) {
          const int row = row0 + warp * 16 + (lane >> 2) + 8 * (e >> 1);
          const int col = c0 + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!visible(p, row, col)) pe = 0.f;
        }
        s[j][e] = pe * (dp[j][e] - dl[e >> 1]);  // dS
      }

#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t kb[4];
        ldsm_t(kb, bt_addr<D>(kt, kk * 16, dj, lane));
        mma(dq[2 * dj], a, kb[0], kb[1]);
        mma(dq[2 * dj + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();
    stage ^= 1;
  }
  cp_wait<0>();

  bf16_t* out = static_cast<bf16_t*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * i;
    if (row >= p.Tq) continue;
    bf16_t* dst = out +
                  ((static_cast<size_t>(b) * p.Tq + row) * p.H + h) * D +
                  2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) = __floats2bfloat162_rn(
          dq[d][2 * i] * p.sm_scale, dq[d][2 * i + 1] * p.sm_scale);
  }
}

// PART: BOTH computes dK and dV in one walk; at D 256 their accumulators
// would take 256 registers a lane, so the C call runs the walk twice,
// DV_ONLY (S^T, P^T, dV) then DK_ONLY (S^T, dP^T, dS^T, dK): each pass
// holds one 128-register accumulator, and neither needs atomics.
enum Part { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

template <int D, int NW, int BQ, int PART>
__global__ void __launch_bounds__(NW * 32) tc_dkv_kernel(Params p) {
  count_run(p.runs);
  constexpr int NT = NW * 32, BN = NW * 16, KT = D / 16, NQ = BQ / 8,
                ND = D / 8, LD = tile_ld<D>();
  constexpr bool WANT_DK = PART != DV_ONLY, WANT_DV = PART != DK_ONLY;
  static_assert(2 * BQ <= NT, "one thread per lse and delta value");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* vs = ks + BN * LD;
  bf16_t* qs = vs + BN * LD;       // [2][BQ][LD]
  bf16_t* dos = qs + 2 * BQ * LD;  // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ] lse
  float* dls = ls + 2 * BQ;                                 // [2][BQ] delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int c0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int off = p.Tk - p.Tq;

  // query tiles whose rows see some column of [c0, c0 + BN)
  const int last_col = min(c0 + BN, p.Tk) - 1;
  const int row_lo = p.causal ? max(0, c0 - off) : 0;
  const int row_hi =
      p.window > 0 ? min(p.Tq, last_col - off + p.window) : p.Tq;
  const int t_lo = row_lo / BQ;
  const int t_hi = row_hi > row_lo ? (row_hi + BQ - 1) / BQ : t_lo;

  auto load_q = [&](int t, int st) {
    const int r0 = t * BQ;
    load_rows<D, BQ, NT>(qs + st * BQ * LD, p.q, b, h, r0, p.Tq, p.H);
    load_rows<D, BQ, NT>(dos + st * BQ * LD, p.dout, b, h, r0, p.Tq, p.H);
    const int r = r0 + (tid % BQ);
    const size_t at = static_cast<size_t>(bh) * p.Tq + min(r, p.Tq - 1);
    if (tid < BQ)
      cp4(saddr(ls + st * BQ + tid), p.lse + at, r < p.Tq);
    else if (tid < 2 * BQ)
      cp4(saddr(dls + st * BQ + tid - BQ), p.delta + at, r < p.Tq);
  };

  load_rows<D, BN, NT>(ks, p.k, b, h, c0, p.Tk, p.H);
  load_rows<D, BN, NT>(vs, p.v, b, h, c0, p.Tk, p.H);
  if (t_lo < t_hi) load_q(t_lo, 0);
  cp_commit();

  float dk[WANT_DK ? ND : 1][4], dv[WANT_DV ? ND : 1][4];
#pragma unroll
  for (int d = 0; d < (WANT_DK ? ND : 1); ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = 0.f;
#pragma unroll
  for (int d = 0; d < (WANT_DV ? ND : 1); ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[d][e] = 0.f;
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  for (int t = t_lo; t < t_hi; ++t) {
    if (t + 1 < t_hi) load_q(t + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* qt = qs + stage * BQ * LD;
    const bf16_t* dot = dos + stage * BQ * LD;
    const float* lt = ls + stage * BQ;
    const float* dlt = dls + stage * BQ;
    const int r0 = t * BQ;

    // transposed tiles: row = a key (c0 + 16 warp + ...), column = a query
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, a_addr<D>(ks, warp * 16, kk, lane));
      if constexpr (WANT_DK) ldsm(va, a_addr<D>(vs, warp * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < NQ / 2; ++nj) {
        uint32_t qb[4], db[4];
        ldsm(qb, b_addr<D>(qt, nj * 16, kk, lane));
        mma(st[2 * nj], ka, qb[0], qb[1]);
        mma(st[2 * nj + 1], ka, qb[2], qb[3]);
        if constexpr (WANT_DK) {
          ldsm(db, b_addr<D>(dot, nj * 16, kk, lane));
          mma(dpt[2 * nj], va, db[0], db[1]);
          mma(dpt[2 * nj + 1], va, db[2], db[3]);
        }
      }
    }

    const bool edge = edge_tile(p, r0, BQ, c0, BN);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
        float pe = ex2(fmaf(st[j][e], sl2, -lt[qi] * LOG2E));
        if (edge) {
          const int col = c0 + warp * 16 + (lane >> 2) + 8 * (e >> 1);
          if (!visible(p, r0 + qi, col)) pe = 0.f;
        }
        st[j][e] = pe;                            // P^T
        dpt[j][e] = pe * (dpt[j][e] - dlt[qi]);  // dS^T
      }

#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      c_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t db[4], qb[4];
        if constexpr (WANT_DV) {
          ldsm_t(db, bt_addr<D>(dot, kk * 16, dj, lane));
          mma(dv[2 * dj], ap, db[0], db[1]);
          mma(dv[2 * dj + 1], ap, db[2], db[3]);
        }
        if constexpr (WANT_DK) {
          ldsm_t(qb, bt_addr<D>(qt, kk * 16, dj, lane));
          mma(dk[2 * dj], as, qb[0], qb[1]);
          mma(dk[2 * dj + 1], as, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
    stage ^= 1;
  }
  cp_wait<0>();

  bf16_t* dkp = static_cast<bf16_t*>(p.out);
  bf16_t* dvp = static_cast<bf16_t*>(p.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = c0 + warp * 16 + (lane >> 2) + 8 * i;
    if (col >= p.Tk) continue;
    const size_t at = ((static_cast<size_t>(b) * p.Tk + col) * p.H + h) * D +
                      2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if constexpr (WANT_DK)
        *reinterpret_cast<__nv_bfloat162*>(dkp + at + 8 * d) =
            __floats2bfloat162_rn(dk[d][2 * i] * p.sm_scale,
                                  dk[d][2 * i + 1] * p.sm_scale);
      if constexpr (WANT_DV)
        *reinterpret_cast<__nv_bfloat162*>(dvp + at + 8 * d) =
            __floats2bfloat162_rn(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <void (*K)(Params)>
int run(const Params& p, dim3 grid, int threads, int bytes, int limit,
        cudaStream_t stream) {
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<K>(limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  K<<<grid, threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the CUDA-core kernels, grid (64-row tile, batch x head)
template <int D>
int launch_fp32(Which which, const Params& p, cudaStream_t stream) {
  if (p.B * p.H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int tile = fp32_tile<D>();
  constexpr int score = BT * PS * 4;
  const int q_tiles = (p.Tq + BT - 1) / BT;
  const int k_tiles = (p.Tk + BT - 1) / BT;
  const int bh = p.B * p.H;
  if (which == FWD) {
    constexpr int bytes = 3 * tile + score + BT * 4;
    return run<fwd_kernel<float, D>>(p, dim3(q_tiles, bh), THREADS, bytes,
                                     bytes, stream);
  }
  if (which == DQ) {
    constexpr int bytes = (dq_one_kv<D>() ? 3 : 4) * tile + score;
    return run<dq_kernel<float, D>>(p, dim3(q_tiles, bh), THREADS, bytes,
                                    bytes, stream);
  }
  constexpr int bytes =
      (dkv_one_qdo<D>() ? 3 : 4) * tile + 2 * score + 2 * BT * 4;
  return run<dkv_kernel<float, D>>(p, dim3(k_tiles, bh), THREADS, bytes,
                                   bytes, stream);
}

// bf16: the tensor-core kernels, grid (batch x head, tile)
template <int D>
int launch_bf16(Which which, const Params& p, cudaStream_t stream) {
  constexpr int E = static_cast<int>(sizeof(bf16_t));
  constexpr int LD = tile_ld<D>();
  const int bh = p.B * p.H;
  if (which == FWD) {
    constexpr int NW = D == 64 ? 8 : 4;
    constexpr int BM = NW * 16;
    const int tiles = (p.Tq + BM - 1) / BM;
    const int live = p.kmask != nullptr ? (p.Tk + TN - 1) / TN * 8 : 0;
    const int bytes = (BM * LD + 4 * TN * LD) * E + live;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return run<tc_fwd_kernel<D, NW>>(p, dim3(bh, tiles), NW * 32, bytes,
                                     MAX_SMEM, stream);
  }
  if (which == DQ) {
    constexpr int NW = 4;
    constexpr int BM = NW * 16;
    constexpr int KN = D == 256 ? 32 : TN;
    const int tiles = (p.Tq + BM - 1) / BM;
    constexpr int bytes = (2 * BM * LD + 4 * KN * LD) * E;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return run<tc_dq_kernel<D, NW, KN>>(p, dim3(bh, tiles), NW * 32, bytes,
                                        bytes, stream);
  }
  constexpr int NW = 4;
  constexpr int BN = NW * 16;
  constexpr int BQ = D == 64 ? 64 : 32;
  const int tiles = (p.Tk + BN - 1) / BN;
  constexpr int bytes = (2 * BN * LD + 4 * BQ * LD) * E + 4 * BQ * 4;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D <= 128) {
    return run<tc_dkv_kernel<D, NW, BQ, BOTH>>(p, dim3(bh, tiles), NW * 32,
                                               bytes, bytes, stream);
  } else {
    // two passes; the device run count is the second's
    Params first = p;
    first.runs = nullptr;
    const int rc = run<tc_dkv_kernel<D, NW, BQ, DV_ONLY>>(
        first, dim3(bh, tiles), NW * 32, bytes, bytes, stream);
    if (rc != 0) return rc;
    return run<tc_dkv_kernel<D, NW, BQ, DK_ONLY>>(p, dim3(bh, tiles),
                                                  NW * 32, bytes, bytes,
                                                  stream);
  }
}

template <int D>
int launch(Which which, const Params& p, int bf16_in, cudaStream_t stream) {
  return bf16_in ? launch_bf16<D>(which, p, stream)
                 : launch_fp32<D>(which, p, stream);
}

int dispatch(Which which, const Params& p, int D, int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(which, p, bf16_in, s);
    case 80: return launch<80>(which, p, bf16_in, s);
    case 96: return launch<96>(which, p, bf16_in, s);
    case 128: return launch<128>(which, p, bf16_in, s);
    case 256: return launch<256>(which, p, bf16_in, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make(const void* q, const void* k, const void* v, int B, int H,
            int Tq, int Tk, int causal, int window, float sm_scale,
            void* runs) {
  Params p = {};
  p.runs = static_cast<int*>(runs);
  p.q = q;
  p.k = k;
  p.v = v;
  p.B = B;
  p.H = H;
  p.Hkv = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.window = window;
  p.sm_scale = sm_scale;
  return p;
}

}  // namespace

// C entries for ctypes. q/out/dout/dq: [B, Tq, H, D]; k/v/dk/dv:
// [B, Tk, H, D], all contiguous, bf16 (bf16 != 0) or fp32; lse/delta:
// [B, H, Tq] fp32; window <= 0: none; D is 64, 80, 96, 128 or 256; runs:
// int32 [1] or null, one added on the device per call that runs (a CUDA
// graph's replays included). Every output element is written. Each
// returns cudaGetLastError() after its launches (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int H, int Tq, int Tk, int D,
                                   int causal, int window, float sm_scale,
                                   int bf16, void* runs, void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale, runs);
  p.out = out;
  p.lse_out = lse;
  return dispatch(FWD, p, D, bf16, stream);
}

// The masked, GQA-native forward: k/v [B, Tk, Hkv, D] with H % Hkv == 0,
// key_mask int32 [B, Tk] (> 0 = real key). Forward only.
extern "C" int flash_attention_fwd_masked(const void* q, const void* k,
                                          const void* v, const void* key_mask,
                                          void* out, float* lse, int B, int H,
                                          int Hkv, int Tq, int Tk, int D,
                                          int causal, int window,
                                          float sm_scale, int bf16,
                                          void* runs, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale, runs);
  p.Hkv = Hkv;
  p.kmask = static_cast<const int*>(key_mask);
  p.out = out;
  p.lse_out = lse;
  return dispatch(FWD, p, D, bf16, stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int H, int Tq, int Tk,
                                      int D, int causal, int window,
                                      float sm_scale, int bf16, void* runs,
                                      void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale, runs);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dq;
  return dispatch(DQ, p, D, bf16, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Tq, int Tk, int D, int causal,
                                       int window, float sm_scale, int bf16,
                                       void* runs, void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale, runs);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return dispatch(DKV, p, D, bf16, stream);
}
