// Flash attention for training, forward and backward, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel     -> fwd_kernel  (out and the fp32 logsumexp)
//   _bwd_dq_kernel  -> dq_kernel   (dQ, looping over key tiles)
//   _bwd_dkv_kernel -> dkv_kernel  (dK and dV, looping over query tiles)
// and computes the same function over q/k/v in the model layout
// [B, T, H, D] (kv heads already repeated): out = softmax(q k^T * scale +
// mask) v with fp32 softmax. The forward also has the TPU kernel's masked,
// GQA-native mode (flash_attention_fwd_masked): k/v keep their Hkv heads
// (query head h reads kv head h / (H / Hkv)) and a key mask [B, Tk] int32
// (1 = real token) hides padded keys; it is forward-only. Causality is bottom-right aligned: row i sees
// column j iff i + (Tk - Tq) >= j; a window also needs
// i + (Tk - Tq) - j < window. lse = m + log(l) is [B, H, Tq] fp32. The
// backward recomputes P = exp(S - lse): dV = P^T dO, dP = dO V^T,
// dS = P (dP - delta) with delta = rowsum(dO * O) (a torch reduction in
// the wrapper), dQ = scale dS K, dK = scale dS^T Q. A row that sees no
// key gets zeros and lse = -inf (the port's convention; see ROADMAP.md
// Queue 3 for how the TPU kernel differs there).
//
// Bound: operations. At the training shapes (T 1024, D 64) a tile of
// 64 x 64 scores costs 2 * 64 * 64 * D FLOP per 64 * D * 2 bytes of K and
// V, far above the card's ridge, so the floor is FLOPs / peak.
//
// What the design does about it:
// - one block per (64-row tile, batch x head); the TPU grid's sequential
//   kv axis (or q axis, for dK/dV) with its VMEM scratch becomes a loop
//   inside the block with the running max, sum and accumulators in
//   registers, so blocks need no order and no atomics;
// - causal and window tiles are skipped by the loop bounds, so the work
//   is the visible triangle (or band) and not the square;
// - ragged tails (T not a multiple of 64) are masked by the true lengths
//   and loaded as zeros: nothing is padded in device memory;
// - tiles live in shared memory as fp32 rows of stride D + 1, so both the
//   score pattern (16 threads on 16 key rows) and the accumulate pattern
//   (16 threads on 16 consecutive columns) read without bank conflicts;
//   each thread holds a 4 x 4 block of scores and a 4 x D/16 block of the
//   accumulators.
// Math is fp32 FMA on CUDA cores (no mma/wgmma yet): correct first, and
// the gap to the bound is written down in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  int B, H, Hkv, Tq, Tk, causal, window;  // window <= 0: none; Hkv: heads
                                          // of k and v (H unless masked)
  float sm_scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
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
  float* vs = ks + BT * (D + 1);
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
    load_tile<E, D>(vs, p.v, b, h, c0, p.Tk, p.H);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_scores<D>(s, qs, ks, ty, tx);
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

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
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
  float* dos = qs + BT * (D + 1);
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
    load_tile<E, D>(dos, p.dout, b, h, r0, p.Tq, p.H);
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

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename E, int D>
int launch(Which which, const Params& p, cudaStream_t stream) {
  constexpr int tile = BT * (D + 1) * 4;
  constexpr int score = BT * PS * 4;
  void (*kernel)(Params);
  int bytes, tiles;
  if (which == FWD) {
    kernel = fwd_kernel<E, D>;
    bytes = 3 * tile + score + BT * 4;
    tiles = (p.Tq + BT - 1) / BT;
  } else if (which == DQ) {
    kernel = dq_kernel<E, D>;
    bytes = 4 * tile + score;
    tiles = (p.Tq + BT - 1) / BT;
  } else {
    kernel = dkv_kernel<E, D>;
    bytes = 4 * tile + 2 * score + 2 * BT * 4;
    tiles = (p.Tk + BT - 1) / BT;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, p.B * p.H);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Which which, const Params& p, int D, int bf16, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (p.B * p.H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return D == 64 ? launch<__nv_bfloat16, 64>(which, p, s)
                   : launch<__nv_bfloat16, 128>(which, p, s);
  return D == 64 ? launch<float, 64>(which, p, s)
                 : launch<float, 128>(which, p, s);
}

Params make(const void* q, const void* k, const void* v, int B, int H,
            int Tq, int Tk, int causal, int window, float sm_scale) {
  Params p = {};
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
// [B, H, Tq] fp32; window <= 0: none; D is 64 or 128. Every output
// element is written. Each returns cudaGetLastError() after its launch
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int H, int Tq, int Tk, int D,
                                   int causal, int window, float sm_scale,
                                   int bf16, void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale);
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
                                          void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale);
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
                                      float sm_scale, int bf16, void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale);
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
                                       void* stream) {
  Params p = make(q, k, v, B, H, Tq, Tk, causal, window, sm_scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return dispatch(DKV, p, D, bf16, stream);
}
