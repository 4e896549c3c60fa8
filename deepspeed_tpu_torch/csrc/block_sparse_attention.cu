// Block-sparse flash attention, forward and backward, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/block_sparse_attention.py.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   _fwd_kernel     (:55)  -> fwd_kernel  (out and the fp32 logsumexp)
//   _bwd_dq_kernel  (:103) -> dq_kernel   (dQ over the same active blocks)
//   _bwd_dkv_kernel (:143) -> dkv_kernel  (dK and dV over the transposed lists)
// and computes the same function over q/k/v in the model layout
// [B, T, H, D]: a layout [H, nb, nb] of block x block tiles says which key
// blocks each query block sees; out = softmax(q k^T * scale + mask) v with
// fp32 softmax, where the mask is the layout's blocks and, when causal,
// key <= query. The wrapper passes the active lists of the layout (cut to
// its lower triangle when causal): idx [H, nb, A] (ascending, padded) and
// cnt [H, nb] for the forward and dQ, the same of the transposed layout
// for dK/dV. lse = m + log(l) is [B, H, T] fp32. The backward recomputes
// P = exp(S - lse): dV = P^T dO, dP = dO V^T, dS = P (dP - delta) with
// delta = rowsum(dO * O) (a torch reduction in the wrapper), dQ = scale dS
// K, dK = scale dS^T Q. A row that sees no key gets zeros and lse = -inf.
//
// Bound. At the main shape (B 1, T 16384, H 32, D 128, bf16, block 128,
// causal BSLongformer window 7 + global block 0: 7.6% of the causal
// blocks) the forward reads q, k, v and writes out and lse once, 0.161 ms
// of bytes at 3.35 TB/s, against 0.154 ms of operations (4 D FLOP per
// visible pair) at the bf16 peak: bytes, by a hair. dQ (6 D FLOP a pair)
// and dK/dV (8 D) are bound by operations: 0.231 and 0.308 ms.
//
// What the design does about it:
// - one block per (64-row slice of a query block, batch x head) for the
//   forward and dQ, per (64-column slice of a key block, batch x head) for
//   dK/dV. The TPU grid pads every row to the largest degree A and visits
//   one active block per grid step; here a block loops over its own list
//   only (cnt entries, read from the device), so a row costs its own
//   degree, and the running max, sum and accumulators stay in registers;
// - the streamed tiles (K and V for the forward and dQ, Q, dO, lse and
//   delta for dK/dV) come through a 2-stage cp.async double buffer: the
//   next tile's copy is in flight while this one is computed; the resident
//   tile is loaded once;
// - tiles are kept in shared memory in their own type, each row padded by
//   16 bytes, and read as 16-byte vectors: 8 rows of a phase fall on
//   distinct banks. Each thread holds a 4 x 4 block of scores and a
//   4 x D/16 block of the accumulators;
// - causality costs nothing off the diagonal: tiles past the diagonal are
//   skipped and the per-element mask runs only on the diagonal tile.
// Math is fp32 FMA on CUDA cores (no mma/wgmma yet), as in the flash
// kernels: correct first. Rows of very unequal degree are not balanced
// (BigBird's global row walks all nb blocks alone); splitting long lists
// across blocks and merging through lse is later work. PERF.md has the
// times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows of a query or key tile
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 score columns
constexpr int PS = BT + 4;    // stride of a 64-wide fp32 score tile

// a tile of 64 rows of D elements of type E in shared memory
template <typename E, int D>
struct Tile {
  static constexpr int CH = 16 / static_cast<int>(sizeof(E));  // per 16 B
  static constexpr int LD = D + CH;            // row stride: 16 B of padding
  static constexpr int ELEMS = BT * LD;
  static constexpr int BYTES = ELEMS * static_cast<int>(sizeof(E));
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward only
  const float* lse;    // [B, H, T]; backward only
  const float* delta;  // [B, H, T]; backward only
  void* out;           // forward: out; dq kernel: dq; dkv kernel: dk
  void* out2;          // dkv kernel: dv
  float* lse_out;      // forward only
  const int* idx;      // [H, nb, A] active blocks of each row of the lists
  const int* cnt;      // [H, nb]
  int B, H, T, nb, A, block, causal;
  float sm_scale;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive elements at p (16-byte aligned, or 8 for 4 bf16) as floats
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  static_assert(N % 4 == 0, "fp32 rows are read 4 at a time");
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(p)[c];
    o[4 * c] = x.x;
    o[4 * c + 1] = x.y;
    o[4 * c + 2] = x.z;
    o[4 * c + 3] = x.w;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  static_assert(N % 4 == 0, "bf16 rows are read 4 or 8 at a time");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(h[m]);
        o[8 * c + 2 * m] = f.x;
        o[8 * c + 2 * m + 1] = f.y;
      }
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 f = __bfloat1622float2(h[m]);
      o[2 * m] = f.x;
      o[2 * m + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start copying rows [row0, row0 + 64) of head h, batch b of a [B, T, H, D]
// tensor into a shared tile (16-byte pieces; the wrapper aligns the base)
template <typename E, int D>
__device__ __forceinline__ void load_tile_async(E* dst, const void* src, int b,
                                                int h, int row0, int T,
                                                int H) {
  using L = Tile<E, D>;
  constexpr int PER_ROW = D / L::CH;
  const E* s = static_cast<const E*>(src);
  for (int c = threadIdx.x; c < BT * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int e = (c % PER_ROW) * L::CH;
    cp_async16(dst + r * L::LD + e,
               s + ((static_cast<size_t>(b) * T + row0 + r) * H + h) * D + e);
  }
}

// s[i][j] = sum_d X[4 ty + i][d] * Y[tx + 16 j][d] over two shared tiles
template <typename E, int D>
__device__ __forceinline__ void tile_scores(float s[4][4], const E* X,
                                            const E* Y, int ty, int tx) {
  using L = Tile<E, D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += L::CH) {
    float a[4][L::CH];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_vec<L::CH>(X + (4 * ty + i) * L::LD + d, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[L::CH];
      load_vec<L::CH>(Y + (tx + 16 * j) * L::LD + d, y);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(a[i][c], y[c], s[i][j]);
    }
  }
}

// acc[i][n] += sum_c P[4 ty + i][c] * Z[c][tx D/16 + n] over the 64 c of a
// tile; P is an fp32 score tile of stride PS, Z a shared tile
template <typename E, int D>
__device__ __forceinline__ void tile_accumulate(float acc[4][D / 16],
                                                const float* P, const E* Z,
                                                int ty, int tx) {
  using L = Tile<E, D>;
  constexpr int N = D / 16;
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float p[4], z[N];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(4 * ty + i) * PS + c];
    load_vec<N>(Z + c * L::LD + tx * N, z);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[i][n] = fmaf(p[i], z[n], acc[i][n]);
  }
}

// the first row of the walk's tile t: entry t / spb of the list, slice
// t % spb of that block
__device__ __forceinline__ int tile_row0(const Params& p, const int* list,
                                         int spb, int t) {
  return __ldg(list + t / spb) * p.block + (t % spb) * BT;
}

// the first tile at or after t of a walk of n that causality lets
// through: for the forward and dQ (transposed = false) key tiles at or
// before the own rows' tile, for dK/dV query tiles at or after it
__device__ __forceinline__ int next_tile(const Params& p, const int* list,
                                         int spb, int n, int t, int own0,
                                         bool transposed) {
  for (; t < n && p.causal; ++t) {
    const int o0 = tile_row0(p, list, spb, t);
    if (transposed ? o0 >= own0 : o0 <= own0) break;
  }
  return t;
}

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

// a saved lse as the exponent's offset: -inf (a row that saw no key)
// becomes +inf so that its probabilities are 0, not NaN
__device__ __forceinline__ float lse_offset(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  using L = Tile<E, D>;
  constexpr int N = D / 16;
  const int spb = p.block / BT;
  const int row0 = blockIdx.x * BT;
  const int qb = blockIdx.x / spb;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ __align__(16) unsigned char smem[];
  E* qs = reinterpret_cast<E*>(smem);
  E* ring = qs + L::ELEMS;  // stage s: K at ring + 2 s ELEMS, then V
  float* ps = reinterpret_cast<float*>(ring + 4 * L::ELEMS);

  const int* list = p.idx + (static_cast<size_t>(h) * p.nb + qb) * p.A;
  const int n = __ldg(p.cnt + h * p.nb + qb) * spb;
  int t = next_tile(p, list, spb, n, 0, row0, false);
  load_tile_async<E, D>(qs, p.q, b, h, row0, p.T, p.H);
  if (t < n) {
    const int c0 = tile_row0(p, list, spb, t);
    load_tile_async<E, D>(ring, p.k, b, h, c0, p.T, p.H);
    load_tile_async<E, D>(ring + L::ELEMS, p.v, b, h, c0, p.T, p.H);
  }
  cp_async_commit();

  float acc[4][N];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  int stage = 0;
  while (t < n) {
    const int c0 = tile_row0(p, list, spb, t);
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; the other stage and ps are free
    const int tn = next_tile(p, list, spb, n, t + 1, row0, false);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0(p, list, spb, tn);
      load_tile_async<E, D>(nxt, p.k, b, h, n0, p.T, p.H);
      load_tile_async<E, D>(nxt + L::ELEMS, p.v, b, h, n0, p.T, p.H);
    }
    cp_async_commit();
    const E* ks = ring + 2 * stage * L::ELEMS;
    const E* vs = ks + L::ELEMS;
    const bool diag = p.causal && c0 == row0;
    float s[4][4];
    tile_scores<E, D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = !diag || tx + 16 * j <= 4 * ty + i ? s[i][j] * p.sm_scale
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
      for (int j = 0; j < N; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accumulate<E, D>(acc, ps, vs, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  E* out = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    const float l = l_run[i];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    E* dst = out + ((static_cast<size_t>(b) * p.T + row) * p.H + h) * D +
             tx * N;
#pragma unroll
    for (int j = 0; j < N; ++j) store(dst + j, acc[i][j] * inv);
    if (tx == 0)
      p.lse_out[static_cast<size_t>(blockIdx.y) * p.T + row] =
          l == 0.f ? -INFINITY : m_run[i] + logf(l);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using L = Tile<E, D>;
  constexpr int N = D / 16;
  const int spb = p.block / BT;
  const int row0 = blockIdx.x * BT;
  const int qb = blockIdx.x / spb;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ __align__(16) unsigned char smem[];
  E* qs = reinterpret_cast<E*>(smem);
  E* dos = qs + L::ELEMS;
  E* ring = dos + L::ELEMS;  // stage s: K at ring + 2 s ELEMS, then V
  float* dss = reinterpret_cast<float*>(ring + 4 * L::ELEMS);

  const int* list = p.idx + (static_cast<size_t>(h) * p.nb + qb) * p.A;
  const int n = __ldg(p.cnt + h * p.nb + qb) * spb;
  int t = next_tile(p, list, spb, n, 0, row0, false);
  load_tile_async<E, D>(qs, p.q, b, h, row0, p.T, p.H);
  load_tile_async<E, D>(dos, p.dout, b, h, row0, p.T, p.H);
  if (t < n) {
    const int c0 = tile_row0(p, list, spb, t);
    load_tile_async<E, D>(ring, p.k, b, h, c0, p.T, p.H);
    load_tile_async<E, D>(ring + L::ELEMS, p.v, b, h, c0, p.T, p.H);
  }
  cp_async_commit();

  float lse[4], delta[4];
  float acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t at = static_cast<size_t>(blockIdx.y) * p.T + row0 + 4 * ty + i;
    lse[i] = lse_offset(p.lse[at]);
    delta[i] = p.delta[at];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  int stage = 0;
  while (t < n) {
    const int c0 = tile_row0(p, list, spb, t);
    cp_async_wait<0>();
    __syncthreads();
    const int tn = next_tile(p, list, spb, n, t + 1, row0, false);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0(p, list, spb, tn);
      load_tile_async<E, D>(nxt, p.k, b, h, n0, p.T, p.H);
      load_tile_async<E, D>(nxt + L::ELEMS, p.v, b, h, n0, p.T, p.H);
    }
    cp_async_commit();
    const E* ks = ring + 2 * stage * L::ELEMS;
    const E* vs = ks + L::ELEMS;
    const bool diag = p.causal && c0 == row0;
    float s[4][4], dp[4][4];
    tile_scores<E, D>(s, qs, ks, ty, tx);
    tile_scores<E, D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = !diag || tx + 16 * j <= 4 * ty + i
                              ? expf(s[i][j] * p.sm_scale - lse[i])
                              : 0.f;
        dss[(4 * ty + i) * PS + tx + 16 * j] = pij * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    tile_accumulate<E, D>(acc, dss, ks, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  E* dq = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    E* dst = dq + ((static_cast<size_t>(b) * p.T + row) * p.H + h) * D +
             tx * N;
#pragma unroll
    for (int j = 0; j < N; ++j) store(dst + j, acc[i][j] * p.sm_scale);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  using L = Tile<E, D>;
  constexpr int N = D / 16;
  const int spb = p.block / BT;
  const int c0 = blockIdx.x * BT;
  const int kb = blockIdx.x / spb;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = ks + L::ELEMS;
  E* ring = vs + L::ELEMS;  // stage s: Q at ring + 2 s ELEMS, then dO
  float* pt = reinterpret_cast<float*>(ring + 4 * L::ELEMS);  // P^T, dS^T
  float* rows = pt + BT * PS;  // stage s: lse at rows + 2 s BT, then delta

  // rows of the shared tile as 16 pieces of 16 bytes: lse, then delta
  auto load_rows = [&](float* dst, int r0) {
    const size_t at = static_cast<size_t>(blockIdx.y) * p.T + r0;
    if (tid < 16)
      cp_async16(dst + 4 * tid, p.lse + at + 4 * tid);
    else if (tid < 32)
      cp_async16(dst + BT + 4 * (tid - 16), p.delta + at + 4 * (tid - 16));
  };

  const int* list = p.idx + (static_cast<size_t>(h) * p.nb + kb) * p.A;
  const int n = __ldg(p.cnt + h * p.nb + kb) * spb;
  int t = next_tile(p, list, spb, n, 0, c0, true);
  load_tile_async<E, D>(ks, p.k, b, h, c0, p.T, p.H);
  load_tile_async<E, D>(vs, p.v, b, h, c0, p.T, p.H);
  if (t < n) {
    const int r0 = tile_row0(p, list, spb, t);
    load_tile_async<E, D>(ring, p.q, b, h, r0, p.T, p.H);
    load_tile_async<E, D>(ring + L::ELEMS, p.dout, b, h, r0, p.T, p.H);
    load_rows(rows, r0);
  }
  cp_async_commit();

  float dk[4][N], dv[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dk[i][j] = dv[i][j] = 0.f;

  int stage = 0;
  while (t < n) {
    const int r0 = tile_row0(p, list, spb, t);
    cp_async_wait<0>();
    __syncthreads();
    const int tn = next_tile(p, list, spb, n, t + 1, c0, true);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0(p, list, spb, tn);
      load_tile_async<E, D>(nxt, p.q, b, h, n0, p.T, p.H);
      load_tile_async<E, D>(nxt + L::ELEMS, p.dout, b, h, n0, p.T, p.H);
      load_rows(rows + 2 * BT * (stage ^ 1), n0);
    }
    cp_async_commit();
    const E* qs = ring + 2 * stage * L::ELEMS;
    const E* dos = qs + L::ELEMS;
    const float* lse_s = rows + 2 * BT * stage;
    const float* delta_s = lse_s + BT;
    const bool diag = p.causal && r0 == c0;
    // transposed tiles: row index i is a key (c0 + 4 ty + i), column j a
    // query (r0 + tx + 16 j)
    float st[4][4], dpt[4][4];
    tile_scores<E, D>(st, ks, qs, ty, tx);
    tile_scores<E, D>(dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        st[i][j] = !diag || 4 * ty + i <= r
                       ? expf(st[i][j] * p.sm_scale - lse_offset(lse_s[r]))
                       : 0.f;
        pt[(4 * ty + i) * PS + r] = st[i][j];
      }
    __syncthreads();
    tile_accumulate<E, D>(dv, pt, dos, ty, tx);
    __syncthreads();  // every read of P^T is done: dS^T takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        pt[(4 * ty + i) * PS + r] = st[i][j] * (dpt[i][j] - delta_s[r]);
      }
    __syncthreads();
    tile_accumulate<E, D>(dk, pt, qs, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  E* dkp = static_cast<E*>(p.out);
  E* dvp = static_cast<E*>(p.out2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t at =
        ((static_cast<size_t>(b) * p.T + c0 + 4 * ty + i) * p.H + h) * D +
        tx * N;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      store(dkp + at + j, dk[i][j] * p.sm_scale);
      store(dvp + at + j, dv[i][j]);
    }
  }
}

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename E, int D>
int launch(Which which, const Params& p, cudaStream_t stream) {
  constexpr int tile = Tile<E, D>::BYTES;
  constexpr int score = BT * PS * 4;
  void (*kernel)(Params);
  int bytes;
  if (which == FWD) {
    kernel = fwd_kernel<E, D>;
    bytes = 5 * tile + score;             // Q + 2 stages of K, V
  } else if (which == DQ) {
    kernel = dq_kernel<E, D>;
    bytes = 6 * tile + score;             // Q, dO + 2 stages of K, V
  } else {
    kernel = dkv_kernel<E, D>;
    bytes = 6 * tile + score + 4 * BT * 4;  // K, V + 2 stages of Q, dO, rows
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.T / BT, p.B * p.H);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Which which, Params& p, int D, int bf16, void* stream) {
  if ((D != 64 && D != 128) || p.block <= 0 || p.block % BT != 0 ||
      p.T % p.block != 0 || p.B * p.H > 65535 || p.A <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nb = p.T / p.block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return D == 64 ? launch<__nv_bfloat16, 64>(which, p, s)
                   : launch<__nv_bfloat16, 128>(which, p, s);
  return D == 64 ? launch<float, 64>(which, p, s)
                 : launch<float, 128>(which, p, s);
}

Params make(const void* q, const void* k, const void* v, const int* idx,
            const int* cnt, int B, int H, int T, int block, int A, int causal,
            float sm_scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.idx = idx;
  p.cnt = cnt;
  p.B = B;
  p.H = H;
  p.T = T;
  p.block = block;
  p.A = A;
  p.causal = causal;
  p.sm_scale = sm_scale;
  return p;
}

}  // namespace

// C entries for ctypes. q/k/v/out/dout/dq/dk/dv: [B, T, H, D], contiguous,
// 16-byte aligned, bf16 (bf16 != 0) or fp32; lse/delta: [B, H, T] fp32,
// 16-byte aligned; idx int32 [H, T / block, A] with cnt int32
// [H, T / block]: the active key blocks of each query block (forward, dQ)
// or the active query blocks of each key block (dK/dV), ascending; block a
// multiple of 64 dividing T; D is 64 or 128. Every output element is
// written. Each returns cudaGetLastError() after its launch (0 =
// launched).
extern "C" int block_sparse_attention_fwd(const void* q, const void* k,
                                          const void* v, const int* kv_idx,
                                          const int* kv_cnt, void* out,
                                          float* lse, int B, int H, int T,
                                          int D, int block, int A, int causal,
                                          float sm_scale, int bf16,
                                          void* stream) {
  Params p = make(q, k, v, kv_idx, kv_cnt, B, H, T, block, A, causal,
                  sm_scale);
  p.out = out;
  p.lse_out = lse;
  return dispatch(FWD, p, D, bf16, stream);
}

extern "C" int block_sparse_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* kv_idx,
    const int* kv_cnt, void* dq, int B, int H, int T, int D, int block, int A,
    int causal, float sm_scale, int bf16, void* stream) {
  Params p = make(q, k, v, kv_idx, kv_cnt, B, H, T, block, A, causal,
                  sm_scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dq;
  return dispatch(DQ, p, D, bf16, stream);
}

extern "C" int block_sparse_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* q_idx, const int* q_cnt,
    void* dk, void* dv, int B, int H, int T, int D, int block, int A,
    int causal, float sm_scale, int bf16, void* stream) {
  Params p = make(q, k, v, q_idx, q_cnt, B, H, T, block, A, causal,
                  sm_scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return dispatch(DKV, p, D, bf16, stream);
}
