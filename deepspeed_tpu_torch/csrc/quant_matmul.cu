// Quantized-weight matmuls, hand-written for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes
// from deepspeed_tpu_torch/ops/quant_matmul.py.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/pallas/quant_matmul.py::_kernel   (K5, grouped)
//   deepspeed_tpu/ops/pallas/int8_matmul.py::_kernel    (K8, per column)
// and computes y[M, N] = x[M, K] @ W[K, N] in x's type (bf16 or fp32):
// - K5 (mode int8 / int4): W = code * scale[k / g, n] in fp32, rounded
//   to x's type, as the TPU kernel casts its dequantized tile for the
//   MXU; codes are int8
//   [K, N] or uint8 [K/2, N] holding K-rows 2r (low nibble) and 2r + 1
//   (high nibble), sign-extended as ((b & 0xF) ^ 8) - 8;
// - K8 (mode int8_col): W = code, and the per-column scale [N] multiplies
//   the fp32 sum once at the end.
// Products are summed in fp32 and the result is written in x's type.
//
// Bound. A decode step's product (M = batch, 8) reads K*N code bytes for
// 2*M*K*N operations, about 2*M flops per byte: far below the card's
// ridge, so the floor is the codes' bytes over 3.35 TB/s. A prefill's
// (M = tokens, thousands) does 2*M operations per code byte: the floor is
// the operations.
//
// What the design does about it:
// - bf16 x runs on the tensor cores: the codes are dequantized (code *
//   scale in fp32, rounded to bf16) while they are staged in shared
//   memory, so the bf16 tile the tensor cores read is exactly the plain
//   version's weight; ldmatrix feeds mma.sync m16n8k16 (bf16 in, fp32
//   accumulate) over 128-column tiles and a K loop of 32 rows, and the
//   next tile's global loads are in flight in registers while the current
//   one multiplies. The scale is looked up per group as the K loop
//   crosses it (each thread's 8 or 16 columns), so groups and nibble
//   pairs need not align with the tile. M > 8 (prefill) uses 128 x 128
//   output tiles of 8 warps at 64 x 32 each. M <= 8 (decode) pads x to
//   16 rows, gives each warp 16 x 16 outputs, and splits K across blocks
//   so every SM streams codes; each block writes an fp32 partial and a
//   second pass sums the splits in order (deterministic), applies K8's
//   column scale and rounds to bf16.
// - fp32 x runs on CUDA cores with exact fp32 products, as the plain
//   version's fp32 matmul: M <= 8 as a GEMV (threads along N, 8 columns
//   each, eight warps on interleaved K rows with four 8-byte loads in
//   flight per thread, x staged in shared memory in chunks of 1024 K
//   rows, split K and the same finalize pass); M > 8 as 128 x 128 tiles
//   with a K loop of 16 rows and 8 x 8 outputs per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Mode { kInt8 = 0, kInt4 = 1, kInt8Col = 2 };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ int nibble(uint32_t byte, int hi) {
  const int v = hi ? (byte >> 4) & 0xF : byte & 0xF;
  return (v ^ 8) - 8;
}

// ---------------------------------------------------------------------------
// CUDA-core GEMV: M <= 8, fp32 x
// ---------------------------------------------------------------------------

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 8;                  // columns per thread
constexpr int GV_TILE = 32 * GV_COLS;       // columns per block
constexpr int GV_MAXM = 8;
constexpr int GV_KC = 1024;                 // K rows of x staged at once
constexpr int GV_UNROLL = 4;                // code rows in flight per thread
constexpr int GV_RED_M = 4;                 // rows of x per reduction pass
static_assert(GV_MAXM * GV_KC >= GV_WARPS * GV_RED_M * GV_TILE,
              "the staging buffer doubles as the cross-warp reduction");

// 8 consecutive code bytes of a row starting at column n0, as a uint2
// (bytes past N read as 0)
__device__ __forceinline__ uint2 load8(const uint8_t* row, int n0, int N,
                                       bool vec) {
  if (vec && n0 + GV_COLS <= N)
    return __ldg(reinterpret_cast<const uint2*>(row + n0));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < GV_COLS; ++c)
    if (n0 + c < N) w[c / 4] |= static_cast<uint32_t>(__ldg(row + n0 + c))
                                << (8 * (c % 4));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ uint32_t byte_of(uint2 v, int c) {
  return ((c < 4 ? v.x : v.y) >> (8 * (c % 4))) & 0xFF;
}

template <int MODE>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ work,
                int M, int K, int N, int G, int splits) {
  extern __shared__ __align__(16) float xs[];  // [GV_MAXM][GV_KC]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * GV_TILE + lane * GV_COLS;
  const int s = blockIdx.y;
  const int g = K / G;  // scale-group length (K for per-column)
  // this block's K range: a whole number of groups (G > 1) or of rows
  // (nibble pairs for int4)
  const int unit = G > 1 ? g : (MODE == kInt4 ? 2 : 1);
  const int units = K / unit;
  const int per = (units + splits - 1) / splits;
  const int kb = min(K, s * per * unit);
  const int ke = min(K, (s + 1) * per * unit);
  const bool vec = (N % GV_COLS) == 0;
  // code rows: byte rows of the packed int4 layout hold two K rows
  constexpr int KPR = MODE == kInt4 ? 2 : 1;

  float acc[GV_MAXM][GV_COLS];
#pragma unroll
  for (int m = 0; m < GV_MAXM; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] = 0.f;

  for (int kc = kb; kc < ke; kc += GV_KC) {
    const int len = min(GV_KC, ke - kc);
    __syncthreads();  // the previous chunk's rows are consumed
    for (int e = tid; e < M * len; e += GV_THREADS) {
      const int m = e / len;
      const int kk = e % len;
      xs[m * GV_KC + kk] = x[static_cast<size_t>(m) * K + kc + kk];
    }
    __syncthreads();
    for (int k = kc; k < kc + len;) {
      const int gi = k / g;
      const int gend = min(kc + len, (gi + 1) * g);
      float sc[GV_COLS];
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c)
        sc[c] = (MODE != kInt8Col && n0 + c < N)
                    ? __ldg(scale + static_cast<size_t>(gi) * N + n0 + c)
                    : 1.f;
      // code rows [k, gend) / KPR; warp w takes rows w, w + 8, ...,
      // GV_UNROLL of them loaded before any is used
      const int r_end = gend / KPR;
      for (int r0 = k / KPR + warp; r0 < r_end;
           r0 += GV_WARPS * GV_UNROLL) {
        uint2 raw[GV_UNROLL];
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int r = r0 + u * GV_WARPS;
          raw[u] = r < r_end ? load8(codes + static_cast<size_t>(r) * N, n0,
                                     N, vec)
                             : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int r = r0 + u * GV_WARPS;
          if (r >= r_end) break;
          const float* x0 = xs + (r * KPR - kc);
#pragma unroll
          for (int h = 0; h < KPR; ++h) {
            float w[GV_COLS];
#pragma unroll
            for (int c = 0; c < GV_COLS; ++c) {
              const uint32_t b = byte_of(raw[u], c);
              const int code = MODE == kInt4
                                   ? nibble(b, h)
                                   : static_cast<int>(static_cast<int8_t>(b));
              w[c] = MODE == kInt8Col ? static_cast<float>(code)
                                      : static_cast<float>(code) * sc[c];
            }
#pragma unroll
            for (int m = 0; m < GV_MAXM; ++m) {
              if (m < M) {
                const float xa = x0[m * GV_KC + h];
#pragma unroll
                for (int c = 0; c < GV_COLS; ++c) acc[m][c] += xa * w[c];
              }
            }
          }
        }
      }
      k = gend;
    }
  }

  // sum the warps' partials through shared memory (GV_RED_M rows of x at
  // a time), then one fp32 partial per (split, row, column)
  float* red = xs;  // [GV_WARPS][GV_RED_M][GV_TILE]
#pragma unroll
  for (int m0 = 0; m0 < GV_MAXM; m0 += GV_RED_M) {
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GV_RED_M; ++mm)
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c)
        red[(warp * GV_RED_M + mm) * GV_TILE + lane * GV_COLS + c] =
            acc[m0 + mm][c];
    __syncthreads();
    for (int e = tid; e < GV_RED_M * GV_TILE; e += GV_THREADS) {
      const int m = m0 + e / GV_TILE;
      const int col = e % GV_TILE;
      const int n = blockIdx.x * GV_TILE + col;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w)
        sum += red[(w * GV_RED_M + e / GV_TILE) * GV_TILE + col];
      if (m < M && n < N) work[(static_cast<size_t>(s) * M + m) * N + n] = sum;
    }
  }
}

// out[m, n] = sum over splits of work[s, m, n] (times scale[n] for K8),
// in x's type
template <typename XT, int MODE>
__global__ void finalize_kernel(const float* __restrict__ work,
                                const float* __restrict__ scale,
                                XT* __restrict__ out, int M, int N,
                                int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (e >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += work[s * total + e];
  if (MODE == kInt8Col) sum *= scale[e % N];
  store(out + e, sum);
}

// ---------------------------------------------------------------------------
// CUDA-core tiled path: M > 8, fp32 x
// ---------------------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TILE_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

template <int MODE>
__global__ void __launch_bounds__(TILE_THREADS)
    gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ out, int M,
                int K, int N, int G) {
  __shared__ __align__(16) float As[BK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN + 4];  // dequantized W tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int g = K / G;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / TILE_THREADS; ++i) {
      const int e = tid + i * TILE_THREADS;
      const int mm = e / BK;
      const int kk = e % BK;
      const int m = m0 + mm;
      const int k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / TILE_THREADS; ++i) {
      const int e = tid + i * TILE_THREADS;
      const int kk = e / BN;
      const int nn = e % BN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      float w = 0.f;
      if (k < K && n < N) {
        int code;
        if (MODE == kInt4) {
          const uint32_t b = codes[static_cast<size_t>(k >> 1) * N + n];
          code = nibble(b, k & 1);
        } else {
          code = static_cast<int8_t>(codes[static_cast<size_t>(k) * N + n]);
        }
        w = MODE == kInt8Col
                ? static_cast<float>(code)
                : static_cast<float>(code) *
                      __ldg(scale + static_cast<size_t>(k / g) * N + n);
      }
      Bs[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const float y = MODE == kInt8Col ? acc[i][j] * scale[n] : acc[i][j];
      out[static_cast<size_t>(m) * N + n] = y;
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core tiled path: M > 8, bf16 x
// ---------------------------------------------------------------------------

constexpr int TC_BN = 128;
constexpr int TC_BK = 32;
constexpr int TC_THREADS = 256;      // 8 warps
constexpr int TC_AS = TC_BK + 8;     // padded smem rows (bf16): ldmatrix
constexpr int TC_BS = TC_BN + 8;     // rows land on distinct banks

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Each thread stages, per K tile: two 8-wide chunks of x (A) and one
// chunk of codes (B): 16 int8 codes of one K row, or 8 bytes of packed
// int4 = 8 columns of two K rows. Loads go to registers first, so the
// next tile's loads are in flight while the current tile multiplies.
template <int MODE>
struct TcStage {
  uint4 a[2];  // BM = 128: two chunks; BM = 16: one (threads < 64)
  uint4 b;     // int8: 16 bytes; int4: 8 bytes in .x, .y
};

// BM = 128 (prefill): 2 x 4 warps of 64 x 32 outputs, bf16 out. BM = 16
// (decode, M <= 8 rows padded with zeros): 1 x 8 warps of 16 x 16, the K
// axis split over blockIdx.z, an fp32 partial [split, M, N] out (the
// finalize pass sums the splits).
template <int MODE, int BM>
__device__ __forceinline__ void tc_gemm(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ work,
                   int M, int K, int N, int G, int splits) {
  constexpr int MI = BM == 16 ? 1 : 4;             // m16 tiles per warp
  constexpr int WARPS_M = BM / (16 * MI);
  constexpr int WARPS_N = TC_THREADS / 32 / WARPS_M;
  constexpr int NI = TC_BN / (8 * WARPS_N);        // n8 tiles per warp
  constexpr bool PARTIAL = BM == 16;
  constexpr int A_CHUNKS = BM * TC_BK / 8;         // 8 x values each
  constexpr int A_PER = (A_CHUNKS + TC_THREADS - 1) / TC_THREADS;
  static_assert(NI % 2 == 0, "B fragments load in pairs of n8 tiles");
  __shared__ __align__(16) __nv_bfloat16 As[BM][TC_AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[TC_BK][TC_BS];
  constexpr bool INT4 = MODE == kInt4;
  constexpr int BCOLS = INT4 ? 8 : 16;   // code columns per thread
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N;  // rows wm * 16 * MI
  const int wn = warp % WARPS_N;  // cols wn * 8 * NI
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * TC_BN;
  // this block's K range: whole 32-row tiles (nibble pairs stay whole)
  const int units = (K + TC_BK - 1) / TC_BK;
  const int per = (units + splits - 1) / splits;
  const int kb = min(K, static_cast<int>(blockIdx.z) * per * TC_BK);
  const int ke = min(K, (static_cast<int>(blockIdx.z) + 1) * per * TC_BK);
  const int g = K / G;
  const bool a_vec = K % 8 == 0;
  const bool b_vec = N % BCOLS == 0;
  // the thread's code chunk: int8 row t / 8 of the tile, columns
  // (t % 8) * 16; int4 byte row t / 16 (K rows 2r, 2r + 1), columns
  // (t % 16) * 8
  const int b_row = INT4 ? tid / 16 : tid / 8;
  const int b_col = INT4 ? (tid % 16) * 8 : (tid % 8) * 16;
  const int bn = n0 + b_col;

  auto load = [&](int k0, TcStage<MODE>& st) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * TC_THREADS;
      const int m = m0 + c / 4;
      const int k = k0 + (c % 4) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < A_CHUNKS && m < M) {
        const __nv_bfloat16* src = x + static_cast<size_t>(m) * K + k;
        if (a_vec && k + 8 <= K) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint16_t h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            h[e] = k + e < K ? reinterpret_cast<const uint16_t*>(src)[e] : 0;
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = h[2 * e] | (static_cast<uint32_t>(h[2 * e + 1]) << 16);
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      st.a[i] = v;
    }
    const int kr = INT4 ? k0 / 2 + b_row : k0 + b_row;  // code row
    const int rows = INT4 ? (K + 1) / 2 : K;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (kr < rows) {
      const uint8_t* src = codes + static_cast<size_t>(kr) * N + bn;
      if (b_vec && bn + BCOLS <= N) {
        if (INT4) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(src));
          v.x = w.x;
          v.y = w.y;
        } else {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        }
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int c = 0; c < BCOLS; ++c)
          if (bn + c < N)
            w[c / 4] |= static_cast<uint32_t>(__ldg(src + c)) << (8 * (c % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    st.b = v;
  };

  float sc[BCOLS];
#pragma unroll
  for (int c = 0; c < BCOLS; ++c) sc[c] = 0.f;
  int sc_group = -1;
  auto store = [&](int k0, const TcStage<MODE>& st) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * TC_THREADS;
      if (c < A_CHUNKS)
        *reinterpret_cast<uint4*>(&As[c / 4][(c % 4) * 8]) = st.a[i];
    }
    const int k = k0 + (INT4 ? 2 * b_row : b_row);  // first K row
    if (MODE != kInt8Col && k < K && k / g != sc_group) {
      sc_group = k / g;
#pragma unroll
      for (int c = 0; c < BCOLS; ++c)
        sc[c] = bn + c < N
                    ? __ldg(scale + static_cast<size_t>(sc_group) * N + bn + c)
                    : 0.f;
    }
    const uint32_t words[4] = {st.b.x, st.b.y, st.b.z, st.b.w};
    if (INT4) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const uint32_t b0 = (words[c / 4] >> (8 * (c % 4))) & 0xFF;
        const uint32_t b1 = (words[c / 4] >> (8 * (c % 4 + 1))) & 0xFF;
        lo[c / 2] = pack_bf16(static_cast<float>(nibble(b0, 0)) * sc[c],
                              static_cast<float>(nibble(b1, 0)) * sc[c + 1]);
        hi[c / 2] = pack_bf16(static_cast<float>(nibble(b0, 1)) * sc[c],
                              static_cast<float>(nibble(b1, 1)) * sc[c + 1]);
      }
      *reinterpret_cast<uint4*>(&Bs[2 * b_row][b_col]) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&Bs[2 * b_row + 1][b_col]) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    } else {
      uint32_t w[8];
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        const float c0 = static_cast<float>(static_cast<int8_t>(
            (words[c / 4] >> (8 * (c % 4))) & 0xFF));
        const float c1 = static_cast<float>(static_cast<int8_t>(
            (words[c / 4] >> (8 * (c % 4 + 1))) & 0xFF));
        w[c / 2] = MODE == kInt8Col ? pack_bf16(c0, c1)
                                    : pack_bf16(c0 * sc[c], c1 * sc[c + 1]);
      }
      *reinterpret_cast<uint4*>(&Bs[b_row][b_col]) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(&Bs[b_row][b_col + 8]) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  TcStage<MODE> st;
  if (kb < ke) load(kb, st);
  for (int k0 = kb; k0 < ke; k0 += TC_BK) {
    store(k0, st);
    __syncthreads();
    if (k0 + TC_BK < ke) load(k0 + TC_BK, st);
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], &As[wm * 16 * MI + mi * 16 + lane % 16]
                               [ks + (lane / 16) * 8]);
      uint32_t bfr[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[ks + (lane & 15)]
                                [wn * 8 * NI + nj * 16 + (lane >> 4) * 8]);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 16 * MI + mi * 16 + lane / 4 + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * 8 * NI + ni * 8 + (lane % 4) * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          float y = acc[mi][ni][half * 2 + e];
          if (PARTIAL) {
            work[(static_cast<size_t>(blockIdx.z) * M + m) * N + n + e] = y;
          } else {
            if (MODE == kInt8Col) y *= scale[n + e];
            out[static_cast<size_t>(m) * N + n + e] = __float2bfloat16(y);
          }
        }
      }
    }
  }
}

// the prefill tile keeps two blocks per SM (at most 128 registers a
// thread); the decode tile is left to the compiler's choice, which
// measured faster on the H100 than any bound
template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, 2)
    tc_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      int G) {
  tc_gemm<MODE, 128>(x, codes, scale, out, nullptr, M, K, N, G, 1);
}

template <int MODE>
__global__ void __launch_bounds__(TC_THREADS)
    tc_decode_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ codes,
                     const float* __restrict__ scale, float* __restrict__ work,
                     int M, int K, int N, int G, int splits) {
  tc_gemm<MODE, 16>(x, codes, scale, nullptr, work, M, K, N, G, splits);
}

template <typename XT, int MODE>
int launch(const void* x, const void* codes, const void* scale, void* out,
           void* work, int M, int K, int N, int G, int splits,
           cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<XT, __nv_bfloat16>::value;
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scale);
  XT* op = static_cast<XT*>(out);
  float* wp = static_cast<float*>(work);
  if (M <= GV_MAXM) {
    if constexpr (BF16) {
      const dim3 grid((N + TC_BN - 1) / TC_BN, 1, splits);
      tc_decode_kernel<MODE><<<grid, TC_THREADS, 0, stream>>>(
          xp, cp, sp, wp, M, K, N, G, splits);
    } else {
      constexpr int bytes = GV_MAXM * GV_KC * 4;
      const cudaError_t err = cudaFuncSetAttribute(
          gemv_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((N + GV_TILE - 1) / GV_TILE, splits);
      gemv_kernel<MODE><<<grid, GV_THREADS, bytes, stream>>>(
          xp, cp, sp, wp, M, K, N, G, splits);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(M) * N;
    finalize_kernel<XT, MODE>
        <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
            wp, sp, op, M, N, splits);
  } else if constexpr (BF16) {
    const dim3 grid((N + TC_BN - 1) / TC_BN, (M + 127) / 128);
    tc_prefill_kernel<MODE><<<grid, TC_THREADS, 0, stream>>>(xp, cp, sp, op,
                                                             M, K, N, G);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<MODE><<<grid, TILE_THREADS, 0, stream>>>(xp, cp, sp, op, M,
                                                         K, N, G);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_mode(int mode, const void* x, const void* codes, const void* scale,
                void* out, void* work, int M, int K, int N, int G, int splits,
                cudaStream_t s) {
  switch (mode) {
    case kInt8:
      return launch<XT, kInt8>(x, codes, scale, out, work, M, K, N, G, splits,
                               s);
    case kInt4:
      return launch<XT, kInt4>(x, codes, scale, out, work, M, K, N, G, splits,
                               s);
    case kInt8Col:
      return launch<XT, kInt8Col>(x, codes, scale, out, work, M, K, N, 1,
                                  splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry for ctypes. x [M, K] (x_bf16: bf16, else fp32), codes int8
// [K, N] (modes 0 and 2) or uint8 [K/2, N] (mode 1), scale fp32 [G, N]
// (modes 0, 1) or [N] (mode 2), out [M, N] in x's type, work fp32
// [splits, M, N] (used when M <= 8). G divides K (into even groups for
// int4); x and the codes are 16-byte aligned. The caller validates shapes.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int quant_matmul(const void* x, const void* codes,
                            const void* scale, void* out, void* work, int M,
                            int K, int N, int G, int mode, int x_bf16,
                            int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G != 0 || splits <= 0 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kInt4 && (K % 2 != 0 || (K / G) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_mode<__nv_bfloat16>(mode, x, codes, scale, out, work,
                                             M, K, N, G, splits, s)
                : launch_mode<float>(mode, x, codes, scale, out, work, M, K,
                                     N, G, splits, s);
}
