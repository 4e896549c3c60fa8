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
// the operations at the bf16 tensor-core peak.
//
// Which kernel runs is chosen by shape before any launch (wgmma_route and
// gemv_tc_route, mirrored by ops/quant_matmul.py kernel_route):
// - bf16 x, M > 8, K % 8 == 0 and N % 16 == 0 (every Llama-3-8B
//   projection): wgmma_prefill_kernel. TMA needs 16-byte row strides, so
//   rows of x need K % 8 and code rows N % 16. The product is computed
//   transposed, y^T = W^T x^T, so that the dequantized weight is the A
//   operand of wgmma.mma_async m64n256k16 and stays in registers; x is
//   the B operand, K-major from shared memory. (Written to shared memory
//   as a B tile and read back by both warpgroups, the dequantized weight
//   cost as much again as the products: PERF.md.) A producer warpgroup
//   keeps a ring of 4 stages in flight with TMA (cp.async.bulk.tensor,
//   mbarrier completion): an x tile [256 rows, 64 K] bf16 and a code tile
//   [64 K, 128 N] int8 (packed int4: 32 byte rows), both 128B-swizzled.
//   Each of two consumer warpgroups owns 64 columns of W: a thread reads
//   its column pair's codes (16-bit loads, conflict-free through the
//   swizzle) and builds its A fragments as code * scale in fp32 rounded
//   to bf16: exactly the plain version's weight. Codes become floats
//   without a conversion instruction (the byte placed in the mantissa of
//   2^23, the offset subtracted). The scale is looked up per K row, since
//   groups (8, 44, K, ...) need not align with the tile; a tile whose
//   rows share one group (per-column scales, groups of whole tiles) takes
//   a path with no lookup or branch between its rows, and the next tile's
//   scale is fetched a tile ahead. Two fragment sets alternate, so tile
//   kt + 1 is dequantized while tile kt's products run. setmaxnreg moves
//   the producer's registers to the consumers (232 each: 128
//   accumulators, no spills). The epilogue maps the accumulators back to
//   y, applies K8's column scale, rounds to bf16 and masks the M and N
//   edges.
// - other bf16 prefills (M > 8): tc_prefill_kernel, the first design:
//   mma.sync m16n8k16 fed by ldmatrix over 128 x 128 output tiles of 8
//   warps at 64 x 32 each, a K loop of 32 rows whose next tile's global
//   loads are in flight in registers while the current one multiplies,
//   the dequantized tile staged in padded shared memory.
// - M <= 8 (decode), bf16 x, K % 8 == 0 and N % 16 == 0 (every Llama-3-8B
//   projection): gemv_tc_kernel, one launch (gemv_tc_route, mirrored by
//   kernel_route). Its bound is the code bytes over 3.35 TB/s. It is
//   y^T = W^T x^T again: the dequantized weight (bit for bit the plain
//   version's bf16 weight) is the A operand of mma.sync m16n8k16, built in
//   registers from the staged codes, and x^T the B operand, M <= 8 filling
//   its n8, so no product row is padding. A producer warp keeps 4 stages
//   in flight with TMA on mbarriers, each 16 KB of codes [128 K, 128 N]
//   plus x [8, 128 K] and, for grouped scales, each k16 step's scale row:
//   64 KB in flight a block. Eight consumer warps take one k16 step of
//   each stage (16-byte, conflict-free loads through the 128B swizzle) and
//   release it once the mma have read their registers. K is split over
//   the ranks of a thread-block cluster (at most 8, sized by the host from
//   the card's SM count: one block an SM for int8, two for int4, whose
//   dequantization costs twice as much a byte); the warps' and then the
//   ranks' fp32 sums are added in a fixed order in shared and distributed
//   shared memory, and K8's column scale and the bf16 rounding follow in
//   the same kernel: no finalize launch, no fp32 scratch, no atomics, and
//   nothing read or allocated on the host, so a CUDA graph replays it. Of
//   the first design's limits (one 4 KB tile in flight, half of every mma
//   padding, the dequantized tile round-tripping shared memory, a second
//   launch with a scratch per call, a split fixed for 132 SMs) none is
//   left. What holds the int8 case back now is the stream itself: with
//   its products turned off the up projection takes 95% of its time
//   (PERF.md).
// - other decodes (ragged bf16 rows, M <= 8): tc_decode_kernel, the first
//   design: the prefill tile code with x padded to 16 rows, each warp 16 x
//   16 outputs, K split across blocks; each block writes an fp32 partial
//   and finalize_kernel sums the splits in order (deterministic), applies
//   K8's column scale and rounds to bf16.
// - fp32 x, M <= 8: gemv_kernel on CUDA cores with exact fp32 products,
//   as the plain version's fp32 matmul: threads along N, 8 columns each,
//   eight warps on interleaved K rows with four 8-byte loads in flight per
//   thread, x staged in shared memory in chunks of 1024 K rows, split K
//   and the same finalize pass.
// - fp32 x, M > 8 (fp32_tc_kernel): the tensor cores at fp32 accuracy.
//   The codes are small integers, exact in TF32; x is split into two TF32
//   parts, x = hi + lo, and each product runs on both (mma.sync m16n8k8,
//   fp32 accumulation), so it keeps at least 21 bits of x (one TF32 pass
//   keeps 11, which the fp32 tolerance refuses). Each scale group's fp32
//   sum is multiplied by its scale (no per-element scale load); K8's
//   column scale multiplies the total. Blocks of 64 x 128 outputs, 8 warps
//   of 32 x 32, walk 64-row K chunks through a 3-stage cp.async ring; K is
//   split so that tiles x splits fill the SMs (two blocks each,
//   ops/quant_matmul.py fp32_splits), each split writing an fp32 partial
//   that finalize_kernel sums in split order (no atomics). It replaces
//   the first design, 128 x 128 fp32-FMA tiles with the whole K loop each
//   (24 blocks at M 300, N 1024), synchronous loads, byte-wise code reads
//   and a scale load per weight element. Bound: the products at the TF32
//   rate, twice (two passes), against the codes' and x's bytes. 64-row
//   chunks with x split in registers took 0.56x the time of 32-row chunks
//   with a split pass through shared memory (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

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
// fp32 prefill: M > 8, fp32 x, on the tensor cores with x split in two
// ---------------------------------------------------------------------------

constexpr int FT_BM = 64;        // rows of x a block
constexpr int FT_BN = 128;       // columns of W a block
constexpr int FT_BK = 64;        // K rows a stage
constexpr int FT_STAGES = 3;     // stages of the cp.async ring
constexpr int FT_THREADS = 256;  // 8 warps: 2 along M x 4 along N, 32 x 32
constexpr int FT_XROW = FT_BK + 8;  // floats of a staged x row (288
                                    // bytes: the fragments' 8-byte loads
                                    // are conflict-free)

template <int MODE>
struct FtLayout {
  // code rows of a stage (int4: byte rows, two K rows each)
  static constexpr int CROWS = MODE == kInt4 ? FT_BK / 2 : FT_BK;
  // bytes of a staged code row: the rows a k8 step's lanes read (int8:
  // 2t and 2t + 1, int4: t) fall on distinct banks
  static constexpr int CROW = MODE == kInt4 ? FT_BN + 32 : FT_BN + 16;
  static constexpr int X = FT_BM * FT_XROW * 4;
  static constexpr int STAGE = X + CROWS * CROW;
  static constexpr int BYTES = FT_STAGES * STAGE;
  static_assert(X % 16 == 0 && STAGE % 16 == 0, "16-byte alignment");
};

// x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from
// zero), on the integer pipe: half a TF32 ulp added to the magnitude bits,
// the 13 low mantissa bits cleared
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (11 significant bits each; x - hi is exact): the
// products keep at least 21 bits of x, where one TF32 pass keeps 11
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(__float_as_uint(x)));
  lo = __uint_as_float(rna_tf32(__float_as_uint(x - hi)));
}

// the signed byte in bits [8j, 8j + 8) of w as an fp32 integer (exact in
// TF32), without a conversion instruction: the biased byte placed in the
// mantissa of 2^23, the bias subtracted
__device__ __forceinline__ uint32_t code8_tf32(uint32_t w, int j) {
  const uint32_t m =
      __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650u | (j & 3));
  return __float_as_uint(__uint_as_float(m) - 8388736.f);  // 2^23 + 128
}

// the signed nibble (bits [4h, 4h + 4) of byte j of w) likewise
__device__ __forceinline__ uint32_t code4_tf32(uint32_t w, int j, int h) {
  const uint32_t n = ((w >> (8 * j + 4 * h)) & 0xFu) ^ 8u;
  return __float_as_uint(__uint_as_float(0x4B000000u | n) - 8388616.f);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 8 : 0));
}

// Stage K rows [k0, k0 + 64) of x's rows [m0, m0 + 64) and of W's columns
// [n0, n0 + 128) into `st`, zeros past M, K and N: 16-byte cp.async where
// the rows allow it (K % 4 for x, N % 16 for the codes), else 8-, 4-byte or
// (N odd) plain byte copies.
template <int MODE>
__device__ __forceinline__ void ft_stage(unsigned char* st,
                                         const float* __restrict__ x,
                                         const uint8_t* __restrict__ codes,
                                         int M, int K, int N, int m0, int n0,
                                         int k0) {
  using L = FtLayout<MODE>;
  const int tid = threadIdx.x;
  float* xs = reinterpret_cast<float*>(st);
  if (K % 4 == 0) {
    for (int c = tid; c < FT_BM * FT_BK / 4; c += FT_THREADS) {
      const int r = c / (FT_BK / 4);
      const int k = k0 + 4 * (c % (FT_BK / 4));
      const bool in = m0 + r < M && k < K;
      cp16(saddr(xs + r * FT_XROW + k - k0),
           in ? x + static_cast<size_t>(m0 + r) * K + k : x, in);
    }
  } else {
    for (int e = tid; e < FT_BM * FT_BK; e += FT_THREADS) {
      const int r = e / FT_BK;
      const int k = k0 + e % FT_BK;
      const bool in = m0 + r < M && k < K;
      cp4(saddr(xs + r * FT_XROW + k - k0),
          in ? x + static_cast<size_t>(m0 + r) * K + k : x, in);
    }
  }
  unsigned char* cs = st + L::X;
  const int kr0 = MODE == kInt4 ? k0 / 2 : k0;  // code rows
  const int KR = MODE == kInt4 ? K / 2 : K;
  const int vec = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 1;
  if (vec > 1) {
    const int per_row = FT_BN / vec;
    for (int c = tid; c < L::CROWS * per_row; c += FT_THREADS) {
      const int r = c / per_row;
      const int n = n0 + vec * (c % per_row);
      const bool in = kr0 + r < KR && n < N;
      const uint8_t* src =
          in ? codes + static_cast<size_t>(kr0 + r) * N + n : codes;
      const uint32_t dst = saddr(cs + r * L::CROW + n - n0);
      if (vec == 16)
        cp16(dst, src, in);
      else if (vec == 8)
        cp8(dst, src, in);
      else
        cp4(dst, src, in);
    }
  } else {
    for (int e = tid; e < L::CROWS * FT_BN; e += FT_THREADS) {
      const int r = e / FT_BN;
      const int n = n0 + e % FT_BN;
      cs[r * L::CROW + n - n0] =
          kr0 + r < KR && n < N ? codes[static_cast<size_t>(kr0 + r) * N + n]
                                : 0;
    }
  }
}

// One block: x rows [m0, m0 + 64) times W columns [n0, n0 + 128) over the
// 64-row K chunks of split s. Warp (wm, wn) holds rows
// wm * 32 + [0, 32) and columns wn * 32 + [0, 32) as 2 x 4 mma tiles
// m16n8k8. Two index maps make every operand load one conflict-free
// word: within a k8 step, logical K index t (t + 4) is physical row 2t
// (2t + 1), so a lane's A pair and (int4) its two nibbles sit together;
// n8 tile j's logical column c is physical column 4c + j, so a lane's four
// B codes are one 32-bit word and its accumulators cover 8 consecutive
// columns 8t .. 8t + 7. Each x fragment is split as it is loaded, x = hi
// + lo (a split pass through shared memory, with its second barrier a
// chunk, was slower). Products run on hi and on lo into a group
// accumulator; at a scale-group boundary it is multiplied by the group's
// scales (loaded when the group starts) and added to the total (K8: one
// group, unscaled, the column scale applied with the split sum).
template <int MODE>
__global__ void __launch_bounds__(FT_THREADS, 2)
    fp32_tc_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ work, int M, int K, int N, int G,
                   int splits) {
  using L = FtLayout<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int n0 = blockIdx.x * FT_BN;
  const int m0 = blockIdx.y * FT_BM;
  const int s = blockIdx.z;
  const int chunks = (K + FT_BK - 1) / FT_BK;
  const int per = (chunks + splits - 1) / splits;
  const int c0 = s * per;
  const int nck = min(chunks, c0 + per) - c0;
  const int g = K / G;                    // scale-group length
  const int ncol = n0 + wn * 32 + 8 * t;  // this lane's first column

  float acc[2][4][4], gacc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = gacc[mi][j][e] = 0.f;
  int cur = -1;   // the group gacc holds
  int gend = 0;   // the first K row past it
  float sc[8];    // its scales of the lane's columns

  // acc += gacc * sc; gacc = 0
  auto flush = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][j][e] += gacc[mi][j][e] * sc[(e & 1) * 4 + j];
          gacc[mi][j][e] = 0.f;
        }
  };
  // gacc now holds group grp: fetch its scales
  auto start = [&](int grp) {
    cur = grp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sc[i] = MODE == kInt8Col || ncol + i >= N
                  ? 1.f
                  : __ldg(scale + static_cast<size_t>(grp) * N + ncol + i);
  };

#pragma unroll
  for (int i = 0; i < FT_STAGES - 1; ++i) {
    if (i < nck)
      ft_stage<MODE>(smem + i * L::STAGE, x, codes, M, K, N, m0, n0,
                     (c0 + i) * FT_BK);
    cp_commit();
  }

  for (int i = 0; i < nck; ++i) {
    cp_wait<FT_STAGES - 2>();
    __syncthreads();  // chunk i landed; chunk i - 1 is multiplied
    const int nx = i + FT_STAGES - 1;
    if (nx < nck)
      ft_stage<MODE>(smem + (nx % FT_STAGES) * L::STAGE, x, codes, M, K, N,
                     m0, n0, (c0 + nx) * FT_BK);
    cp_commit();
    const unsigned char* st = smem + (i % FT_STAGES) * L::STAGE;
    const float* xs = reinterpret_cast<const float*>(st);
    const unsigned char* cs = st + L::X;
    const int k0 = (c0 + i) * FT_BK;
#pragma unroll
    for (int ks = 0; ks < FT_BK / 8; ++ks) {
      const int kb = k0 + ks * 8;
      if (kb >= K) break;
      // codes of rows kb + 2t (b0) and kb + 2t + 1 (b1), tile j in byte j
      uint32_t b0[4], b1[4];
      if constexpr (MODE == kInt4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            cs + (ks * 4 + t) * L::CROW + wn * 32 + 4 * gq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = code4_tf32(w, j, 0);
          b1[j] = code4_tf32(w, j, 1);
        }
      } else {
        const unsigned char* cr = cs + (ks * 8 + 2 * t) * L::CROW + wn * 32 +
                                  4 * gq;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cr);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cr + L::CROW);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = code8_tf32(w0, j);
          b1[j] = code8_tf32(w1, j);
        }
      }
      // x's hi and lo fragments of the warp's two m16 tiles
      uint32_t a[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* xr = xs + (wm * 32 + mi * 16 + gq) * FT_XROW + ks * 8 +
                          2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(xr);
        const float2 v1 = *reinterpret_cast<const float2*>(xr + 8 * FT_XROW);
        const float e[4] = {v0.x, v1.x, v0.y, v1.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float h, l;
          split_tf32(e[q], h, l);
          a[0][mi][q] = __float_as_uint(h);
          a[1][mi][q] = __float_as_uint(l);
        }
      }
      if (kb >= gend) {  // the step opens a group
        if (cur >= 0) flush();
        start(kb / g);
        gend = (cur + 1) * g;
      }
      if (kb + 7 < gend || gend >= K) {  // the whole step in group cur
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(gacc[mi][j], a[part][mi], b0[j], b1[j]);
      } else {
        // a group boundary inside the step (groups that are no multiple
        // of 8 rows): once per group, the other rows' codes zeroed
        const int gb = min(kb + 7, K - 1) / g;
        for (int gg = cur; gg <= gb; ++gg) {
          if (gg != cur) {
            flush();
            start(gg);
          }
          const bool in0 = (kb + 2 * t) / g == gg;
          const bool in1 = (kb + 2 * t + 1) / g == gg;
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_tf32(gacc[mi][j], a[part][mi], in0 ? b0[j] : 0u,
                         in1 ? b1[j] : 0u);
        }
        gend = (cur + 1) * g;
      }
    }
  }
  cp_wait<0>();
  if (cur >= 0) flush();

  // one split: the output (K8: times the column scale); else the split's
  // fp32 partial, which finalize_kernel sums in split order
  float* dst = splits == 1 ? out : work + static_cast<size_t>(s) * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mi][j][2 * h];
        v[4 + j] = acc[mi][j][2 * h + 1];
      }
      if (MODE == kInt8Col && splits == 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (ncol + i < N) v[i] *= __ldg(scale + ncol + i);
      float* row = dst + static_cast<size_t>(m) * N;
      if (N % 4 == 0 && ncol + 8 <= N) {
        *reinterpret_cast<float4*>(row + ncol) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(row + ncol + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (ncol + i < N) row[ncol + i] = v[i];
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
        lo[c / 2] = pack(static_cast<float>(nibble(b0, 0)) * sc[c],
                              static_cast<float>(nibble(b1, 0)) * sc[c + 1]);
        hi[c / 2] = pack(static_cast<float>(nibble(b0, 1)) * sc[c],
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
        w[c / 2] = MODE == kInt8Col ? pack(c0, c1)
                                    : pack(c0 * sc[c], c1 * sc[c + 1]);
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
        ldsm(af[mi], saddr(&As[wm * 16 * MI + mi * 16 + lane % 16]
                              [ks + (lane / 16) * 8]));
      uint32_t bfr[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldsm_t(r, saddr(&Bs[ks + (lane & 15)]
                           [wn * 8 * NI + nj * 16 + (lane >> 4) * 8]));
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
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

// ---------------------------------------------------------------------------
// wgmma + TMA path: M > 8, bf16 x, K % 8 == 0, N % 16 == 0
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;                      // 64 W columns a warpgroup
constexpr int WG_BM = 256;                      // rows of x
constexpr int WG_BK = 64;                       // 128-byte rows of x
constexpr int WG_STAGES = 4;                    // x and code tiles in flight
constexpr int WG_CONSUMERS = 256;               // warpgroups 0 and 1
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // + the producer warpgroup
constexpr int WG_X_BYTES = WG_BM * WG_BK * 2;   // x tile, 128B-swizzled
constexpr int WG_C_BYTES = WG_BK * WG_BN;       // code tile (int4: half used)
constexpr int WG_SMEM =
    1024 + WG_STAGES * (WG_X_BYTES + WG_C_BYTES) + 2 * WG_STAGES * 8;
static_assert(WG_SMEM <= MAX_SMEM, "shared memory of one block");

// byte i of w (an unsigned value u < 256) minus `offset`, as a float: u
// placed in the mantissa of 2^23, then 2^23 + offset subtracted (exact)
__device__ __forceinline__ float code_f(uint32_t w, int i, float offset) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) -
         (8388608.f + offset);
}

// TMA needs 16-byte global row strides: x rows of K bf16, code rows of N
// bytes (N % 16 also keeps each thread's column pair inside or outside N)
bool wgmma_route(int M, int K, int N) {
  return M > GV_MAXM && K % 8 == 0 && N % 16 == 0;
}

// One block per 128 W columns x 256 rows of x; the product is computed
// transposed, y^T = W^T x^T, so that the dequantized weight is wgmma's A
// operand and lives in registers: it is never written to shared memory
// (the store of a dequantized B tile, read back by both warpgroups, cost
// as much as the products themselves). Warpgroup 2 is the producer: it
// gives its registers up to the consumers (setmaxnreg), and one of its
// threads keeps WG_STAGES x tiles [256, 64] and code tiles [64 K, 128 N]
// (int4: 32 byte rows), both 128B-swizzled, in flight with TMA, each stage
// on a full / empty mbarrier pair. Consumer warpgroup w owns W columns
// 64 w .. 64 w + 63 of the tile, each thread a column pair n, n + 1 (the
// accumulator rows r and r + 8 of its fragment: columns are permuted
// freely, the epilogue maps them back). It dequantizes K tile kt + 1 into
// A fragments while tile kt's four m64n256k16 steps run (two fragment
// sets alternate), with x (K-major) as B from shared memory. The two
// warpgroups share only the stages: no barrier between them.
template <int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap cmap,
                         const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ out, int M, int K, int N,
                         int G) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  constexpr bool INT4 = MODE == kInt4;
  constexpr int CROWS = INT4 ? WG_BK / 2 : WG_BK;  // code rows per K tile
  constexpr uint32_t TX = WG_X_BYTES + CROWS * WG_BN;
  const uint32_t raw = saddr(wg_smem);
  const uint32_t x_s = (raw + 1023) & ~1023u;  // x stages
  const uint32_t c_s = x_s + WG_STAGES * WG_X_BYTES;  // code stages
  const uint32_t bars = c_s + WG_STAGES * WG_C_BYTES;  // full[S], empty[S]
  const unsigned char* c_ptr = wg_smem + (c_s - raw);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * WG_BN;
  const int m0 = blockIdx.y * WG_BM;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), WG_CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    hopper::setmaxnreg_dec<40>();
    if (tid == WG_CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        hopper::mbar_wait(empty(s), ((kt / WG_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), TX);
        hopper::tma_load_2d(x_s + s * WG_X_BYTES, &xmap, kt * WG_BK, m0,
                            full(s));
        hopper::tma_load_2d(c_s + s * WG_C_BYTES, &cmap, n0, kt * CROWS,
                            full(s));
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<232>();

  const int q = lane % 4;
  // the thread's column pair in the tile (rows lane / 4 and lane / 4 + 8
  // of its warp's 16 accumulator rows)
  const int nl = (warp / 4) * 64 + (warp % 4) * 16 + 2 * (lane / 4);
  const int n = n0 + nl;
  const bool col_in = n < N;
  const int g = K / G;
  // the scales of columns n and n + 1 for one group; the group of the next
  // tile's first row is fetched a tile ahead, and rows only grow
  float sc[2] = {0.f, 0.f}, pf[2] = {0.f, 0.f};
  int sc_end = 0;   // first K row past the group in sc
  int pf_end = -1;  // the same for pf (-1: nothing fetched)
  auto fetch = [&](int k, float (&dst)[2]) {
    const int grp = k / g;
    if (col_in) {
      dst[0] = __ldg(scale + static_cast<size_t>(grp) * N + n);
      dst[1] = __ldg(scale + static_cast<size_t>(grp) * N + n + 1);
    }
    return (grp + 1) * g;
  };
  // sc <- the scale of K row k, unless it already holds it (rows past K
  // hold zero codes, so any finite scale will do)
  auto scale_for = [&](int k) {
    if (MODE != kInt8Col && k < K && k >= sc_end) {
      if (k < pf_end) {
        sc[0] = pf[0];
        sc[1] = pf[1];
        sc_end = pf_end;
      } else {
        sc_end = fetch(k, sc);
      }
    }
  };
  // the code bytes (row r, columns nl and nl + 1) of a 128B-swizzled tile,
  // in the low 16 bits
  auto codes16 = [&](const unsigned char* ct, int r) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
        ct + r * WG_BN + (((nl >> 4) ^ (r & 7)) << 4) + (nl & 15)));
  };
  // two K rows of the column pair (a: K row k, b: K row k + 1; byte 0 is
  // column n, byte 1 column n + 1, values code + offset) -> the fragment
  // words of column n and of column n + 1
  // (PER_ROW: look the scale up for each K row)
  auto words = [&](auto per_row, uint32_t a, uint32_t b, float offset,
                   int k, uint32_t& wn, uint32_t& wn1) {
    constexpr bool PER_ROW = decltype(per_row)::value;
    if (PER_ROW) scale_for(k);
    const float a0 = code_f(a, 0, offset), a1 = code_f(a, 1, offset);
    const float s0 = sc[0], s1 = sc[1];
    if (PER_ROW && !INT4) scale_for(k + 1);
    const float b0 = code_f(b, 0, offset), b1 = code_f(b, 1, offset);
    if (MODE == kInt8Col) {
      // |code| <= 127 is exact in bf16: the floats' top halves
      wn = __byte_perm(__float_as_uint(a0), __float_as_uint(b0), 0x7632);
      wn1 = __byte_perm(__float_as_uint(a1), __float_as_uint(b1), 0x7632);
    } else {
      wn = pack(a0 * s0, b0 * sc[0]);
      wn1 = pack(a1 * s1, b1 * sc[1]);
    }
  };
  // K tile kt -> the A fragments of its four k16 steps
  auto dequant = [&](int kt, uint32_t (&fr)[4][4]) {
    const unsigned char* ct = c_ptr + (kt % WG_STAGES) * WG_C_BYTES;
    const int k0 = kt * WG_BK + 2 * q;  // the thread's first K row
    scale_for(k0);
    auto rows = [&](auto per_row) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // K rows 16 j + 2 q (+ 1), + 8 h
          const int k = k0 + 16 * j + 8 * h;
          if (INT4) {
            // byte row k / 2 holds K rows k (low nibbles) and k + 1 (high)
            const uint32_t w = codes16(ct, 8 * j + q + 4 * h);
            words(per_row, (w & 0x0F0Fu) ^ 0x0808u,
                  ((w >> 4) & 0x0F0Fu) ^ 0x0808u, 8.f, k, fr[j][2 * h],
                  fr[j][2 * h + 1]);
          } else {
            const int r = 16 * j + 2 * q + 8 * h;
            words(per_row, codes16(ct, r) ^ 0x8080u,
                  codes16(ct, r + 1) ^ 0x8080u, 128.f, k, fr[j][2 * h],
                  fr[j][2 * h + 1]);
          }
        }
      }
    };
    // one scale group for all of the thread's rows (per-column scales,
    // groups of whole tiles): no lookups, and no branch, between them
    if (MODE == kInt8Col || min(k0 + WG_BK - 7, K - 1) < sc_end)
      rows(std::false_type{});
    else
      rows(std::true_type{});
    if (MODE != kInt8Col && kt + 1 < nk) {
      const int k = k0 + WG_BK;
      if (k < K && k >= sc_end && k >= pf_end) pf_end = fetch(k, pf);
    }
  };
  // fragment words: [k-step][0] = column n, K rows k, k + 1; [1] = column
  // n + 1; [2], [3] the same for K rows k + 8, k + 9 (the A layout of rows
  // lane / 4 and lane / 4 + 8)

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t fa[4][4], fb[4][4];

  // tile kt's products from fragments cur; then tile kt + 1's fragments
  // into nxt, which tile kt - 1's products (now waited for) read
  auto step = [&](int kt, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
    const int s = kt % WG_STAGES;
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < WG_BK / 16; ++j)
      hopper::wgmma_m64n256k16_rs(
          acc, cur[j], hopper::sw128_desc(x_s + s * WG_X_BYTES + j * 32, 16,
                                          1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    hopper::fence_regs(nxt);  // kept intact until tile kt - 1 was done
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty((kt - 1) % WG_STAGES));
    }
    if (kt + 1 < nk) {
      hopper::mbar_wait(full((kt + 1) % WG_STAGES),
                        ((kt + 1) / WG_STAGES) & 1);
      dequant(kt + 1, nxt);
    }
  };
  hopper::mbar_wait(full(0), 0);
  dequant(0, fa);
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, fa, fb);
    if (kt + 1 < nk) step(kt + 1, fb, fa);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: accumulator row lane / 4 is column n, row lane / 4 + 8
  // column n + 1; columns 8 j + 2 q (+ 1) are rows m of x. K8's column
  // scale, bf16 rounding, stores masked at the M and N edges
  if (!col_in) return;
  const float s0 = MODE == kInt8Col ? scale[n] : 1.f;
  const float s1 = MODE == kInt8Col ? scale[n + 1] : 1.f;
#pragma unroll
  for (int j = 0; j < WG_BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * q + e;
      if (m < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n) =
            pack(acc[4 * j + e] * s0, acc[4 * j + 2 + e] * s1);
    }
  }
}

template <int MODE>
int launch_wgmma(const void* x, const void* codes, const float* scale,
                 __nv_bfloat16* out, int M, int K, int N, int G,
                 cudaStream_t stream) {
  constexpr int CROWS = MODE == kInt4 ? WG_BK / 2 : WG_BK;
  CUtensorMap xmap, cmap;
  if (!hopper::make_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                           K, K, WG_BM, WG_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                           MODE == kInt4 ? K / 2 : K, N, N, CROWS, WG_BN,
                           CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<wgmma_prefill_kernel<MODE>>(WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM);
  wgmma_prefill_kernel<MODE><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      xmap, cmap, scale, out, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// decode GEMV on the tensor cores: M <= 8, bf16 x, K % 8 == 0, N % 16 == 0
// ---------------------------------------------------------------------------

constexpr int GT_BN = 128;                  // W columns of a column tile
constexpr int GT_WARPS = 8;                 // consumers: one k16 step each
constexpr int GT_BK = 16 * GT_WARPS;        // K rows of a stage
constexpr int GT_STAGES = 4;                // stages in flight
constexpr int GT_THREADS = 32 * GT_WARPS + 32;  // + the producer warp
constexpr int GT_C_BYTES = GT_BK * GT_BN;   // a code stage (int4: half used)
constexpr int GT_X_BYTES = 8 * GT_BK * 2;   // x stage: two [8, 64] boxes
constexpr int GT_S_BYTES = GT_WARPS * GT_BN * 4;  // a scale row a warp
constexpr int GT_PART = 8 * GT_BN;          // a block's fp32 partial [8][128]
constexpr int GT_RED = GT_BN + 4;           // padded rows of the warp sums
constexpr int GT_MAX_CLUSTER = 8;
constexpr int GT_SMEM = 1024 +
                        GT_STAGES * (GT_C_BYTES + GT_X_BYTES + GT_S_BYTES) +
                        GT_PART * 4 + 2 * GT_STAGES * 8;
static_assert(GT_WARPS * 8 * GT_RED * 4 <= GT_STAGES * GT_C_BYTES,
              "the warps' partials reuse the code stages");

// TMA needs 16-byte global row strides (x rows K % 8, code rows N % 16);
// N % 16 also keeps a thread's 16 columns wholly inside or outside N
bool gemv_tc_route(int M, int K, int N) {
  return M <= GV_MAXM && K % 8 == 0 && N % 16 == 0;
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the fp32 at shared address `addr` of cluster rank `rank`
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// 16-byte chunk (16 W columns) of lane group g in a 128-column code tile.
// int8 lanes 0-7 read rows 2q (+ 16 w) at chunks g: rows 0, 2, 4, 6 swizzle
// chunks 0 and 1 onto eight banks groups. int4 lanes read byte rows q at
// chunks 0, 4 (then 1, 5, ...): rows 0-3 XOR 0 and 4 are distinct too.
template <int MODE>
__device__ __forceinline__ int gt_chunk(int g) {
  return MODE == kInt4 ? (g >> 1) | ((g & 1) << 2) : g;
}

// One k16 step of gemv_tc_kernel for lane (g, q): K rows k, k + 1, k + 8,
// k + 9 (k = the step's first row + 2 q) of the lane's 16 columns n ..
// n + 15 as codes (`rows`: int8 one 16-byte row each, int4 two byte rows
// of nibble pairs), dequantized into the A fragments of 8 mma (tile j:
// columns 2 j and 2 j + 1) and multiplied with x's B fragment (b0, b1).
// Scales: sc[16] for the whole step, or (PER_ROW) looked up per K row.
template <int MODE, bool PER_ROW>
__device__ __forceinline__ void gt_step(
    float (&acc)[8][4], const uint4 (&rows)[MODE == kInt4 ? 2 : 4],
    uint32_t b0, uint32_t b1, const float (&sc)[16],
    const float* __restrict__ scale, int k, int K, int N, int gl, int n,
    bool col_in) {
  constexpr bool INT4 = MODE == kInt4;
  constexpr float offset = INT4 ? 8.f : 128.f;
  auto row_scale = [&](int kk, int c) {
    const int grp = min(kk, K - 1) / gl;
    return col_in ? __ldg(scale + static_cast<size_t>(grp) * N + n + c)
                  : 0.f;
  };
  // lo[h] / hi[h]: K rows k + 8 h and k + 8 h + 1 of the 16 columns, one
  // byte (code + offset) a column
  uint32_t lo[2][4], hi[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (INT4) {
      const uint32_t w[4] = {rows[h].x, rows[h].y, rows[h].z, rows[h].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[h][c] = (w[c] & 0x0F0F0F0Fu) ^ 0x08080808u;
        hi[h][c] = ((w[c] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      }
    } else {
      const uint4 ra = rows[2 * h], rb = rows[2 * h + 1];
      const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
      const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[h][c] = wa[c] ^ 0x80808080u;
        hi[h][c] = wb[c] ^ 0x80808080u;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // mma's A fragment: (row g, K 2q, 2q + 1), (row g + 8, the same), then
    // K + 8
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // column 2 j + e of the chunk
        const int c = 2 * j + e;
        const float f0 = code_f(lo[h][j / 2], c % 4, offset);
        const float f1 = code_f(hi[h][j / 2], c % 4, offset);
        if (MODE == kInt8Col) {
          // |code| <= 127 is exact in bf16: the floats' top halves
          a[2 * h + e] = __byte_perm(__float_as_uint(f0),
                                     __float_as_uint(f1), 0x7632);
        } else if (PER_ROW) {
          a[2 * h + e] = pack(f0 * row_scale(k + 8 * h, c),
                              f1 * row_scale(k + 8 * h + 1, c));
        } else {
          a[2 * h + e] = pack(f0 * sc[c], f1 * sc[c]);
        }
      }
    }
    mma(acc[j], a, b0, b1);
  }
}

// y^T = W^T x^T for M <= 8: the dequantized weight is the A operand of
// mma.sync m16n8k16 (16 W columns x 16 K rows), built in registers from the
// staged codes, and x^T the B operand, M rows filling its n8 (rows past M
// are TMA's zero fill). Block = (column tile t, cluster rank r): 128 W
// columns over the rank's share of the K tiles. Warp 8 is the producer:
// one thread keeps GT_STAGES stages in flight with TMA, each a code tile
// [128 K, 128 N] (int4: [64 byte rows, 128 N]) and x [8, 128 K] as two
// [8, 64] boxes, all 128B-swizzled, and, for groups of 16 rows or more,
// the scale row of each warp's group; all on a full / empty mbarrier
// pair. Consumer warp w takes k16 step w of every stage: lane (g, q) reads
// the 16 codes of its column chunk in K rows 2q, 2q + 1, 2q + 8, 2q + 9 of
// the step (int8: four 16-byte loads; int4: byte rows q and q + 4, two),
// x by ldmatrix.x2, and runs 8 mma (gt_step); it releases the stage once
// the mma have read every loaded register. The warps' fp32 sums are added
// in warp order in shared memory, then the ranks' in rank order through
// distributed shared memory, each rank reducing a slice of the tile; K8's
// column scale and the bf16 rounding follow in the same kernel. No
// atomics: bitwise deterministic.
template <int MODE>
__global__ void __launch_bounds__(GT_THREADS, 2)
    gemv_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const __grid_constant__ CUtensorMap smap,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int K, int N,
                   int G, int C) {
  extern __shared__ __align__(1024) unsigned char gt_smem[];
  constexpr bool INT4 = MODE == kInt4;
  constexpr int CROWS = INT4 ? GT_BK / 2 : GT_BK;  // code rows a stage
  const uint32_t raw = saddr(gt_smem);
  const uint32_t c_s = (raw + 1023) & ~1023u;            // code stages
  const uint32_t x_s = c_s + GT_STAGES * GT_C_BYTES;      // x stages
  const uint32_t s_s = x_s + GT_STAGES * GT_X_BYTES;      // scale stages
  const uint32_t part_s = s_s + GT_STAGES * GT_S_BYTES;   // [8][128] fp32
  const uint32_t bars = part_s + GT_PART * 4;             // full, empty
  unsigned char* c_ptr = gt_smem + (c_s - raw);
  const unsigned char* s_ptr = gt_smem + (s_s - raw);
  float* part = reinterpret_cast<float*>(gt_smem + (part_s - raw));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GT_STAGES + s); };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rank = static_cast<int>(cluster_rank());
  const int n0 = (blockIdx.x / C) * GT_BN;
  // the rank's K tiles: [rank * nk / C, (rank + 1) * nk / C)
  const int nk = (K + GT_BK - 1) / GT_BK;
  const int kt0 = rank * nk / C;
  const int nkr = (rank + 1) * nk / C - kt0;
  const int gl = K / G;  // scale-group length
  // every k16 step inside one group: per-column scales in registers,
  // groups of 16 rows or more staged by TMA; else looked up per K row
  const bool uniform = MODE == kInt8Col || G == 1 || gl % 16 == 0;
  const bool staged = MODE != kInt8Col && G > 1 && gl % 16 == 0;

  if (tid == 0) {
    for (int s = 0; s < GT_STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), GT_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int g = lane / 4;
  const int q = lane % 4;
  const int nl = 16 * gt_chunk<MODE>(g);  // the lane's 16 columns
  const int n = n0 + nl;

  if (warp == GT_WARPS) {
    if (lane == 0) {
      // the codes are read once: their lines leave L2 first
      const uint64_t evict_first = hopper::l2_evict_first();
      const uint32_t tx = CROWS * GT_BN + GT_X_BYTES +
                          (staged ? GT_S_BYTES : 0);
      for (int i = 0; i < nkr; ++i) {
        const int s = i % GT_STAGES;
        const int kt = kt0 + i;
        hopper::mbar_wait(empty(s), ((i / GT_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), tx);
        hopper::tma_load_2d_hint(c_s + s * GT_C_BYTES, &cmap, n0,
                                 kt * CROWS, full(s), evict_first);
        for (int b = 0; b < GT_BK / 64; ++b)
          hopper::tma_load_2d(x_s + s * GT_X_BYTES + 1024 * b, &xmap,
                              kt * GT_BK + 64 * b, 0, full(s));
        if (staged) {
          // the scale row [128 columns] of each warp's step's group
          for (int w = 0; w < GT_WARPS; ++w)
            hopper::tma_load_2d(s_s + s * GT_S_BYTES + w * GT_BN * 4, &smap,
                                n0, min(kt * GT_BK + 16 * w, K - 1) / gl,
                                full(s));
        }
      }
    }
    __syncwarp();
  } else {
    const bool col_in = n < N;
    // the scales of the lane's 16 columns for one group (rows past K hold
    // zero codes: any finite scale will do)
    float sc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c)
      sc[c] = MODE != kInt8Col && G == 1 && col_in ? __ldg(scale + n + c)
                                                   : 0.f;
    // the lane's ldmatrix row of x: row m = lane % 8, K 16 w (+ 8 for
    // lanes 8-15) in box w / 4
    const uint32_t x_lane =
        (lane & 7) * 128 +
        ((((warp % 4) * 2 + ((lane >> 3) & 1)) ^ (lane & 7)) << 4) +
        (warp / 4) * 1024;

    // stage i: loads, the products (PER_ROW: scales looked up per K row),
    // then the release of the stage, once every loaded register was used
    auto consume = [&](auto per_row, int i) {
      constexpr bool PER_ROW = decltype(per_row)::value;
      const int s = i % GT_STAGES;
      hopper::mbar_wait(full(s), (i / GT_STAGES) & 1);
      const unsigned char* ct = c_ptr + s * GT_C_BYTES;
      auto row16 = [&](int r) {
        return *reinterpret_cast<const uint4*>(
            ct + r * GT_BN + (((nl >> 4) ^ (r & 7)) << 4));
      };
      uint4 rows[INT4 ? 2 : 4];
      if constexpr (INT4) {
        rows[0] = row16(8 * warp + q);
        rows[1] = row16(8 * warp + q + 4);
      } else {
        rows[0] = row16(16 * warp + 2 * q);
        rows[1] = row16(16 * warp + 2 * q + 1);
        rows[2] = row16(16 * warp + 2 * q + 8);
        rows[3] = row16(16 * warp + 2 * q + 9);
      }
      uint32_t b0, b1;
      ldsm_x2(b0, b1, x_s + s * GT_X_BYTES + x_lane);
      float scs[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) scs[c] = sc[c];
      if (!PER_ROW && staged) {
        const float4* sp = reinterpret_cast<const float4*>(
            s_ptr + s * GT_S_BYTES + (warp * GT_BN + nl) * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = sp[c];
          scs[4 * c] = v.x;
          scs[4 * c + 1] = v.y;
          scs[4 * c + 2] = v.z;
          scs[4 * c + 3] = v.w;
        }
      }
      gt_step<MODE, PER_ROW>(acc, rows, b0, b1, scs, scale,
                             (kt0 + i) * GT_BK + 16 * warp + 2 * q, K, N, gl,
                             n, col_in);
      // a shared-memory load may still be reading after it issued: the
      // stage is released only once mma has consumed every loaded register
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    };
    for (int i = 0; i < nkr; ++i) {
      if (uniform)
        consume(std::false_type{}, i);
      else
        consume(std::true_type{}, i);
    }
  }

  // the warps' partials, in warp order, into part [m][128 columns]
  __syncthreads();  // every stage consumed: the code ring is free
  // red [warp][8 m][GT_RED columns]: the padded rows put the lanes of
  // one store (columns 16 c + 2 j, rows 2 q) on distinct banks
  float* red = reinterpret_cast<float*>(c_ptr);
  if (warp < GT_WARPS) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * 8 + 2 * q + (e & 1)) * GT_RED + nl + 2 * j + (e >> 1)] =
            acc[j][e];
  }
  __syncthreads();
  for (int e = tid; e < GT_PART; e += GT_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GT_WARPS; ++w)
      sum += red[(w * 8 + e / GT_BN) * GT_RED + e % GT_BN];
    part[e] = sum;
  }
  // the ranks' partials, in rank order; rank r writes its slice of the
  // M x 128 outputs (all C loads issued before the sum)
  cluster_sync();
  const int total = M * GT_BN;
  const int e_end = (rank + 1) * total / C;
  for (int e = rank * total / C + tid; e < e_end; e += GT_THREADS) {
    const int col = n0 + e % GT_BN;
    if (col >= N) continue;
    float v[GT_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < GT_MAX_CLUSTER; ++r)
      if (r < C) v[r] = ld_cluster(part_s + 4 * e, static_cast<uint32_t>(r));
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < GT_MAX_CLUSTER; ++r)
      if (r < C) sum += v[r];
    if (MODE == kInt8Col) sum *= scale[col];
    out[static_cast<size_t>(e / GT_BN) * N + col] = __float2bfloat16(sum);
  }
  cluster_sync();  // no block leaves while another reads its partial
}

template <int MODE>
int launch_gemv_tc(const void* x, const void* codes, const float* scale,
                   __nv_bfloat16* out, int M, int K, int N, int G, int C,
                   cudaStream_t stream) {
  constexpr int CROWS = MODE == kInt4 ? GT_BK / 2 : GT_BK;
  if (C < 1 || C > GT_MAX_CLUSTER || C > (K + GT_BK - 1) / GT_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, cmap, smap;
  if (!hopper::make_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                           K, K, 8, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                           MODE == kInt4 ? K / 2 : K, N, N, CROWS, GT_BN,
                           CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map_2d(&smap, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           MODE == kInt8Col ? 1 : G, N, N, 1, GT_BN,
                           CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<gemv_tc_kernel<MODE>>(GT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + GT_BN - 1) / GT_BN) * C);
  cfg.blockDim = dim3(GT_THREADS);
  cfg.dynamicSmemBytes = GT_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // a cluster of one launches as a grid
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, gemv_tc_kernel<MODE>, xmap, cmap, smap, scale, out, M, K, N, G,
      C);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
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
      if (gemv_tc_route(M, K, N))
        return launch_gemv_tc<MODE>(x, codes, sp, op, M, K, N, G, splits,
                                    stream);
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
    if (wgmma_route(M, K, N))
      return launch_wgmma<MODE>(x, codes, sp, op, M, K, N, G, stream);
    const dim3 grid((N + TC_BN - 1) / TC_BN, (M + 127) / 128);
    tc_prefill_kernel<MODE><<<grid, TC_THREADS, 0, stream>>>(xp, cp, sp, op,
                                                             M, K, N, G);
  } else {
    constexpr int bytes = FtLayout<MODE>::BYTES;
    cudaError_t err = allow_smem<fp32_tc_kernel<MODE>>(bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + FT_BN - 1) / FT_BN, (M + FT_BM - 1) / FT_BM, splits);
    fp32_tc_kernel<MODE><<<grid, FT_THREADS, bytes, stream>>>(
        xp, cp, sp, op, wp, M, K, N, G, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(M) * N;
    finalize_kernel<XT, MODE>
        <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
            wp, sp, op, M, N, splits);
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
// [splits, M, N] (used when M <= 8 off the gemv_tc route, whose `splits`
// is its cluster size, and by fp32 x with M > 8 and splits > 1). G divides
// K (into even groups for int4); x and the codes are 16-byte aligned. The
// caller validates shapes.
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

// 1 when quant_matmul takes the wgmma + TMA kernel for these arguments (M
// > 8 rows of bf16 x, K % 8 == 0, N % 16 == 0), else 0: the route is
// chosen by shape before any launch.
extern "C" int quant_matmul_wgmma_route(int M, int K, int N, int x_bf16) {
  return x_bf16 && wgmma_route(M, K, N) ? 1 : 0;
}

// 1 when quant_matmul takes the one-launch tensor-core GEMV (gemv_tc_kernel)
// for these arguments (M <= 8 rows of bf16 x, K % 8 == 0, N % 16 == 0): its
// `splits` argument is then the cluster size (1 to 8, at most the K tiles of
// 128 rows), and `work` is not read.
extern "C" int quant_matmul_gemv_tc_route(int M, int K, int N, int x_bf16) {
  return x_bf16 && gemv_tc_route(M, K, N) ? 1 : 0;
}
