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
// Which kernel runs is chosen by shape before any launch (wgmma_route,
// gemv_tc_route and the ragged rest, mirrored by ops/quant_matmul.py
// kernel_route):
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
// - other bf16 x, any M (rows TMA cannot address: K % 8 or N % 16 not 0):
//   ragged_kernel, one launch, y^T = W^T x^T as gemv_tc does it: the
//   dequantized weight (bit for bit the plain version's) is the mma.sync
//   m16n8k16 A operand, built in registers, and x^T the B operand, the
//   row tile chosen from M (8, 16, 32, 64 or 128 rows filling 1 to 16 n8
//   tiles: no mma row is padding at M <= 8, and M 37 pads to 64; 128-row
//   tiles have warps of 32 W columns, so each weight a warp dequantizes
//   meets 16 n8 tiles, not 8). K is
//   split over the warps of a block and the ranks of a thread-block
//   cluster sized by the host from the SM count (ops/quant_matmul.py
//   ragged_grid), which also picks the column tile (64, 128 or 256 W
//   columns), so that 264 -> 1000 runs on 128 blocks; the warps' and
//   ranks' fp32 sums are added in a fixed order through shared and
//   distributed shared memory, K8's scale and the bf16 rounding follow in
//   the same kernel: no finalize pass, no scratch, graph-safe. TMA is out
//   (its 16-byte strides), so a cp.async ring copies each row as the
//   16-byte-aligned window around it, in whole 16-byte copies cut at the
//   row's end, and the reader shifts by the row's offset: rows that start
//   on any byte (N odd, N = 14330's 2-byte steps, x rows of odd K) load as
//   wide as aligned ones.
// - fp32 x, M <= 8 (gemv_tf32_kernel, one launch): the tensor cores at
//   fp32 accuracy, arranged as gemv_tc arranges decode. y^T = W^T x^T:
//   the codes, small integers and so exact in TF32, are the A operand of
//   mma.sync m16n8k8 (16 W columns x 8 K rows), x's <= 8 rows the n8
//   operand, split into two TF32 parts, x = hi + lo, each product run on
//   both with fp32 accumulation (one TF32 pass keeps 11 bits of x, which
//   the fp32 tolerance refuses). Each scale group's fp32 sum is multiplied
//   by its scale once, not per element; K8's column scale multiplies the
//   total. A block owns 128 W columns; its 4 warps split its share of K
//   into contiguous ranges (a warp crosses a scale group only every group
//   length), and a thread-block cluster sized from the SM count (two
//   blocks of 4 warps an SM ran int4 28% faster than one block of 8)
//   splits K over blocks. Every warp feeds its own ring of stages of 32 K
//   rows, each the codes, x's rows and the scale rows of the groups it
//   touches: TMA boxes (128B-swizzled, on mbarriers) where code rows are
//   16-byte addressable (N % 16 == 0, K % 4 == 0), else cp.async
//   (ragged_kernel's 16-byte row windows for the codes, read back
//   shifted, so any N is taken). Nothing in the loop reads global memory
//   (x read through L1 a step ahead cost 3 of a first version's 32 us,
//   PERF.md). The warps' sums, then the ranks', are added in a fixed
//   order in shared and distributed shared memory (no atomics); one
//   launch, no scratch, graph-safe. It replaces the first design: fp32 FMA
//   on the CUDA cores (each code multiplied 8 times), synchronous 8-byte
//   loads, a scale load and multiply per element, x staged in shared
//   memory, and K split into an fp32 scratch that a second launch
//   (finalize_kernel) summed.
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

// rows of x up to which a product is a decode (the gemv kernels' n8)
constexpr int DECODE_MAX_ROWS = 8;

// ---------------------------------------------------------------------------
// split-K partial sums: the fp32 prefill's finalize pass
// ---------------------------------------------------------------------------

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
  return M > DECODE_MAX_ROWS && K % 8 == 0 && N % 16 == 0;
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
  return M <= DECODE_MAX_ROWS && K % 8 == 0 && N % 16 == 0;
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

// ---------------------------------------------------------------------------
// ragged tensor-core path: bf16 x whose rows TMA cannot address (K % 8 or
// N % 16 not 0), any M
// ---------------------------------------------------------------------------

constexpr int RG_THREADS = 256;      // 8 warps: wn along N x 8 / wn along K
constexpr int RG_MAX_CLUSTER = 8;
constexpr int RG_MIN_GROUP = 8;      // shortest scale group staged in the ring

// rows of x a block takes are 8 * MT (MT n8 tiles of the mma): MT from M
int rg_mt(int M) {
  return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : M <= 64 ? 8 : 16;
}

// m16 tiles of W columns a warp holds: 4 (64 columns), or 2 (32 columns)
// with 128 rows of x, so that a warp's 128 accumulators meet each
// dequantized weight 16 times
__host__ __device__ constexpr int rg_mi(int MT) { return MT == 16 ? 2 : 4; }
// stages of the ring, and k16 steps a warp takes in each (two for the
// wider row tiles, so that a warp has a second step's loads to run while
// the first one's products do)
__host__ __device__ constexpr int rg_stages(int MT) { return MT == 1 ? 6 : 4; }
__host__ __device__ constexpr int rg_steps(int MT) { return MT >= 4 ? 2 : 1; }

// the warps along N a row tile may take: 1 for up to 32 rows, 2 or 4 for
// 64 (a stage of 8 warps along K would not fit), 4 or 8 for 128
__host__ __device__ constexpr bool rg_wn_ok(int MT, int wn) {
  return MT <= 4 ? wn == 1 : MT == 8 ? wn == 2 || wn == 4
                                     : wn == 4 || wn == 8;
}

// Shared-memory layout of ragged_kernel for a row tile of 8 MT and wn warps
// along N. A stage holds, for bk K rows: the code rows (bn + 16 bytes: the
// 16-byte-aligned window around the row's bn columns), the rows of x (bk +
// 8 elements, the same kind of window) and the scale rows of the groups it
// touches (bn + 4 floats). Every row length is a multiple of 16 bytes, so
// every window lands 16-byte aligned. After the K loop the ring holds the
// fp32 partials [wk - 1][8 MT][bn + 1] of warps 1.. along K; the block's
// sum, which the cluster's ranks read, sits after it (C > 1 only).
struct RgLayout {
  int wn, wk, bn, bk;   // warps along N and K, block columns, stage K rows
  int crows, cstride;   // code rows a stage (int4: byte rows), bytes a row
  int xstride;          // bf16 a staged x row
  int grows, sstride;   // scale rows a stage, floats a staged scale row
  int c_bytes, x_bytes, stage;
  int rstride, tile;    // floats a partial row, floats a partial
  int part_off, smem;   // bytes
};

__host__ __device__ inline RgLayout rg_layout(bool int4, int MT, int wn,
                                              int C) {
  RgLayout L;
  L.wn = wn;
  L.wk = 8 / wn;
  L.bn = 16 * rg_mi(MT) * wn;
  L.bk = 16 * L.wk * rg_steps(MT);
  L.crows = int4 ? L.bk / 2 : L.bk;
  L.cstride = L.bn + 16;
  L.xstride = L.bk + 8;
  L.grows = L.bk / RG_MIN_GROUP + 2;
  L.sstride = L.bn + 4;
  L.c_bytes = L.crows * L.cstride;
  L.x_bytes = 8 * MT * L.xstride * 2;
  L.stage = L.c_bytes + L.x_bytes + L.grows * L.sstride * 4;
  L.rstride = L.bn + 1;  // odd: lanes (g, q) of a store hit 2 per bank
  L.tile = 8 * MT * L.rstride;
  const int ring = rg_stages(MT) * L.stage;
  const int red = (L.wk - 1) * L.tile * 4;
  L.part_off = ring > red ? ring : red;
  L.smem = L.part_off + (C > 1 ? L.tile * 4 : 0);
  return L;
}

// the most shared memory any launch of this row tile takes
inline int rg_max_smem(bool int4, int MT) {
  int most = 0;
  for (int wn = 1; wn <= 8; wn *= 2) {
    if (!rg_wn_ok(MT, wn)) continue;
    const int s = rg_layout(int4, MT, wn, 2).smem;
    most = s > most ? s : most;
  }
  return most;
}

// 16 bytes global -> shared, of which the first `bytes` (0..16) are read
// and the rest zero-filled
__device__ __forceinline__ void cp16n(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// the bytes of [a, a + 16) that lie before `end`, 0..16
__device__ __forceinline__ int rg_valid(long long a, long long end) {
  const long long v = end - a;
  return v <= 0 ? 0 : v >= 16 ? 16 : static_cast<int>(v);
}

// y^T = W^T x^T for bf16 x whose rows TMA cannot address. The dequantized
// weight (bit for bit the plain version's bf16 weight) is the A operand of
// mma.sync m16n8k16, built in registers from the staged codes; x^T is the
// B operand, the block's 8 MT rows of x filling MT n8 tiles, so at M <= 8
// no product row is padding and M 37 pads to 64, not 128.
//
// Block = (column tile, cluster rank, row tile): bn = 16 MI wn W columns x
// 8 MT rows of x over the rank's share of the K axis in k16 steps (rank r
// of C takes steps r * n16 / C .. (r + 1) * n16 / C). Warp (wn, wk) owns
// 16 MI W columns (lane group g the 2 MI columns from 2 MI g: m16 tile j's
// rows g and g + 8 are its columns 2 j and 2 j + 1) and takes steps
// wk * ks .. wk * ks + ks - 1 of every stage of wk-count * ks steps (ks =
// rg_steps(MT)). A cp.async ring of rg_stages(MT) stages keeps the next
// stages' code rows, x rows and scale rows in flight while one is
// multiplied; a stage copies only the rows of the rank's steps and the
// scale groups they touch. Rows have no alignment to rely on (x rows of
// odd K bf16, code rows of N bytes, N = 14330 puts every other row on a
// 2-byte boundary), so each row is copied as the 16-byte aligned window
// around it, in whole 16-byte copies that read only up to the row's end
// (zeros beyond, and past K or M); the reader shifts by the row's offset
// in its window, (row * N) % 16 bytes for codes, (m * K) % 8 elements for
// x, (group * N) % 4 floats for scales. Scales: per-column ones and groups
// of 8 rows or more (even, so a pair of K rows never straddles two) are
// staged a stage's groups at a time and held in registers per row pair
// until the pair enters a new group; other groups (odd or shorter) are
// read per K row from global memory, in an instantiation of their own
// (PER_ROW), so that the common loop carries none of its code.
//
// The sums run in a fixed order: a warp's steps in K order, then warps
// 1.. along K, which had a step, write their fp32 partials to shared
// memory and warp 0 of each column group adds them in warp order to its
// own; with a cluster, the ranks' sums are added in rank order through
// distributed shared memory, each rank finishing a slice of the tile. K8's
// column scale, the bf16 rounding and the stores masked at the M and N
// edges follow in the same kernel. No atomics, no scratch, nothing read on
// the host: one launch that a CUDA graph replays.
template <int MODE, int MT, bool PER_ROW>
__global__ void __launch_bounds__(RG_THREADS)
    ragged_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N, int G,
                  int C, int wn_count) {
  constexpr bool INT4 = MODE == kInt4;
  constexpr int S = rg_stages(MT);
  constexpr int KS = rg_steps(MT);
  constexpr int MI = rg_mi(MT);
  constexpr int LC = 2 * MI;      // W columns of a lane
  constexpr int LW = LC / 4;      // ... in 32-bit words
  constexpr float offset = INT4 ? 8.f : 128.f;
  constexpr bool staged = MODE != kInt8Col && !PER_ROW;
  extern __shared__ __align__(16) unsigned char rg_smem[];
  const RgLayout L = rg_layout(INT4, MT, wn_count, C);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int wn = warp % L.wn;
  const int wk = warp / L.wn;
  const int rank = static_cast<int>(cluster_rank());
  const int n0 = (static_cast<int>(blockIdx.x) / C) * L.bn;
  const int m0 = static_cast<int>(blockIdx.y) * 8 * MT;
  const int n16 = (K + 15) / 16;
  const int st0 = rank * n16 / C;
  const int st1 = (rank + 1) * n16 / C;
  const int per = L.wk * KS;                  // steps a stage
  const int nst = (st1 - st0 + per - 1) / per;
  // warps along K that take a step (all in the first stage)
  const int nwk = min(L.wk, (st1 - st0 + KS - 1) / KS);
  const int gl = K / G;  // scale-group length
  const int KR = INT4 ? K / 2 : K;          // code rows
  const int nl = (wn * 8 + g) * LC;         // the lane's first column
  const int n = n0 + nl;
  // the offset of the lane's x rows (m0 + 8 t + g) in their windows,
  // (m K) % 8 elements: the same for every t, as m0 % 8 == 0
  const int xsh = (g * (K & 7)) & 7;

  // each thread's share of a stage's copies: (row, 16-byte chunk), rows
  // stepping by the rows one pass of the block covers
  const int c_cpr = L.bn / 16 + 1;
  const int x_cpr = L.bk / 8 + 1;
  const int s_cpr = L.bn / 4 + 1;
  const int c_r0 = tid / c_cpr, c_ch = tid % c_cpr;
  const int x_r0 = tid / x_cpr, x_ch = tid % x_cpr;
  const int s_r0 = tid / s_cpr, s_ch = tid % s_cpr;
  const int c_step = RG_THREADS / c_cpr;
  const int x_step = RG_THREADS / x_cpr;
  const int s_step = RG_THREADS / s_cpr;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(scale);

  // stage i of the rank (its steps st0 + i per ..) into ring slot `buf`
  auto load_stage = [&](int i, int buf) {
    unsigned char* st = rg_smem + buf * L.stage;
    const int f = st0 + i * per;
    const int k0 = 16 * f;
    const int steps = min(per, st1 - f);
    if (c_r0 < c_step) {
      const int kr0 = INT4 ? 8 * f : k0;
      const int rows = INT4 ? 8 * steps : 16 * steps;
      for (int r = c_r0; r < rows; r += c_step) {
        const int kr = kr0 + r;
        const long long start = static_cast<long long>(kr) * N + n0;
        const long long a = (start & ~15LL) + 16 * c_ch;
        const int v = kr < KR ? rg_valid(a, start - n0 + N) : 0;
        cp16n(saddr(st + r * L.cstride + 16 * c_ch), codes + (v ? a : 0), v);
      }
    }
    unsigned char* xs = st + L.c_bytes;
    if (x_r0 < x_step && x_ch <= 2 * steps) {
      for (int r = x_r0; r < 8 * MT; r += x_step) {
        const int m = m0 + r;
        const long long row = 2LL * m * K;
        const long long a = ((row + 2LL * k0) & ~15LL) + 16 * x_ch;
        const int v = m < M ? rg_valid(a, row + 2LL * K) : 0;
        cp16n(saddr(xs + r * L.xstride * 2 + 16 * x_ch), xb + (v ? a : 0),
              v);
      }
    }
    if (staged && s_r0 < s_step) {
      unsigned char* ss = xs + L.x_bytes;
      const int g0 = G == 1 ? 0 : k0 / gl;
      const int rows =
          G == 1 ? 1 : (min(16 * (f + steps), K) - 1) / gl - g0 + 1;
      for (int r = s_r0; r < rows; r += s_step) {
        const long long row = 4LL * (g0 + r) * N;
        const long long a = ((row + 4LL * n0) & ~15LL) + 16 * s_ch;
        const int v = rg_valid(a, row + 4LL * N);
        cp16n(saddr(ss + r * L.sstride * 4 + 16 * s_ch), sb + (v ? a : 0), v);
      }
    }
  };

  float acc[MI][MT][4];
#pragma unroll
  for (int j = 0; j < MI; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
  // staged scales of the lane's columns for row pair p (K rows k + 8 p,
  // k + 8 p + 1), valid below K row gend[p]
  float sc[2][LC];
  int gend[2] = {0, 0};
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int c = 0; c < LC; ++c) sc[p][c] = 0.f;

  // the lane's LC code bytes in staged code row `rel` (absolute code row
  // kr), as LW words: the window's words from the row's shift on
  auto code_row = [&](const unsigned char* cs, int rel, int kr,
                      uint32_t (&out)[LW]) {
    const int sh = ((kr & 15) * (N & 15)) & 15;  // (kr * N) % 16
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        cs + ((rel * L.cstride + nl + sh) & ~3));
    uint32_t v[LW + 1];
#pragma unroll
    for (int i = 0; i <= LW; ++i) v[i] = w[i];
    const int bits = 8 * (sh & 3);
#pragma unroll
    for (int i = 0; i < LW; ++i) out[i] = __funnelshift_r(v[i], v[i + 1], bits);
  };

  // k16 step `step` of stage i, the warp's ks-th of the stage
  auto compute = [&](int i, int buf, int ks) {
    const int sl = wk * KS + ks;   // the step's place in the stage
    const int step = st0 + i * per + sl;
    if (step >= st1) return;
    const unsigned char* cs = rg_smem + buf * L.stage;
    const unsigned char* xs = cs + L.c_bytes;
    const float* ss = reinterpret_cast<const float*>(xs + L.x_bytes);
    const int k = 16 * step + 2 * q;  // the lane's first K row
    // lo[h] / hi[h]: K rows k + 8 h and k + 8 h + 1 of the lane's columns,
    // one byte (code + offset) a column
    uint32_t lo[2][LW], hi[2][LW];
    if constexpr (INT4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[LW];
        code_row(cs, 8 * sl + q + 4 * h, 8 * step + q + 4 * h, w);
#pragma unroll
        for (int c = 0; c < LW; ++c) {
          lo[h][c] = (w[c] & 0x0F0F0F0Fu) ^ 0x08080808u;
          hi[h][c] = ((w[c] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rel = 16 * sl + 2 * q + 8 * h;
        uint32_t a[LW], b[LW];
        code_row(cs, rel, k + 8 * h, a);
        code_row(cs, rel + 1, k + 8 * h + 1, b);
#pragma unroll
        for (int c = 0; c < LW; ++c) {
          lo[h][c] = a[c] ^ 0x80808080u;
          hi[h][c] = b[c] ^ 0x80808080u;
        }
      }
    }
    // x's B fragments: row 8 t + g, K elements 2 q, 2 q + 1 (+ 8) of the
    // step, shifted by the row's offset in its window, which is the
    // lane's xsh for every t (row tiles start at multiples of 8)
    uint32_t b[MT][2];
    const uint32_t* xw =
        reinterpret_cast<const uint32_t*>(xs + g * L.xstride * 2) +
        (xsh + 16 * sl + 2 * q) / 2;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const uint32_t* w = xw + t * 4 * L.xstride;  // 8 rows of x further
      if (K & 1) {
        b[t][0] = __funnelshift_r(w[0], w[1], 16 * (xsh & 1));
        b[t][1] = __funnelshift_r(w[4], w[5], 16 * (xsh & 1));
      } else {
        b[t][0] = w[0];
        b[t][1] = w[4];
      }
    }
    if constexpr (staged) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int kp = min(k + 8 * p, K - 1);
        if (kp >= gend[p]) {  // the pair enters a new group
          const int grp = kp / gl;
          gend[p] = (grp + 1) * gl;
          const int g0 = 16 * (st0 + i * per) / gl;
          const float* sp = ss + (grp - g0) * L.sstride +
                            (((grp & 3) * (N & 3)) & 3) + nl;
#pragma unroll
          for (int c = 0; c < LC; ++c) sc[p][c] = sp[c];
        }
      }
    }
    // the scale of K row kk (groups read per row), column c of the lane
    auto row_scale = [&](int kk, int c) {
      const int grp = min(kk, K - 1) / gl;
      return __ldg(scale + static_cast<size_t>(grp) * N + min(n + c, N - 1));
    };
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // column 2 j + e of the lane's
          const int c = 2 * j + e;
          const float f0 = code_f(lo[h][c / 4], c % 4, offset);
          const float f1 = code_f(hi[h][c / 4], c % 4, offset);
          if constexpr (MODE == kInt8Col) {
            // |code| <= 127 is exact in bf16: the floats' top halves
            a[2 * h + e] = __byte_perm(__float_as_uint(f0),
                                       __float_as_uint(f1), 0x7632);
          } else if constexpr (staged) {
            a[2 * h + e] = pack(f0 * sc[h][c], f1 * sc[h][c]);
          } else {
            a[2 * h + e] = pack(f0 * row_scale(k + 8 * h, c),
                                f1 * row_scale(k + 8 * h + 1, c));
          }
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) mma(acc[j][t], a, b[t][0], b[t][1]);
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nst) load_stage(i, i);
    cp_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_wait<S - 2>();
    __syncthreads();  // stage i landed; stage i - 1's products are done
    const int nx = i + S - 1;
    if (nx < nst) load_stage(nx, nx % S);
    cp_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) compute(i, i % S, ks);
  }
  cp_wait<0>();

  // warps 1.. along K with a step write their partials, red [wk - 1][8 MT
  // rows][rstride]; warp 0 of each column group adds them in warp order
  float* red = reinterpret_cast<float*>(rg_smem);
  auto at = [&](int j, int t, int e) {  // the accumulator's place in a tile
    return (8 * t + 2 * q + (e & 1)) * L.rstride + nl + 2 * j + (e >> 1);
  };
  if (nwk > 1) {
    __syncthreads();  // every stage consumed: the ring is free
    if (wk > 0 && wk < nwk) {
#pragma unroll
      for (int j = 0; j < MI; ++j)
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(wk - 1) * L.tile + at(j, t, e)] = acc[j][t][e];
    }
    __syncthreads();
    if (wk == 0) {
      for (int w = 1; w < nwk; ++w)
#pragma unroll
        for (int j = 0; j < MI; ++j)
#pragma unroll
          for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][t][e] += red[(w - 1) * L.tile + at(j, t, e)];
    }
  }
  if (C == 1) {  // the block's sum is the product: store it
    if (wk == 0) {
#pragma unroll
      for (int j = 0; j < MI; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column n + 2 j + h
          const int col = n + 2 * j + h;
          if (col >= N) continue;
          const float cs = MODE == kInt8Col ? scale[col] : 1.f;
#pragma unroll
          for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // row 8 t + 2 q + e
              const int m = m0 + 8 * t + 2 * q + e;
              if (m < M)
                out[static_cast<size_t>(m) * N + col] =
                    __float2bfloat16(acc[j][t][2 * h + e] * cs);
            }
        }
      }
    }
    return;
  }
  float* part = reinterpret_cast<float*>(rg_smem + L.part_off);
  if (wk == 0) {
#pragma unroll
    for (int j = 0; j < MI; ++j)
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[at(j, t, e)] = acc[j][t][e];
  }
  // the ranks' sums, in rank order; rank r finishes its slice of the tile
  cluster_sync();
  const int total = 8 * MT * L.bn;
  const int shift = __ffs(L.bn) - 1;  // log2(bn)
  const int e_end = (rank + 1) * total / C;
  for (int e = rank * total / C + tid; e < e_end; e += RG_THREADS) {
    const int row = e >> shift;
    const int col = e & (L.bn - 1);
    if (m0 + row >= M || n0 + col >= N) continue;
    const uint32_t addr = saddr(part + row * L.rstride + col);
    float v[RG_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < RG_MAX_CLUSTER; ++r)
      if (r < C) v[r] = ld_cluster(addr, static_cast<uint32_t>(r));
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < RG_MAX_CLUSTER; ++r)
      if (r < C) sum += v[r];
    if (MODE == kInt8Col) sum *= scale[n0 + col];
    out[static_cast<size_t>(m0 + row) * N + n0 + col] = __float2bfloat16(sum);
  }
  cluster_sync();  // no block leaves while another reads its partial
}

template <int MODE, int MT, bool PER_ROW>
int launch_ragged_mt(const __nv_bfloat16* x, const uint8_t* codes,
                     const float* scale, __nv_bfloat16* out, int M, int K,
                     int N, int G, int C, int wn, cudaStream_t stream) {
  if (!rg_wn_ok(MT, wn)) return static_cast<int>(cudaErrorInvalidValue);
  const RgLayout L = rg_layout(MODE == kInt4, MT, wn, C);
  const cudaError_t err = allow_smem<ragged_kernel<MODE, MT, PER_ROW>>(
      rg_max_smem(MODE == kInt4, MT));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (M + 8 * MT - 1) / (8 * MT);
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + L.bn - 1) / L.bn) * C, row_tiles);
  cfg.blockDim = dim3(RG_THREADS);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // a cluster of one launches as a grid
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, ragged_kernel<MODE, MT, PER_ROW>, x, codes, scale, out, M, K, N,
      G, C, wn);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool PER_ROW>
int launch_ragged_rows(const __nv_bfloat16* x, const uint8_t* codes,
                       const float* scale, __nv_bfloat16* out, int M, int K,
                       int N, int G, int C, int wn, cudaStream_t stream) {
  switch (rg_mt(M)) {
    case 1:
      return launch_ragged_mt<MODE, 1, PER_ROW>(x, codes, scale, out, M, K,
                                                N, G, C, wn, stream);
    case 2:
      return launch_ragged_mt<MODE, 2, PER_ROW>(x, codes, scale, out, M, K,
                                                N, G, C, wn, stream);
    case 4:
      return launch_ragged_mt<MODE, 4, PER_ROW>(x, codes, scale, out, M, K,
                                                N, G, C, wn, stream);
    case 8:
      return launch_ragged_mt<MODE, 8, PER_ROW>(x, codes, scale, out, M, K,
                                                N, G, C, wn, stream);
    default:
      return launch_ragged_mt<MODE, 16, PER_ROW>(x, codes, scale, out, M, K,
                                                 N, G, C, wn, stream);
  }
}

// C: cluster size (1 to 8, at most the K axis's k16 steps); wn: warps
// along N (rg_wn_ok)
template <int MODE>
int launch_ragged(const void* x, const void* codes, const float* scale,
                  __nv_bfloat16* out, int M, int K, int N, int G, int C,
                  int wn, cudaStream_t stream) {
  if (C < 1 || C > RG_MAX_CLUSTER || C > (K + 15) / 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const int gl = K / G;
  if constexpr (MODE != kInt8Col) {
    // groups that a pair of K rows may straddle, or shorter than a stage's
    // staged rows allow: scales read per K row
    if (G > 1 && (gl % 2 != 0 || gl < RG_MIN_GROUP))
      return launch_ragged_rows<MODE, true>(xp, cp, scale, out, M, K, N, G,
                                            C, wn, stream);
  }
  return launch_ragged_rows<MODE, false>(xp, cp, scale, out, M, K, N, G, C,
                                         wn, stream);
}

// ---------------------------------------------------------------------------
// fp32 decode on the tensor cores: M <= 8, fp32 x
// ---------------------------------------------------------------------------

constexpr int GF_WARPS = 4;                  // each a contiguous range of K
constexpr int GF_THREADS = 32 * GF_WARPS;
constexpr int GF_BN = 128;                   // W columns of a block
constexpr int GF_STEPS = 4;                  // k8 steps of a warp's stage
constexpr int GF_KS = 8 * GF_STEPS;          // K rows of a stage
constexpr int GF_WIN = GF_BN + 16;           // bytes of a staged row window
constexpr int GF_X_BYTES = 8 * GF_KS * 4;    // x [8 rows, 32 K], swizzled
constexpr int GF_S_BYTES = 2 * GF_BN * 4;    // two scale rows
constexpr int GF_MIN_STAGED_GROUP = GF_KS;   // shorter groups: __ldg'd
constexpr int GF_RED = GF_BN + 4;            // padded rows of the warp sums
constexpr int GF_PART = 8 * GF_BN;           // a block's fp32 partial [8][128]
constexpr int GF_MAX_CLUSTER = 8;
constexpr int GF_OUT = GF_PART / GF_THREADS;  // outputs a thread finishes

// Shared memory of gemv_tf32_kernel: per warp a ring of stages, each the
// code rows of GF_STEPS k8 steps (int4: byte rows, two K rows each), 128
// bytes a row under TMA's 128B swizzle, else 144-byte windows (padded to
// 1 KB), then x's 8 rows of the stage's K rows (128B-swizzled) and the
// scale rows of the (at most two) groups the stage touches; then the
// block's partial and the mbarriers.
template <int MODE, bool TMA>
struct GfLayout {
  static constexpr int ROWS = (MODE == kInt4 ? 4 : 8) * GF_STEPS;
  static constexpr int ROW = TMA ? GF_BN : GF_WIN;
  static constexpr int CODES = (ROWS * ROW + 1023) / 1024 * 1024;
  static constexpr int STAGE = CODES + GF_X_BYTES + GF_S_BYTES;
  static constexpr int STAGES = TMA ? 4 : 3;
  static constexpr int RING = GF_WARPS * STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + GF_PART * 4 +
                              GF_WARPS * STAGES * 8;
  static_assert(CODES % 1024 == 0 && GF_X_BYTES == 1024,
                "swizzled boxes 1024-aligned");
  static_assert(GF_WARPS * 8 * GF_RED * 4 <= RING,
                "the warps' sums reuse the ring");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one block");
};

// The 16-byte chunk of a 128-column tile that lane group g reads in its
// load L (0, 1): 8 columns, at byte 8 (g & 1) of the chunk. int8 lanes read
// K rows 2q and 2q + 1 of a step (swizzle rows 0, 2, 4, 6 and 1, 3, 5, 7),
// int4 lanes byte row q (rows 0-3 or 4-7): both maps keep the 16 lanes of
// a 64-bit load phase on 8 distinct chunks, conflict-free.
template <int MODE>
__device__ __forceinline__ int gf_chunk(int g, int L) {
  return MODE == kInt4 ? ((((g >> 1) & 1) << 2) | (g >> 2)) + 2 * L
                       : (g >> 1) + 4 * L;
}

// y^T = W^T x^T for fp32 x, M <= 8: block = (column tile, cluster rank),
// 128 W columns over the rank's share of the K axis in k8 steps (rank r
// of C takes steps r * n8 / C .. (r + 1) * n8 / C), split among the 4 warps
// into contiguous ranges. The codes are mma.sync m16n8k8's A operand (16
// W columns x 8 K rows, exact in TF32), x^T its B operand, the M <= 8 rows
// filling the n8 tile (rows past M are zeros). Lane (g, q) of a warp holds
// 8 n8 tiles: tile j's A rows g and g + 8 are W columns cb0 + j and cb1 +
// j (cb = the byte of gf_chunk's chunk), its A columns q and q + 4 are K
// rows 2q and 2q + 1 of the step, and its accumulator rows 2q, 2q + 1 are
// rows of x. x is split as it is read, x = hi + lo, both TF32, and every
// step runs both products into a group sum, which is multiplied by the
// group's scales (read when the group opens) and added to the total when
// the group closes; a group boundary inside a step (groups that are no
// multiple of 8 rows) runs the step once per group with the other rows'
// codes zeroed. Each warp streams its own ring of stages of GF_STEPS
// steps: the code rows, x's rows and the scale rows of the groups the
// stage touches, by TMA (128B-swizzled boxes, one mbarrier a stage) where
// code rows are 16-byte addressable, else by cp.async (16-byte windows
// around each code row, read back shifted by the row's offset; x and
// scales by element). Nothing in the loop reads global memory (a first
// version read x through L1 a step ahead, 3 us slower at 8 x 4096 ->
// 4096); groups shorter than a stage read their scales from global memory
// instead. A
// stage is refilled only after the warp's products consumed every
// register loaded from it. The sums run in a fixed order: a warp's groups
// in K order, warps 0..3 in shared memory, cluster ranks 0..C-1 through
// distributed shared memory (each rank finishing a slice of the tile);
// K8's column scale follows. No atomics, no scratch, nothing read on the
// host: one launch that a CUDA graph replays.
template <int MODE, bool TMA>
__global__ void __launch_bounds__(GF_THREADS)
    gemv_tf32_kernel(const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap smap,
                     const float* __restrict__ x,
                     const uint8_t* __restrict__ codes,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int K, int N, int G, int C) {
  using L = GfLayout<MODE, TMA>;
  constexpr bool INT4 = MODE == kInt4;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(1024) unsigned char gf_smem[];
  const uint32_t raw = saddr(gf_smem);
  const uint32_t ring_s = (raw + 1023) & ~1023u;
  unsigned char* ring = gf_smem + (ring_s - raw);
  float* part = reinterpret_cast<float*>(ring + L::RING);
  const uint32_t part_s = ring_s + L::RING;
  const uint32_t bars = part_s + GF_PART * 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int rank = static_cast<int>(cluster_rank());
  const int n0 = (static_cast<int>(blockIdx.x) / C) * GF_BN;
  // the rank's k8 steps, then the warp's
  const int n8 = (K + 7) / 8;
  const int rs0 = rank * n8 / C;
  const int rn = (rank + 1) * n8 / C - rs0;
  const int ws0 = rs0 + warp * rn / GF_WARPS;
  const int wsn = rs0 + (warp + 1) * rn / GF_WARPS - ws0;
  const int wend = min(K, 8 * (ws0 + wsn));          // past the warp's rows
  const int nst = (wsn + GF_STEPS - 1) / GF_STEPS;  // the warp's stages
  const int KR = INT4 ? K / 2 : K;                   // code rows
  const int gl = MODE == kInt8Col ? K : K / G;       // scale-group length
  const bool staged = MODE != kInt8Col && gl >= GF_MIN_STAGED_GROUP;
  unsigned char* wring = ring + warp * S * L::STAGE;
  const uint32_t wring_s = ring_s + warp * S * L::STAGE;
  auto full = [&](int s) { return bars + 8 * (warp * S + s); };

  // K8's column scales of the outputs this thread finishes, read before
  // the stream starts
  const int total = M * GF_BN;
  float csc[GF_OUT];
#pragma unroll
  for (int o = 0; o < GF_OUT; ++o) {
    const int col = n0 + (rank * total / C + tid + o * GF_THREADS) % GF_BN;
    csc[o] = MODE == kInt8Col && col < N ? __ldg(scale + col) : 1.f;
  }

  if (TMA && lane == 0)
    for (int s = 0; s < S; ++s) hopper::mbar_init(full(s), 1);
  if (TMA) hopper::mbar_fence_init();
  __syncwarp();

  // the groups of the first and the last K row of stage i
  auto stage_groups = [&](int i, int& ga, int& gb) {
    const int k0 = 8 * (ws0 + GF_STEPS * i);
    ga = k0 / gl;
    gb = (min(k0 + GF_KS, wend) - 1) / gl;
  };
  // stage i of the warp (its steps ws0 + GF_STEPS i ..) into slot i % S
  auto load_stage = [&](int i) {
    const int s = i % S;
    const int k0 = 8 * (ws0 + GF_STEPS * i);
    const int r0 = INT4 ? k0 / 2 : k0;  // first code row
    const uint32_t st = wring_s + s * L::STAGE;
    int ga = 0, gb = 0;
    if (staged) stage_groups(i, ga, gb);
    const int srows = staged ? 1 + (gb != ga) : 0;
    if constexpr (TMA) {
      if (lane == 0) {
        hopper::mbar_expect_tx(full(s), L::CODES + GF_X_BYTES +
                                            srows * GF_BN * 4);
        hopper::tma_load_2d_hint(st, &cmap, n0, r0, full(s),
                                 hopper::l2_evict_first());
        hopper::tma_load_2d(st + L::CODES, &xmap, k0, 0, full(s));
        for (int r = 0; r < srows; ++r)
          hopper::tma_load_2d(st + L::CODES + GF_X_BYTES + r * GF_BN * 4,
                              &smap, n0, r ? gb : ga, full(s));
      }
    } else {
      // code rows past the warp's range or K are not copied (the reader
      // never looks at them); windows cut at the row's end, zeros beyond
      const int rows = min(L::ROWS, min(KR, INT4 ? wend / 2 : wend) - r0);
      for (int c = lane; c < rows * (GF_WIN / 16); c += 32) {
        const int rr = c / (GF_WIN / 16);
        const int ch = c % (GF_WIN / 16);
        const long long start = static_cast<long long>(r0 + rr) * N + n0;
        const long long a = (start & ~15LL) + 16 * ch;
        const int v = rg_valid(a, start - n0 + N);
        cp16n(st + rr * GF_WIN + 16 * ch, codes + (v ? a : 0), v);
      }
      // x element (m, c) at the 128B-swizzled place TMA would put it
      for (int e = lane; e < 8 * GF_KS; e += 32) {
        const int m = e / GF_KS;
        const int c = e % GF_KS;
        const bool in = m < M && k0 + c < K;
        cp4(st + L::CODES + m * 128 + (((c >> 2) ^ m) << 4) + 4 * (c & 3),
            in ? x + static_cast<size_t>(m) * K + k0 + c : x, in);
      }
      for (int e = lane; e < srows * GF_BN; e += 32) {
        const int r = e / GF_BN;
        const int col = n0 + e % GF_BN;
        const bool in = col < N;
        cp4(st + L::CODES + GF_X_BYTES + 4 * e,
            in ? scale + static_cast<size_t>(r ? gb : ga) * N + col : scale,
            in);
      }
      cp_commit();
    }
  };

  // the lane's 8 code bytes of load L in code row `rel` of slot s
  // (absolute code row kr), as a uint2
  const int cb[2] = {16 * gf_chunk<MODE>(g, 0) + 8 * (g & 1),
                     16 * gf_chunk<MODE>(g, 1) + 8 * (g & 1)};
  auto code8 = [&](int s, int rel, int kr, int Ld) -> uint2 {
    const unsigned char* st = wring + s * L::STAGE;
    if constexpr (TMA) {
      const int ch = (cb[Ld] >> 4) ^ (rel & 7);
      return *reinterpret_cast<const uint2*>(st + rel * GF_BN + (ch << 4) +
                                             (cb[Ld] & 15));
    } else {
      const int at = static_cast<int>(
                         (static_cast<long long>(kr) * N + n0) & 15) + cb[Ld];
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
          st + rel * GF_WIN + (at & ~3));
      const int bits = 8 * (at & 3);
      return make_uint2(__funnelshift_r(w[0], w[1], bits),
                        __funnelshift_r(w[1], w[2], bits));
    }
  };

  float acc[8][4], gacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = gacc[j][e] = 0.f;
  int cur = -1;   // the group gacc holds
  int gend = 0;   // the first K row past it
  float sc[16];   // its scales: [L * 8 + j] = column n0 + cb[L] + j
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 1.f;
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += gacc[j][e] * sc[(e >> 1) * 8 + j];
        gacc[j][e] = 0.f;
      }
  };
  // gacc now holds group grp, which stage i (slot s) touches: its scales
  auto start = [&](int grp, int i, int s) {
    cur = grp;
    if (MODE == kInt8Col) return;
    if (staged) {
      int ga, gb;
      stage_groups(i, ga, gb);
      const float* row = reinterpret_cast<const float*>(
          wring + s * L::STAGE + L::CODES + GF_X_BYTES +
          (grp == ga ? 0 : GF_BN * 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(row + cb[h]);
        const float4 b = *reinterpret_cast<const float4*>(row + cb[h] + 4);
        sc[8 * h] = a.x, sc[8 * h + 1] = a.y, sc[8 * h + 2] = a.z;
        sc[8 * h + 3] = a.w, sc[8 * h + 4] = b.x, sc[8 * h + 5] = b.y;
        sc[8 * h + 6] = b.z, sc[8 * h + 7] = b.w;
      }
      return;
    }
#pragma unroll
    for (int i2 = 0; i2 < 16; ++i2) {
      const int col = n0 + cb[i2 / 8] + i2 % 8;
      sc[i2] = col < N ? __ldg(scale + static_cast<size_t>(grp) * N + col)
                       : 0.f;
    }
  };

  for (int i = 0; i < S && i < nst; ++i) load_stage(i);
  for (int i = 0; i < nst; ++i) {
    const int s = i % S;
    if constexpr (TMA) {
      hopper::mbar_wait(full(s), (i / S) & 1);
    } else {
      // the warp's stages i .. are the youngest commit groups
      if (nst - i >= S)
        cp_wait<S - 1>();
      else
        cp_wait<0>();
      __syncwarp();
    }
    const unsigned char* xs = wring + s * L::STAGE + L::CODES;
#pragma unroll
    for (int t = 0; t < GF_STEPS; ++t) {
      const int step = ws0 + GF_STEPS * i + t;
      if (step >= ws0 + wsn) break;
      const int k = 8 * step;
      // the step's codes: lo[L] / hi[L] hold K rows 2q / 2q + 1 of the
      // lane's 8 columns of load L, one byte (code + offset) a column
      uint32_t lo[2][2], hi[2][2];
      if constexpr (INT4) {
        const int rel = 4 * t + q;
#pragma unroll
        for (int Ld = 0; Ld < 2; ++Ld) {
          const uint2 w = code8(s, rel, k / 2 + q, Ld);
          lo[Ld][0] = (w.x & 0x0F0F0F0Fu) ^ 0x08080808u;
          lo[Ld][1] = (w.y & 0x0F0F0F0Fu) ^ 0x08080808u;
          hi[Ld][0] = ((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          hi[Ld][1] = ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
      } else {
        const int rel = 8 * t + 2 * q;
#pragma unroll
        for (int Ld = 0; Ld < 2; ++Ld) {
          const uint2 a = code8(s, rel, k + 2 * q, Ld);
          const uint2 b = code8(s, rel + 1, k + 2 * q + 1, Ld);
          lo[Ld][0] = a.x ^ 0x80808080u;
          lo[Ld][1] = a.y ^ 0x80808080u;
          hi[Ld][0] = b.x ^ 0x80808080u;
          hi[Ld][1] = b.y ^ 0x80808080u;
        }
      }
      // x's rows g at K rows k + 2q, + 1 (columns 8t + 2q of the swizzled
      // box), split x = hi + lo, both TF32
      const float2 xv = *reinterpret_cast<const float2*>(
          xs + g * 128 + (((2 * t + (q >> 1)) ^ g) << 4) + 8 * (q & 1));
      uint32_t bh[2], bl[2];
      {
        float h, l;
        split_tf32(xv.x, h, l);
        bh[0] = __float_as_uint(h);
        bl[0] = __float_as_uint(l);
        split_tf32(xv.y, h, l);
        bh[1] = __float_as_uint(h);
        bl[1] = __float_as_uint(l);
      }
      if (k >= gend) {  // the step opens a group
        if (cur >= 0) flush();
        start(k / gl, i, s);
        gend = (cur + 1) * gl;
      }
      constexpr float offset = INT4 ? 8.f : 128.f;
      auto codef = [&](uint32_t w, int b) {
        return __float_as_uint(
            __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 | b)) -
            (8388608.f + offset));
      };
      // the products of the step, the rows outside the group zeroed
      auto products = [&](bool in0, bool in1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4];
          a[0] = in0 ? codef(lo[0][j / 4], j % 4) : 0u;
          a[1] = in0 ? codef(lo[1][j / 4], j % 4) : 0u;
          a[2] = in1 ? codef(hi[0][j / 4], j % 4) : 0u;
          a[3] = in1 ? codef(hi[1][j / 4], j % 4) : 0u;
          mma_tf32(gacc[j], a, bh[0], bh[1]);
          mma_tf32(gacc[j], a, bl[0], bl[1]);
        }
      };
      if (k + 7 < gend || gend >= K) {
        products(true, true);
      } else {
        const int gb = min(k + 7, K - 1) / gl;
        for (int gg = cur; gg <= gb; ++gg) {
          if (gg != cur) {
            flush();
            start(gg, i, s);
          }
          products((k + 2 * q) / gl == gg, (k + 2 * q + 1) / gl == gg);
        }
        gend = (cur + 1) * gl;
      }
    }
    // every register loaded from slot s was consumed by the products
    // above: the slot may be refilled
    __syncwarp();
    if (i + S < nst) load_stage(i + S);
  }
  if (cur >= 0) flush();

  // the warps' sums in warp order, into part [m][128 columns]
  __syncthreads();  // every warp left its ring: it holds the warp sums now
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 8 + 2 * q + (e & 1)) * GF_RED + cb[e >> 1] + j] = acc[j][e];
  __syncthreads();
  for (int e = tid; e < GF_PART; e += GF_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GF_WARPS; ++w)
      sum += red[(w * 8 + e / GF_BN) * GF_RED + e % GF_BN];
    part[e] = sum;
  }
  // the ranks' sums in rank order; rank r finishes its slice of the
  // M x 128 outputs
  cluster_sync();
  const int e_end = (rank + 1) * total / C;
#pragma unroll
  for (int o = 0; o < GF_OUT; ++o) {
    const int e = rank * total / C + tid + o * GF_THREADS;
    const int col = n0 + e % GF_BN;
    if (e >= e_end || col >= N) continue;
    float v[GF_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < GF_MAX_CLUSTER; ++r)
      if (r < C) v[r] = ld_cluster(part_s + 4 * e, static_cast<uint32_t>(r));
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < GF_MAX_CLUSTER; ++r)
      if (r < C) sum += v[r];
    out[static_cast<size_t>(e / GF_BN) * N + col] = sum * csc[o];
  }
  cluster_sync();  // no block leaves while another reads its partial
}

template <int MODE, bool TMA>
int launch_gemv_tf32_route(const CUtensorMap& cmap, const CUtensorMap& xmap,
                           const CUtensorMap& smap, const float* x,
                           const uint8_t* codes, const float* scale,
                           float* out, int M, int K, int N, int G, int C,
                           cudaStream_t stream) {
  using L = GfLayout<MODE, TMA>;
  const cudaError_t err = allow_smem<gemv_tf32_kernel<MODE, TMA>>(L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + GF_BN - 1) / GF_BN) * C);
  cfg.blockDim = dim3(GF_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // a cluster of one launches as a grid
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, gemv_tf32_kernel<MODE, TMA>, cmap, xmap, smap, x, codes, scale,
      out, M, K, N, G, C);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// C: cluster size (1 to 8, at most the K axis's k8 steps). Code rows of
// N % 16 == 0 bytes and x rows of K % 4 == 0 floats go through TMA, others
// through cp.async.
template <int MODE>
int launch_gemv_tf32(const float* x, const uint8_t* codes,
                     const float* scale, float* out, int M, int K, int N,
                     int G, int C, cudaStream_t stream) {
  if (C < 1 || C > GF_MAX_CLUSTER || C > (K + 7) / 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap cmap = {}, xmap = {}, smap = {};
  if (N % 16 == 0 && K % 4 == 0) {
    if (!hopper::make_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             MODE == kInt4 ? K / 2 : K, N, N,
                             GfLayout<MODE, true>::ROWS, GF_BN,
                             CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hopper::make_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M,
                             K, K, 8, GF_KS, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hopper::make_map_2d(&smap, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             MODE == kInt8Col ? 1 : G, N, N, 1, GF_BN,
                             CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_gemv_tf32_route<MODE, true>(cmap, xmap, smap, x, codes,
                                              scale, out, M, K, N, G, C,
                                              stream);
  }
  return launch_gemv_tf32_route<MODE, false>(cmap, xmap, smap, x, codes,
                                             scale, out, M, K, N, G, C,
                                             stream);
}

template <typename XT, int MODE>
int launch(const void* x, const void* codes, const void* scale, void* out,
           void* work, int M, int K, int N, int G, int splits, int wn,
           cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scale);
  XT* op = static_cast<XT*>(out);
  float* wp = static_cast<float*>(work);
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    if (gemv_tc_route(M, K, N))
      return launch_gemv_tc<MODE>(x, codes, sp, op, M, K, N, G, splits,
                                  stream);
    if (wgmma_route(M, K, N))
      return launch_wgmma<MODE>(x, codes, sp, op, M, K, N, G, stream);
    return launch_ragged<MODE>(x, codes, sp, op, M, K, N, G, splits, wn,
                               stream);
  } else {
    if (M <= DECODE_MAX_ROWS)
      return launch_gemv_tf32<MODE>(xp, cp, sp, op, M, K, N, G, splits,
                                    stream);
    constexpr int bytes = FtLayout<MODE>::BYTES;
    cudaError_t err = allow_smem<fp32_tc_kernel<MODE>>(bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + FT_BN - 1) / FT_BN, (M + FT_BM - 1) / FT_BM,
                    splits);
    fp32_tc_kernel<MODE><<<grid, FT_THREADS, bytes, stream>>>(
        xp, cp, sp, op, wp, M, K, N, G, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(M) * N;
    finalize_kernel<XT, MODE>
        <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
            wp, sp, op, M, N, splits);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename XT>
int launch_mode(int mode, const void* x, const void* codes, const void* scale,
                void* out, void* work, int M, int K, int N, int G, int splits,
                int wn, cudaStream_t s) {
  switch (mode) {
    case kInt8:
      return launch<XT, kInt8>(x, codes, scale, out, work, M, K, N, G, splits,
                               wn, s);
    case kInt4:
      return launch<XT, kInt4>(x, codes, scale, out, work, M, K, N, G, splits,
                               wn, s);
    case kInt8Col:
      return launch<XT, kInt8Col>(x, codes, scale, out, work, M, K, N, 1,
                                  splits, wn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry for ctypes. x [M, K] (x_bf16: bf16, else fp32), codes int8
// [K, N] (modes 0 and 2) or uint8 [K/2, N] (mode 1), scale fp32 [G, N]
// (modes 0, 1) or [N] (mode 2), out [M, N] in x's type, work fp32
// [splits, M, N] (read by fp32 x with M > 8 and splits > 1 only). For bf16
// x, `splits` is the cluster size of the gemv_tc or ragged kernel and `wn`
// the ragged kernel's warps along N (1, 2, 4 or 8); for fp32 x with M <= 8
// it is gemv_tf32_kernel's cluster size, for M > 8 fp32_tc_kernel's K
// splits. G divides K (into even groups for int4); x, the codes and the
// scales are 16-byte aligned. The caller validates shapes.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int quant_matmul(const void* x, const void* codes,
                            const void* scale, void* out, void* work, int M,
                            int K, int N, int G, int mode, int x_bf16,
                            int splits, int wn, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G != 0 || splits <= 0 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kInt4 && (K % 2 != 0 || (K / G) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_mode<__nv_bfloat16>(mode, x, codes, scale, out, work,
                                             M, K, N, G, splits, wn, s)
                : launch_mode<float>(mode, x, codes, scale, out, work, M, K,
                                     N, G, splits, wn, s);
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

// 1 when quant_matmul takes ragged_kernel for these arguments (bf16 x whose
// rows TMA cannot address: K % 8 or N % 16 not 0, any M): `splits` is then
// its cluster size (1 to 8, at most the K axis's k16 steps) and `wn` its
// warps along N.
extern "C" int quant_matmul_ragged_route(int M, int K, int N, int x_bf16) {
  return x_bf16 && !gemv_tc_route(M, K, N) && !wgmma_route(M, K, N) ? 1 : 0;
}
