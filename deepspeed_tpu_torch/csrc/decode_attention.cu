// One-position attention over the contiguous KV cache, hand-written for
// Hopper (sm_90a) as split-key flash-decoding. Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes
// from deepspeed_tpu_torch/ops/decode_attention.py.
//
// Replaces the TPU kernel
//   deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel
// and computes the same function: q [B, H, D] is one new token per row;
// the cache is head-major [B, Hkv, S, D] (bf16/fp32, or int8 with fp32
// scales [B, Hkv, S]); query head kvh*G + g reads kv head kvh. Key j is
// visible iff j <= cache_index, j < S, key_mask[b, j] > 0 and, with a
// window, cache_index - j < window. Softmax runs in fp32; a row that sees
// no key returns zeros, and a masked key's V never reaches a sum.
//
// Bound: bytes. A decode step reads each row's visible K/V (plus scales
// and the mask) once for about 4*G flops per K/V element, far below the
// card's ridge, so the floor is those bytes over 3.35 TB/s, and the aim
// is loads in flight on every SM.
//
// What the design does about it:
// - The key axis is cut into `splits` ranges of whole 64-key tiles, one
//   block per (row, kv head, split) and group chunk: grid (B, Hkv x
//   chunks, splits). A block serves `gb` of the kv head's G query heads
//   (all of them but where G exceeds what one block holds: 16 rows on
//   the single-tile tensor-core kernel, 128 on the multi-tile one, 8 on
//   the CUDA-core kernel), so up to those sizes each K/V tile is read
//   once for the whole group. The wrapper
//   picks the split count from S (the cache's capacity) and the card's SM
//   count, never from cache_index, which stays a device scalar that each
//   block reads: the launch does not depend on its value, so a decode
//   step can be captured in a CUDA graph. A split wholly past
//   cache_index, outside the window or fully masked writes an empty
//   partial (m = -inf, l = 0) and exits; the others walk only their
//   visible tiles.
// - Each split writes an fp32 partial (running max m in log2 units, sum
//   l, unnormalised accumulator) per query head; decode_merge_kernel,
//   launched by the same C call, combines them through their lse in split
//   order (no atomics: bitwise deterministic) and writes zeros for a row
//   no split saw.
// - Inside a split K/V tiles are read as stored (bf16, fp32 or int8) from
//   a 2-stage cp.async ring, with no converted copy.
// - bf16 q over a bf16 cache (the generate path) runs on the tensor
//   cores, mma.sync m16n8k16. A group of at most 16 runs
//   decode_tc_split_kernel: the G query rows padded to one m16 tile; warp
//   w takes keys 16w..16w+15 of every tile with its own running max, sum
//   and accumulator, and the four warps merge at the end. A larger group
//   (Falcon-7B's 71 on one kv head) runs decode_tc_multi_kernel: one warp
//   per m16 tile of query heads (up to 8 warps, 128 heads; a larger group
//   takes more blocks), each walking all 64 keys of every tile, so the
//   K/V tile is read into shared memory once for all of them and no merge
//   between warps is needed. In both, P is split into bf16(P) +
//   bf16(P - bf16(P)) and both halves go through P.V, so the product keeps
//   about 16 bits of P (the plain version multiplies fp32 P); V rows of
//   masked keys are zeroed in shared memory before P.V. exp2 is
//   ex2.approx, with the scale folded into log2 units. Up to D 128 a
//   warp's Q fragments stay in registers for the walk; at D 256 the 16 x
//   256 fp32 accumulator takes 128 registers a lane, so each k-step's Q
//   fragment is read from shared memory. Tiles are bf16 rows swizzled as
//   in tc_common.cuh (D 80 and 96: rows padded to D + 8).
// - fp32 q, or an int8 cache, runs decode_split_kernel on CUDA cores in
//   exact fp32 FMA (the fp32 tolerance is 1e-5): a block serves up to 8
//   query heads; the scores map (query head, key) pairs onto all threads,
//   each reading its key's row from the ring (rows padded by 16 bytes, so
//   8 threads on 8 keys hit distinct banks); P.V gives each thread one
//   column (two at D 256) of up to 8 rows; int8 codes are multiplied by
//   their per-key scale after the dot (K) or before P.V (V). An fp32 tile
//   at D 256 is 66.6 KB, so that instantiation keeps one stage in flight
//   instead of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;       // keys per tile
constexpr int CC_G = 8;      // query heads of one CUDA-core block
constexpr int TC_G = 16;     // query heads of one single-tile block
constexpr int MT_MAX = 8;    // m16 tiles (warps) of one multi-tile block
constexpr int NSTAGE = 2;    // tiles in flight (tensor cores)
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* mask;
  const int* cidx;
  void* out;
  float* part_o;   // [B, H, splits, D] unnormalised accumulators
  float* part_ml;  // [B, H, splits, 2]: m (log2 units), l
  int B, H, Hkv, S, G, window;  // window <= 0: no window
  int gb, nch;                  // query heads a block, blocks a kv head
  int splits, per;              // per: tiles of one split
  float sl2;                    // sm_scale * log2(e)
};

// The block's kv head and its query heads [g0, g0 + gn) of the group
struct Heads {
  int kvh, g0, gn;
};

__device__ __forceinline__ Heads block_heads(const Params& p) {
  Heads h;
  h.kvh = blockIdx.y / p.nch;
  h.g0 = (blockIdx.y % p.nch) * p.gb;
  h.gn = min(p.gb, p.G - h.g0);
  return h;
}

// The split's visible key range [lo, hi] and its tiles [t0, t1); t0 >= t1
// when it sees nothing.
struct Range {
  int lo, hi, t0, t1;
};

__device__ __forceinline__ Range split_range(const Params& p) {
  const int cidx = *p.cidx;
  Range r;
  r.hi = min(cidx, p.S - 1);
  r.lo = p.window > 0 ? max(0, cidx - p.window + 1) : 0;
  const int s = blockIdx.z;
  r.t0 = max(s * p.per, r.lo / BK);
  r.t1 = r.hi >= r.lo ? min((s + 1) * p.per, r.hi / BK + 1) : 0;
  return r;
}

__device__ __forceinline__ size_t part_row(const Params& p, int b, int h) {
  return (static_cast<size_t>(b) * p.H + h) * p.splits + blockIdx.z;
}

// the block's rows of an empty split: m = -inf, l = 0 (the merge skips
// them)
__device__ __forceinline__ void empty_partial(const Params& p, int b,
                                              const Heads& hd) {
  for (int g = threadIdx.x; g < hd.gn; g += blockDim.x) {
    float* ml = p.part_ml + 2 * part_row(p, b, hd.kvh * p.G + hd.g0 + g);
    ml[0] = -INFINITY;
    ml[1] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// CUDA-core split: fp32 q and cache, or an int8 cache
// ---------------------------------------------------------------------------

template <typename KT, int D>
struct Layout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int RS = D * sizeof(KT) + 16;  // padded ring row, bytes
  static constexpr int TILE = BK * RS;
  static constexpr int SCALES = INT8 ? BK * 4 : 0;
  // stage: K tile | V tile | k scales | v scales | mask
  static constexpr int STAGE = 2 * TILE + 2 * SCALES + BK * 4;
  static constexpr int QF = 0;                          // float [CC_G][D]
  static constexpr int SP = QF + CC_G * D * 4;          // float [CC_G][BK]
  static constexpr int MRUN = SP + CC_G * BK * 4;       // float [CC_G]
  static constexpr int LRUN = MRUN + CC_G * 4;          // float [CC_G]
  static constexpr int ALPHA = LRUN + CC_G * 4;         // float [CC_G]
  static constexpr int VALID = ALPHA + CC_G * 4;        // int [BK]
  static constexpr int RING = (VALID + BK * 4 + 15) / 16 * 16;
  // two stages in flight where they fit (all but fp32 at D 256)
  static constexpr int NST = RING + 2 * STAGE <= MAX_SMEM ? 2 : 1;
  static constexpr int BYTES = RING + NST * STAGE;
  static_assert(STAGE % 16 == 0, "stage size must keep alignment");
  static_assert(BYTES <= MAX_SMEM, "shared memory of one block");
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(Params p) {
  using L = Layout<KT, D>;
  constexpr int NST = L::NST;
  // P.V mapping: thread (rgp, c) takes rows rgp + NRG * a of the block's
  // heads and columns c + THREADS * j; threads past NRG row groups idle
  constexpr int NRG = D <= THREADS ? THREADS / D : 1;  // row groups
  constexpr int RPT = (CC_G + NRG - 1) / NRG;          // rows a thread
  constexpr int CPT = (D + THREADS - 1) / THREADS;     // columns a thread

  const int b = blockIdx.x;
  const Heads hd = block_heads(p);
  const int tid = threadIdx.x;
  const int gn = hd.gn;
  const int S = p.S;
  const Range rg = split_range(p);
  if (rg.t0 >= rg.t1) {
    empty_partial(p, b, hd);
    return;
  }
  const int ntiles = rg.t1 - rg.t0;
  const size_t head = static_cast<size_t>(b) * p.Hkv + hd.kvh;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem + L::QF);
  float* sp = reinterpret_cast<float*>(smem + L::SP);
  float* m_run = reinterpret_cast<float*>(smem + L::MRUN);
  float* l_run = reinterpret_cast<float*>(smem + L::LRUN);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);
  unsigned char* ring = smem + L::RING;

  // tile i of the split -> stage i % NST; rows past S read as zeros
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % NST) * L::STAGE;
    const int kv0 = (rg.t0 + i) * BK;
    const size_t row0 = head * S + kv0;
    constexpr int CH = D * sizeof(KT) / 16;  // 16-byte chunks of a row
    const unsigned char* kg =
        static_cast<const unsigned char*>(p.k) + row0 * D * sizeof(KT);
    const unsigned char* vg =
        static_cast<const unsigned char*>(p.v) + row0 * D * sizeof(KT);
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH;
      const int off = r * L::RS + (c % CH) * 16;
      const bool in = kv0 + r < S;
      const size_t src = in ? static_cast<size_t>(c) * 16 : 0;
      cp16(saddr(st + off), kg + src, in);
      cp16(saddr(st + L::TILE + off), vg + src, in);
    }
    unsigned char* tail = st + 2 * L::TILE;
    if (tid < BK) {
      const bool in = kv0 + tid < S;
      if (L::INT8) {
        cp4(saddr(tail + tid * 4), p.ks + row0 + (in ? tid : 0), in);
        cp4(saddr(tail + L::SCALES + tid * 4), p.vs + row0 + (in ? tid : 0),
            in);
      }
      cp4(saddr(tail + 2 * L::SCALES + tid * 4),
          p.mask + static_cast<size_t>(b) * S + kv0 + (in ? tid : 0), in);
    }
  };

  issue(0);
  cp_commit();

  // the block's query rows -> fp32 shared rows
  const QT* q = static_cast<const QT*>(p.q) +
                (static_cast<size_t>(b) * p.H + hd.kvh * p.G + hd.g0) * D;
  for (int e = tid; e < gn * D; e += THREADS) qf[e] = to_float(q[e]);
  if (tid < CC_G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }

  const int c = D <= THREADS ? tid % D : tid;
  const int rgp = D <= THREADS ? tid / D : 0;
  const bool pv = rgp < NRG;  // this thread has P.V columns
  float acc[RPT][CPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[a][j] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if constexpr (NST > 1) {
      if (i + 1 < ntiles) issue(i + 1);
      cp_commit();
      cp_wait<NST - 1>();
    } else {
      if (i > 0) {
        issue(i);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();  // tile i landed

    const unsigned char* st = ring + (i % NST) * L::STAGE;
    const unsigned char* kr = st;
    const unsigned char* vr = st + L::TILE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE);
    const float* vsc = ksc + BK;
    const int* msk =
        reinterpret_cast<const int*>(st + 2 * L::TILE + 2 * L::SCALES);
    const int kv0 = (rg.t0 + i) * BK;
    if (tid < BK) {
      const int key = kv0 + tid;
      valid_s[tid] = key >= rg.lo && key <= rg.hi && msk[tid] > 0;
    }
    __syncthreads();

    // scores in log2 units over (query head, key) pairs; keys that are
    // not visible get -inf
    for (int e = tid; e < gn * BK; e += THREADS) {
      const int g = e / BK;
      const int j = e % BK;
      float s = -INFINITY;
      if (valid_s[j]) {
        const float* qg = qf + g * D;
        float dot = 0.f;
        if (L::INT8) {
          const uint4* k16 = reinterpret_cast<const uint4*>(kr + j * L::RS);
#pragma unroll 4
          for (int d16 = 0; d16 < D / 16; ++d16) {
            const uint4 w = k16[d16];
            const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int t = 0; t < 16; ++t)
              dot = fmaf(qg[16 * d16 + t],
                         static_cast<float>(static_cast<int8_t>(
                             (words[t / 4] >> (8 * (t % 4))) & 0xFF)),
                         dot);
          }
          dot *= ksc[j];
        } else {
          const float4* k4 = reinterpret_cast<const float4*>(kr + j * L::RS);
          const float4* q4 = reinterpret_cast<const float4*>(qg);
#pragma unroll 8
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kx = k4[d4];
            const float4 qx = q4[d4];
            dot = fmaf(qx.x, kx.x, dot);
            dot = fmaf(qx.y, kx.y, dot);
            dot = fmaf(qx.z, kx.z, dot);
            dot = fmaf(qx.w, kx.w, dot);
          }
        }
        s = dot * p.sl2;
      }
      sp[g * BK + j] = s;
    }
    __syncthreads();

    // online softmax: warp w takes rows w and w + 4, a lane two keys
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < gn; g += THREADS / 32) {
        float* srow = sp + g * BK;
        const float s0 = srow[lane];
        const float s1 = srow[lane + 32];
        const float m_old = m_run[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
        const float p0 = s0 == -INFINITY ? 0.f : exp2f(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.f : exp2f(s1 - m_new);
        const float sum = warp_sum(p0 + p1);
        srow[lane] = p0;
        srow[lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          l_run[g] = l_run[g] * alpha + sum;
          m_run[g] = m_new;
          alpha_s[g] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V over the visible keys only
    if (pv) {
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int g = rgp + NRG * a;
        if (g < gn)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[a][j] *= alpha_s[g];
      }
      for (int key = 0; key < BK; ++key) {
        if (!valid_s[key]) continue;  // uniform across the block
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float vx = to_float(
              reinterpret_cast<const KT*>(vr + key * L::RS)[c + THREADS * j]);
          if (L::INT8) vx *= vsc[key];
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const int g = rgp + NRG * a;
            if (g < gn) acc[a][j] = fmaf(sp[g * BK + key], vx, acc[a][j]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_wait<0>();

  if (!pv) return;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int g = rgp + NRG * a;
    if (g >= gn) continue;
    const size_t row = part_row(p, b, hd.kvh * p.G + hd.g0 + g);
#pragma unroll
    for (int j = 0; j < CPT; ++j) p.part_o[row * D + c + THREADS * j] =
        acc[a][j];
    if (c == 0) {
      p.part_ml[2 * row] = m_run[g];
      p.part_ml[2 * row + 1] = l_run[g];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core split: bf16 q over a bf16 cache
// ---------------------------------------------------------------------------

template <int D, int QROWS>
struct TcLayout {
  static constexpr int LD = tile_ld<D>();                // row stride
  static constexpr int TILE = BK * LD * 2;               // bf16, swizzled
  static constexpr int Q = 0;                            // [QROWS][LD] bf16
  static constexpr int RING = Q + QROWS * LD * 2;        // K, V per stage
  static constexpr int MASK = RING + NSTAGE * 2 * TILE;  // int [NSTAGE][BK]
  static constexpr int BYTES = MASK + NSTAGE * BK * 4;
  static_assert(BYTES <= MAX_SMEM, "shared memory of one block");
};

// start copying tile i of the split (K, V, the mask) into stage st; rows
// past S read as zeros. NT: the block's threads, or 0 when only
// blockDim.x knows them.
template <int D, int NT>
__device__ __forceinline__ void tc_issue(const Params& p, bf16_t* ring,
                                         int* mask_s, size_t head, int b,
                                         int kv0, int st) {
  constexpr int LD = tile_ld<D>(), CH = D / 8;
  const int tid = threadIdx.x;
  bf16_t* kt = ring + st * 2 * BK * LD;
  bf16_t* vt = kt + BK * LD;
  const bf16_t* kg = static_cast<const bf16_t*>(p.k) + (head * p.S + kv0) * D;
  const bf16_t* vg = static_cast<const bf16_t*>(p.v) + (head * p.S + kv0) * D;
  auto copy = [&](int c) {
    const int r = c / CH;
    const bool in = kv0 + r < p.S;
    const size_t src = in ? static_cast<size_t>(r) * D + (c % CH) * 8 : 0;
    cp16(saddr(kt + swz<D>(r, c % CH)), kg + src, in);
    cp16(saddr(vt + swz<D>(r, c % CH)), vg + src, in);
  };
  if constexpr (NT > 0 && BK * CH % (NT > 0 ? NT : 1) == 0) {
#pragma unroll
    for (int x = 0; x < BK * CH / NT; ++x) copy(tid + x * NT);
  } else {
    for (int c = tid; c < BK * CH; c += blockDim.x) copy(c);
  }
  if (tid < BK) {
    const bool in = kv0 + tid < p.S;
    cp4(saddr(mask_s + st * BK + tid),
        p.mask + static_cast<size_t>(b) * p.S + kv0 + (in ? tid : 0), in);
  }
}

// the block's query rows into a swizzled [rows][LD] tile, rows at or past
// its gn heads zero-filled
template <int D>
__device__ __forceinline__ void tc_load_q(const Params& p, bf16_t* qs, int b,
                                          const Heads& hd, int rows) {
  constexpr int CH = D / 8;
  const bf16_t* q = static_cast<const bf16_t*>(p.q) +
                    (static_cast<size_t>(b) * p.H + hd.kvh * p.G + hd.g0) * D;
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH;
    cp16(saddr(qs + swz<D>(r, c % CH)),
         q + (r < hd.gn ? static_cast<size_t>(r) * D + (c % CH) * 8 : 0),
         r < hd.gn);
  }
}

// the A fragment of k-step kk of the 16 query rows at r0: from the
// registers loaded at the walk's start (QREG) or from shared memory
template <int D, bool QREG, int KT>
__device__ __forceinline__ void q_frag(uint32_t (&a)[4],
                                       const uint32_t (&qf)[QREG ? KT : 1][4],
                                       const bf16_t* qs, int r0, int kk,
                                       int lane) {
  if constexpr (QREG) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
  } else {
    ldsm(a, a_addr<D>(qs, r0, kk, lane));
  }
}

// a group of at most 16 query heads: one m16 tile, warp w on keys
// 16w..16w+15 of each tile, the four warps merged at the end
template <int D>
__global__ void __launch_bounds__(THREADS) decode_tc_split_kernel(Params p) {
  using L = TcLayout<D, TC_G>;
  constexpr int KT = D / 16;  // k-steps of q . k
  constexpr int ND = D / 8;   // n8 tiles of the accumulator
  constexpr int LD = L::LD, CH = D / 8;
  constexpr bool QREG = D <= 128;
  // after the walk the ring holds the warps' partials: o [4][TC_G][D],
  // then m and l [4][TC_G] each
  static_assert(4 * TC_G * D * 4 + 2 * 4 * TC_G * 4 <= NSTAGE * 2 * L::TILE,
                "partials fit in the ring");

  const int b = blockIdx.x;
  const Heads hd = block_heads(p);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gn = hd.gn;
  const Range rg = split_range(p);
  if (rg.t0 >= rg.t1) {
    empty_partial(p, b, hd);
    return;
  }
  const int ntiles = rg.t1 - rg.t0;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem + L::Q);
  bf16_t* ring = reinterpret_cast<bf16_t*>(tc_smem + L::RING);
  int* mask_s = reinterpret_cast<int*>(tc_smem + L::MASK);
  const size_t head = static_cast<size_t>(b) * p.Hkv + hd.kvh;

  tc_load_q<D>(p, qs, b, hd, 16);
  tc_issue<D, THREADS>(p, ring, mask_s, head, b, rg.t0 * BK, 0);
  cp_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[QREG ? KT : 1][4];

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles)
      tc_issue<D, THREADS>(p, ring, mask_s, head, b, (rg.t0 + i + 1) * BK,
                           (i + 1) % NSTAGE);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile i (and q) landed
    if constexpr (QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm(qf[kk], a_addr<D>(qs, 0, kk, lane));
      }
    }
    const int st = i % NSTAGE;
    bf16_t* kt = ring + st * 2 * BK * LD;
    bf16_t* vt = kt + BK * LD;
    const int kv0 = (rg.t0 + i) * BK;
    const int r0 = warp * 16;  // this warp's 16 keys of the tile
    const int key = kv0 + r0 + (lane & 15);
    const bool ok =
        key >= rg.lo && key <= rg.hi && mask_s[st * BK + r0 + (lane & 15)] > 0;
    const uint32_t bits = __ballot_sync(~0u, ok) & 0xFFFFu;
    if (bits != 0) {
      if (bits != 0xFFFFu) {
        // zero the V rows of masked keys: their V never reaches a sum
        for (int c = lane; c < 16 * CH; c += 32) {
          const int r = c / CH;
          if (!((bits >> r) & 1))
            *reinterpret_cast<uint4*>(vt + swz<D>(r0 + r, c % CH)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t qa[4], kb[4];
        q_frag<D, QREG, KT>(qa, qf, qs, 0, kk, lane);
        ldsm(kb, b_addr<D>(kt, r0, kk, lane));
        mma(s[0], qa, kb[0], kb[1]);
        mma(s[1], qa, kb[2], kb[3]);
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * (lane & 3) + (e & 1);
          const float x = (bits >> col) & 1 ? s[j][e] * p.sl2 : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
        const float base = mx[h] == -INFINITY ? 0.f : mx[h];
        const float alpha = ex2(m_run[h] - base);
        m_run[h] = mx[h];
        l_run[h] *= alpha;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][2 * h] *= alpha;
          o[d][2 * h + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[j][e] = ex2(s[j][e] - base);
            l_run[h] += s[j][e];
          }
      }
      // P = hi + lo, both bf16: P.V keeps ~16 bits of P
      float lo[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[j][e] = s[j][e] - __bfloat162float(__float2bfloat16(s[j][e]));
      uint32_t ahi[4], alo[4];
      c_to_a(ahi, s[0], s[1]);
      c_to_a(alo, lo[0], lo[1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t vb[4];
        ldsm_t(vb, bt_addr<D>(vt, r0, dj, lane));
        mma(o[2 * dj], ahi, vb[0], vb[1]);
        mma(o[2 * dj + 1], ahi, vb[2], vb[3]);
        mma(o[2 * dj], alo, vb[0], vb[1]);
        mma(o[2 * dj + 1], alo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_wait<0>();
  __syncthreads();

  // the four warps' partials -> shared memory (rows < gn), then one block
  // partial per query head
  float* po = reinterpret_cast<float*>(ring);  // [4][TC_G][D]
  float* pm = po + 4 * TC_G * D;               // [4][TC_G]
  float* pl = pm + 4 * TC_G;                   // [4][TC_G]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int g = (lane >> 2) + 8 * h;
    if (g >= gn) continue;
    if ((lane & 3) == 0) {
      pm[warp * TC_G + g] = m_run[h];
      pl[warp * TC_G + g] = l;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * (lane & 3);
      po[(warp * TC_G + g) * D + col] = o[d][2 * h];
      po[(warp * TC_G + g) * D + col + 1] = o[d][2 * h + 1];
    }
  }
  __syncthreads();
  for (int e = tid; e < gn * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, pm[w * TC_G + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = pm[w * TC_G + g];
        if (mw == -INFINITY) continue;
        const float a = ex2(mw - m);
        acc += a * po[(w * TC_G + g) * D + d];
        l += a * pl[w * TC_G + g];
      }
    }
    const size_t row = part_row(p, b, hd.kvh * p.G + hd.g0 + g);
    p.part_o[row * D + d] = acc;
    if (d == 0) {
      p.part_ml[2 * row] = m;
      p.part_ml[2 * row + 1] = l;
    }
  }
}

// a group of more than 16 query heads: warp w takes the m16 tile of heads
// 16w..16w+15 of the block's and walks all 64 keys of every tile, so each
// K/V tile lands in shared memory once for every warp; no merge between
// warps. blockDim.x = 32 x the block's m16 tiles (at most MT_MAX).
template <int D>
__global__ void __launch_bounds__(32 * MT_MAX)
    decode_tc_multi_kernel(Params p) {
  using L = TcLayout<D, 16 * MT_MAX>;
  constexpr int KT = D / 16, ND = D / 8, NS = BK / 8;
  constexpr int LD = L::LD, CH = D / 8;
  constexpr bool QREG = D <= 128;

  const int b = blockIdx.x;
  const Heads hd = block_heads(p);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Range rg = split_range(p);
  if (rg.t0 >= rg.t1) {
    empty_partial(p, b, hd);
    return;
  }
  const int ntiles = rg.t1 - rg.t0;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem + L::Q);
  bf16_t* ring = reinterpret_cast<bf16_t*>(tc_smem + L::RING);
  int* mask_s = reinterpret_cast<int*>(tc_smem + L::MASK);
  const size_t head = static_cast<size_t>(b) * p.Hkv + hd.kvh;
  const int r0q = warp * 16;  // this warp's query rows

  tc_load_q<D>(p, qs, b, hd, nt / 2);
  tc_issue<D, 0>(p, ring, mask_s, head, b, rg.t0 * BK, 0);
  cp_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[QREG ? KT : 1][4];

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles)
      tc_issue<D, 0>(p, ring, mask_s, head, b, (rg.t0 + i + 1) * BK,
                     (i + 1) % NSTAGE);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile i (and q) landed
    if constexpr (QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm(qf[kk], a_addr<D>(qs, r0q, kk, lane));
      }
    }
    const int st = i % NSTAGE;
    bf16_t* kt = ring + st * 2 * BK * LD;
    bf16_t* vt = kt + BK * LD;
    const int kv0 = (rg.t0 + i) * BK;
    // the tile's visible keys, one bit a key; the same in every warp
    const int* ms = mask_s + st * BK;
    auto visible = [&](int j) {
      const int key = kv0 + j;
      return key >= rg.lo && key <= rg.hi && ms[j] > 0;
    };
    const uint64_t bits =
        __ballot_sync(~0u, visible(lane)) |
        (static_cast<uint64_t>(__ballot_sync(~0u, visible(lane + 32))) << 32);
    if (bits != 0) {
      if (bits != ~0ull) {
        // zero the V rows of masked keys, all warps together
        for (int c = tid; c < BK * CH; c += nt) {
          const int r = c / CH;
          if (!((bits >> r) & 1))
            *reinterpret_cast<uint4*>(vt + swz<D>(r, c % CH)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
      }
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t qa[4];
        q_frag<D, QREG, KT>(qa, qf, qs, r0q, kk, lane);
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          uint32_t kb[4];
          ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
          mma(s[2 * nj], qa, kb[0], kb[1]);
          mma(s[2 * nj + 1], qa, kb[2], kb[3]);
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * (lane & 3) + (e & 1);
          const float x = (bits >> col) & 1 ? s[j][e] * p.sl2 : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
        const float base = mx[h] == -INFINITY ? 0.f : mx[h];
        const float alpha = ex2(m_run[h] - base);
        m_run[h] = mx[h];
        l_run[h] *= alpha;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][2 * h] *= alpha;
          o[d][2 * h + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[j][e] = ex2(s[j][e] - base);
            l_run[h] += s[j][e];
          }
      }
      // P = hi + lo, both bf16, one k-step of 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        float lo[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            lo[j][e] = s[2 * kk + j][e] -
                       __bfloat162float(__float2bfloat16(s[2 * kk + j][e]));
        uint32_t ahi[4], alo[4];
        c_to_a(ahi, s[2 * kk], s[2 * kk + 1]);
        c_to_a(alo, lo[0], lo[1]);
#pragma unroll
        for (int dj = 0; dj < ND / 2; ++dj) {
          uint32_t vb[4];
          ldsm_t(vb, bt_addr<D>(vt, kk * 16, dj, lane));
          mma(o[2 * dj], ahi, vb[0], vb[1]);
          mma(o[2 * dj + 1], ahi, vb[2], vb[3]);
          mma(o[2 * dj], alo, vb[0], vb[1]);
          mma(o[2 * dj + 1], alo, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_wait<0>();

  // this warp's rows (those < gn) are the block's partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int g = r0q + (lane >> 2) + 8 * h;
    if (g >= hd.gn) continue;
    const size_t row = part_row(p, b, hd.kvh * p.G + hd.g0 + g);
    if ((lane & 3) == 0) {
      p.part_ml[2 * row] = m_run[h];
      p.part_ml[2 * row + 1] = l;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p.part_o + row * D + col) =
          make_float2(o[d][2 * h], o[d][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// merge: out[b, h] = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s
// ---------------------------------------------------------------------------

template <typename QT>
__global__ void __launch_bounds__(MERGE_THREADS) decode_merge_kernel(
    Params p, int D) {
  const size_t row = blockIdx.x;  // b * H + h
  const float* ml = p.part_ml + 2 * row * p.splits;
  const float* po = p.part_o + row * p.splits * D;
  float m = -INFINITY;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  if (m != -INFINITY)
    for (int s = 0; s < p.splits; ++s)
      if (ml[2 * s] != -INFINITY) l += ml[2 * s + 1] * exp2f(ml[2 * s] - m);
  const float inv = l == 0.f ? 0.f : 1.f / l;
  QT* out = static_cast<QT*>(p.out) + row * D;
  for (int d = threadIdx.x; d < D; d += MERGE_THREADS) {
    float acc = 0.f;
    if (m != -INFINITY)
      for (int s = 0; s < p.splits; ++s)
        if (ml[2 * s] != -INFINITY)
          acc += po[static_cast<size_t>(s) * D + d] * exp2f(ml[2 * s] - m);
    store(out + d, acc * inv);
  }
}

template <void (*K)(Params)>
cudaError_t run(const Params& p, int threads, int bytes,
                cudaStream_t stream) {
  if (p.Hkv > 65535 / p.nch) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<K>(bytes);
  if (err != cudaSuccess) return err;
  K<<<dim3(p.B, p.Hkv * p.nch, p.splits), threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// p with the group cut into the fewest blocks of at most `most` heads
Params chunked(Params p, int most) {
  p.nch = (p.G + most - 1) / most;
  p.gb = (p.G + p.nch - 1) / p.nch;
  return p;
}

template <typename QT, typename KT, int D>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(QT) == 2 && sizeof(KT) == 2) {
    if (p.G <= TC_G)
      return run<decode_tc_split_kernel<D>>(chunked(p, TC_G), THREADS,
                                            TcLayout<D, TC_G>::BYTES, stream);
    const Params c = chunked(p, 16 * MT_MAX);
    return run<decode_tc_multi_kernel<D>>(
        c, 32 * ((c.gb + 15) / 16), TcLayout<D, 16 * MT_MAX>::BYTES, stream);
  } else {
    return run<decode_split_kernel<QT, KT, D>>(chunked(p, CC_G), THREADS,
                                               Layout<KT, D>::BYTES, stream);
  }
}

template <typename QT, typename KT>
cudaError_t launch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_split<QT, KT, 64>(p, stream);
    case 80: return launch_split<QT, KT, 80>(p, stream);
    case 96: return launch_split<QT, KT, 96>(p, stream);
    case 128: return launch_split<QT, KT, 128>(p, stream);
    case 256: return launch_split<QT, KT, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
int launch(const Params& p, int kv_int8, int D, cudaStream_t stream) {
  const cudaError_t err = kv_int8 ? launch_d<QT, int8_t>(p, D, stream)
                                  : launch_d<QT, QT>(p, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<QT><<<p.B * p.H, MERGE_THREADS, 0, stream>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. q/out: [B, H, D] (q_bf16: bf16, else fp32); k/v
// caches [B, Hkv, S, D] in q's type, or int8 with fp32 scales [B, Hkv, S]
// (kv_int8); key_mask int32 [B, S]; cache_index int32 [1] on the device;
// window <= 0: none; D is 64, 80, 96, 128 or 256, and Hkv divides H (any
// group). The key axis is cut into `splits` ranges of whole 64-key tiles
// (the wrapper derives the count from S and the card); scratch is fp32
// [B * H * splits * (D + 2)]. The caller validates shapes. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* key_mask,
                                const void* cache_index, void* out,
                                void* scratch, int B, int H, int Hkv, int S,
                                int D, float sm_scale, int window, int q_bf16,
                                int kv_int8, int splits, void* stream) {
  const int tiles = (S + BK - 1) / BK;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 2147483647 / H ||
      Hkv > 65535 || splits <= 0 || splits > tiles || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.mask = static_cast<const int*>(key_mask);
  p.cidx = static_cast<const int*>(cache_index);
  p.out = out;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = p.part_o + static_cast<size_t>(B) * H * splits * D;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.G = H / Hkv;
  p.gb = p.G;
  p.nch = 1;
  p.window = window;
  p.splits = splits;
  p.per = (tiles + splits - 1) / splits;
  p.sl2 = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch<__nv_bfloat16>(p, kv_int8, D, s)
                : launch<float>(p, kv_int8, D, s);
}
