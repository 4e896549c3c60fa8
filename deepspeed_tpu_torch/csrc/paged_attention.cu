// Paged decode attention and paged chunked-prefill attention for the
// two-program serving engine, hand-written for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes from
// deepspeed_tpu_torch/ops/decode_attention.py.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/pallas/decode_attention.py::_paged_decode_kernel
//   deepspeed_tpu/ops/pallas/decode_attention.py::_paged_prefill_kernel
// and computes the same two functions over a paged pool k/v [N, Hkv, 16, D]
// (bf16/fp32, or int8 with fp32 scales [N, Hkv, 16]) addressed through
// block_tables [B, nb] (an entry outside [0, N) is unallocated and is
// clamped to page N - 1, whose contents the length mask hides):
//
// - paged_decode_kernel: q [B, H, D], one new token per sequence sitting at
//   context_lens[b] - 1. Key p is visible iff p < context_lens[b] and, with
//   a window, context_lens[b] - 1 - p < window.
// - paged_prefill_kernel: q [B, T, H, D], one prefill chunk per sequence.
//   Row t sits at chunk_start[b] + t and sees keys p <= its position with
//   p < context_lens[b] and, with a window, position - p < window; rows at
//   or past context_lens[b] (the chunk's padded tail) return zeros.
//
// Query head kvh * G + g reads kv head kvh. Softmax runs in fp32; a row
// that sees no key returns zeros. block_tables, chunk_start and
// context_lens are read on the device, so no launch parameter depends on
// them (the TPU kernels prefetch them as scalars).
//
// Bound: bytes. Each visible K/V page (and its scales) is read once per kv
// head for a few FLOP per element, far below the card's ridge, so the floor
// is (visible pages + q + out) / 3.35 TB/s.
//
// What the design does about it:
// - the TPU grid's sequential page axis, its "revisit the last page" DMA
//   trick and its m/l/acc scratch become a loop over the visible pages
//   inside one block, with the running max, sum and accumulators on chip;
// - decode: one block per (sequence, kv head) walks 64-key tiles (four
//   pages gathered through the table) from the window's first page to the
//   page of context_len - 1, through a 2-stage cp.async ring (eight pages
//   in flight); the G query heads share every page;
// - prefill: one block per (tile of 32 / G chunk rows, sequence, kv head)
//   walks single pages through a 4-stage cp.async ring, from the first page
//   its first row's window can see to the page of its last row's position;
//   tiles past the chunk's valid length exit at once (the caller zeroes the
//   output);
// - an int8 pool is read as int8 and dequantized in shared memory;
// - keys under the mask are never summed into P.V (decode: their V is
//   zeroed and skipped; prefill: their probability is exactly 0 and pool
//   pages only ever hold finite values), so a recycled page's tail, which
//   holds another sequence's valid KV, cannot leak.
// Compute is fp32 FMA on CUDA cores (no wgmma/TMA yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;        // tokens per KV page
constexpr int THREADS = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* cs;  // prefill only
  const int* cl;
  void* out;
  int B, T, H, Hkv, N, nb, G, q_tile, window;  // window <= 0: no window
  float sm_scale;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// the pool page behind table entry `page` of sequence b; unallocated
// entries clamp to the last page (hidden by the length mask)
__device__ __forceinline__ int page_id(const Params& p, int b, int page) {
  int pid = p.bt[b * p.nb + page];
  if (pid < 0 || pid >= p.N) pid = p.N - 1;
  return pid;
}

// ---------------------------------------------------------------------------
// paged decode: one query token per sequence
// ---------------------------------------------------------------------------

constexpr int BK = 64;            // keys per tile
constexpr int PPT = BK / BS;      // pages per tile
constexpr int MAXG = 8;           // query heads per kv head
constexpr int DSTAGE = 2;         // tiles in flight

template <typename KT, int D>
struct DecodeLayout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int DP = D + 4;  // padded fp32 row: float4 reads by 8
                                    // threads on 8 rows hit distinct banks
  static constexpr int PAGE_BYTES = BS * D * sizeof(KT);
  static constexpr int TILE_BYTES = PPT * PAGE_BYTES;
  static constexpr int SCALE_BYTES = INT8 ? BK * 4 : 0;
  // stage: K tile | V tile | k scales | v scales
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * SCALE_BYTES;
  static constexpr int QF = 0;                           // float [MAXG][DP]
  static constexpr int KF = QF + MAXG * DP * 4;          // float [BK][DP]
  static constexpr int VF = KF + BK * DP * 4;            // float [BK][D]
  static constexpr int SP = VF + BK * D * 4;             // float [MAXG][BK+1]
  static constexpr int MRUN = SP + MAXG * (BK + 1) * 4;  // float [MAXG]
  static constexpr int LRUN = MRUN + MAXG * 4;           // float [MAXG]
  static constexpr int ALPHA = LRUN + MAXG * 4;          // float [MAXG]
  static constexpr int VALID = ALPHA + MAXG * 4;         // int [BK]
  static constexpr int RING = (VALID + BK * 4 + 15) / 16 * 16;
  static constexpr int BYTES = RING + DSTAGE * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0, "stage size must keep alignment");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Params p) {
  using L = DecodeLayout<KT, D>;
  constexpr int DP = L::DP;
  constexpr int NRG = THREADS / D;    // row groups in P.V (1 or 2)
  constexpr int RPT = MAXG / NRG;     // rows per thread in P.V
  constexpr int SRG = THREADS / BK;   // row groups in the scores (2)
  constexpr int CH = L::PAGE_BYTES / 16;  // 16-byte chunks per page

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = p.G;
  const int clen = p.cl[b];
  // keys [lo, hi] are visible: below the context length (and inside what
  // the table can address), inside the window of the query at clen - 1
  const int hi = min(clen, p.nb * BS) - 1;
  const int lo = p.window > 0 ? max(0, clen - p.window) : 0;
  const int tile_lo = lo / BK;
  const int ntiles = hi >= lo ? hi / BK - tile_lo + 1 : 0;
  const int page_hi = hi >= 0 ? hi / BS : -1;  // last page holding a key

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem + L::QF);
  float* kf = reinterpret_cast<float*>(smem + L::KF);
  float* vf = reinterpret_cast<float*>(smem + L::VF);
  float* sp = reinterpret_cast<float*>(smem + L::SP);
  float* m_run = reinterpret_cast<float*>(smem + L::MRUN);
  float* l_run = reinterpret_cast<float*>(smem + L::LRUN);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);
  unsigned char* ring = smem + L::RING;

  // tile i = the four pages from table entry (tile_lo + i) * PPT on; pages
  // past page_hi hold no visible key and are not loaded (nor ever read)
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % DSTAGE) * L::STAGE_BYTES;
    const int page0 = (tile_lo + i) * PPT;
    for (int c = tid; c < PPT * CH; c += THREADS) {
      const int pg = c / CH;
      if (page0 + pg > page_hi) break;  // c grows with pg
      const size_t page =
          static_cast<size_t>(page_id(p, b, page0 + pg)) * p.Hkv + kvh;
      const int cc = c % CH;
      cp_async16(st + pg * L::PAGE_BYTES + cc * 16,
                 static_cast<const unsigned char*>(p.k) +
                     page * L::PAGE_BYTES + cc * 16);
      cp_async16(st + L::TILE_BYTES + pg * L::PAGE_BYTES + cc * 16,
                 static_cast<const unsigned char*>(p.v) +
                     page * L::PAGE_BYTES + cc * 16);
    }
    if (L::INT8 && tid < BK && page0 + tid / BS <= page_hi) {
      const size_t page =
          static_cast<size_t>(page_id(p, b, page0 + tid / BS)) * p.Hkv + kvh;
      unsigned char* tail = st + 2 * L::TILE_BYTES;
      cp_async4(tail + tid * 4, p.ks + page * BS + tid % BS);
      cp_async4(tail + L::SCALE_BYTES + tid * 4, p.vs + page * BS + tid % BS);
    }
  };

  if (ntiles > 0) issue(0);
  cp_async_commit();

  // the G query rows of this kv head -> fp32 shared rows
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < MAXG * D; e += THREADS) {
    const int g = e / D;
    const int c = e % D;
    qf[g * DP + c] =
        g < G ? to_float(q[(static_cast<size_t>(b) * p.H + kvh * G + g) * D + c])
              : 0.f;
  }
  if (tid < MAXG) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }

  // P.V mapping: column c for rows rg + NRG * i
  const int c = tid % D;
  const int rg = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  // score mapping: key j for rows sr + SRG * i
  const int j = tid % BK;
  const int sr = tid / BK;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<DSTAGE - 1>();
    __syncthreads();  // tile i landed; the last tile's P.V is done

    const unsigned char* st = ring + (i % DSTAGE) * L::STAGE_BYTES;
    const KT* kr = reinterpret_cast<const KT*>(st);
    const KT* vr = reinterpret_cast<const KT*>(st + L::TILE_BYTES);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE_BYTES);
    const float* vsc = ksc + BK;
    const int kv0 = (tile_lo + i) * BK;
    if (tid < BK) {
      const int key = kv0 + tid;
      valid_s[tid] = key >= lo && key <= hi;
    }
    __syncthreads();

    // raw tile -> fp32 K/V rows (int8: times the per-key scale); keys that
    // are not visible become zeros and are never read from the ring
    for (int e = tid; e < BK * D; e += THREADS) {
      const int key = e / D;
      const int col = e % D;
      float kx = 0.f, vx = 0.f;
      if (valid_s[key]) {
        kx = to_float(kr[e]);
        vx = to_float(vr[e]);
        if (L::INT8) {
          kx *= ksc[key];
          vx *= vsc[key];
        }
      }
      kf[key * DP + col] = kx;
      vf[key * D + col] = vx;
    }
    __syncthreads();

    // masked scores S = (q . k) * sm_scale
    {
      float s[MAXG / SRG];
#pragma unroll
      for (int a = 0; a < MAXG / SRG; ++a) s[a] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(kf + j * DP);
#pragma unroll 4
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kx = k4[d4];
#pragma unroll
        for (int a = 0; a < MAXG / SRG; ++a) {
          const int g = sr + SRG * a;
          if (g < G) {
            const float4 qx = reinterpret_cast<const float4*>(qf + g * DP)[d4];
            s[a] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
          }
        }
      }
      const bool ok = valid_s[j];
#pragma unroll
      for (int a = 0; a < MAXG / SRG; ++a) {
        const int g = sr + SRG * a;
        if (g < G) sp[g * (BK + 1) + j] = ok ? s[a] * p.sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w and w + 4, a lane two keys
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < G; g += THREADS / 32) {
        float* srow = sp + g * (BK + 1);
        const float s0 = srow[lane];
        const float s1 = srow[lane + 32];
        const float m_old = m_run[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
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
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int g = rg + NRG * a;
      if (g < G) acc[a] *= alpha_s[g];
    }
    for (int key = 0; key < BK; ++key) {
      if (!valid_s[key]) continue;  // uniform across the block
      const float vx = vf[key * D + c];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int g = rg + NRG * a;
        if (g < G) acc[a] += sp[g * (BK + 1) + key] * vx;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  QT* out = static_cast<QT*>(p.out);
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int g = rg + NRG * a;
    if (g >= G) continue;
    const float l = l_run[g];
    const float l_safe = l == 0.f ? 1.f : l;
    store(out + (static_cast<size_t>(b) * p.H + kvh * G + g) * D + c,
          acc[a] / l_safe);
  }
}

// ---------------------------------------------------------------------------
// paged chunked prefill: a chunk of T query tokens per sequence
// ---------------------------------------------------------------------------

constexpr int M = 32;        // query rows per block: q_tile tokens x G heads
constexpr int PSTAGE = 4;    // pages in flight

template <typename KT, int D>
struct PrefillLayout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int DP = D + 4;
  static constexpr int PAGE_BYTES = BS * D * sizeof(KT);
  static constexpr int SCALE_BYTES = INT8 ? BS * 4 : 0;
  static constexpr int STAGE_BYTES = 2 * PAGE_BYTES + 2 * SCALE_BYTES;
  static constexpr int QF = 0;                        // float [M][DP]
  static constexpr int KF = QF + M * DP * 4;          // float [BS][DP]
  static constexpr int VF = KF + BS * DP * 4;         // float [BS][D]
  static constexpr int SP = VF + BS * D * 4;          // float [M][BS + 1]
  static constexpr int ALPHA = SP + M * (BS + 1) * 4;  // float [M]
  static constexpr int LSUM = ALPHA + M * 4;          // float [M]
  static constexpr int RING = LSUM + M * 4;           // PSTAGE stages
  static constexpr int BYTES = RING + PSTAGE * STAGE_BYTES;
  static_assert(RING % 16 == 0, "cp.async destinations need 16B alignment");
  static_assert(STAGE_BYTES % 16 == 0, "stage size must keep alignment");
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(Params p) {
  using L = PrefillLayout<KT, D>;
  constexpr int DP = L::DP;
  constexpr int CPT = D / 64;  // float4 column groups per thread in P.V

  const int it = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = blockIdx.z;
  const int clen = p.cl[b];
  const int cs = p.cs[b];
  // rows at or past the context length are the chunk's padding: zeros
  const int ql = min(p.T, clen - cs);
  const int tok0 = it * p.q_tile;
  if (tok0 >= ql || clen <= 0) return;  // dead tile: output stays zero
  const int n_tok = min(p.q_tile, ql - tok0);
  const int m_live = n_tok * p.G;

  // pages the tile can see: causal end at its last row, window start at
  // its first row
  const int kv_end = min(clen, cs + tok0 + n_tok);
  const int page_hi = min((kv_end + BS - 1) / BS, p.nb);
  const int page_lo =
      p.window > 0 ? max(0, cs + tok0 - p.window + 1) / BS : 0;
  const int npages = max(0, page_hi - page_lo);

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem + L::QF);
  float* kf = reinterpret_cast<float*>(smem + L::KF);
  float* vf = reinterpret_cast<float*>(smem + L::VF);
  float* sp = reinterpret_cast<float*>(smem + L::SP);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  float* l_s = reinterpret_cast<float*>(smem + L::LSUM);
  unsigned char* ring = smem + L::RING;
  const int tid = threadIdx.x;

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % PSTAGE) * L::STAGE_BYTES;
    const size_t page =
        static_cast<size_t>(page_id(p, b, page_lo + i)) * p.Hkv + kvh;
    const unsigned char* kg =
        static_cast<const unsigned char*>(p.k) + page * L::PAGE_BYTES;
    const unsigned char* vg =
        static_cast<const unsigned char*>(p.v) + page * L::PAGE_BYTES;
    for (int c = tid; c < L::PAGE_BYTES / 16; c += THREADS) {
      cp_async16(st + c * 16, kg + c * 16);
      cp_async16(st + L::PAGE_BYTES + c * 16, vg + c * 16);
    }
    if (L::INT8 && tid < 2 * (BS * 4 / 16)) {
      const int half = BS * 4 / 16;  // 16-byte chunks per scale row
      const float* src = tid < half ? p.ks : p.vs;
      const int c = tid % half;
      cp_async16(st + 2 * L::PAGE_BYTES + (tid / half) * L::SCALE_BYTES +
                     c * 16,
                 reinterpret_cast<const unsigned char*>(src + page * BS) +
                     c * 16);
    }
  };

  // prologue: the first PSTAGE - 1 pages start loading before q does
  for (int s = 0; s < PSTAGE - 1; ++s) {
    if (s < npages) issue(s);
    cp_async_commit();
  }

  // q tile -> fp32 shared rows; row j is chunk token tok0 + j / G, head
  // kvh * G + j % G (the [T * G, D] rows of the TPU kernel)
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < M * D; e += THREADS) {
    const int row = e / D;
    const int c = e % D;
    float x = 0.f;
    if (row < m_live) {
      const size_t tok = static_cast<size_t>(b) * p.T + tok0 + row / p.G;
      const int head = kvh * p.G + row % p.G;
      x = to_float(q[(tok * p.H + head) * D + c]);
    }
    qf[row * DP + c] = x;
  }

  // score mapping: 2 rows x 2 keys per thread; P.V mapping: 4 rows x
  // CPT float4 column groups per thread, accumulators in registers
  const int rp = tid >> 3;  // rows 2rp, 2rp + 1
  const int kp = tid & 7;   // keys kp, kp + 8
  const int rg = tid >> 4;  // rows 4rg .. 4rg + 3
  const int cg = tid & 15;  // float4 columns cg + 16 * jj
  float acc[4][4 * CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4 * CPT; ++bb) acc[a][bb] = 0.f;
  float m_run = -INFINITY;  // row tid's running max (warp 0 only)
  float l_run = 0.f;        // row tid's running sum (warp 0 only)

  for (int i = 0; i < npages; ++i) {
    if (i + PSTAGE - 1 < npages) issue(i + PSTAGE - 1);
    cp_async_commit();
    cp_async_wait<PSTAGE - 1>();
    __syncthreads();  // page i landed; last page's P.V is done with vf

    // raw page -> fp32 K/V rows (int8: times the per-token scale)
    const unsigned char* st = ring + (i % PSTAGE) * L::STAGE_BYTES;
    const KT* kr = reinterpret_cast<const KT*>(st);
    const KT* vr = reinterpret_cast<const KT*>(st + L::PAGE_BYTES);
    const float* ksc =
        reinterpret_cast<const float*>(st + 2 * L::PAGE_BYTES);
    const float* vsc = ksc + BS;
    for (int e = tid; e < BS * D; e += THREADS) {
      const int j = e / D;
      const int c = e % D;
      float kx = to_float(kr[e]);
      float vx = to_float(vr[e]);
      if (L::INT8) {
        kx *= ksc[j];
        vx *= vsc[j];
      }
      kf[j * DP + c] = kx;
      vf[j * D + c] = vx;
    }
    __syncthreads();

    // masked scores S = (q . k) * sm_scale
    const int kv0 = (page_lo + i) * BS;
    if (2 * rp < m_live) {
      const float4* q0 = reinterpret_cast<const float4*>(qf + 2 * rp * DP);
      const float4* q1 = q0 + DP / 4;
      const float4* k0 = reinterpret_cast<const float4*>(kf + kp * DP);
      const float4* k1 = reinterpret_cast<const float4*>(kf + (kp + 8) * DP);
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = q0[d4], bq = q1[d4], x = k0[d4], y = k1[d4];
        s[0][0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
        s[0][1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
        s[1][0] += bq.x * x.x + bq.y * x.y + bq.z * x.z + bq.w * x.w;
        s[1][1] += bq.x * y.x + bq.y * y.y + bq.z * y.z + bq.w * y.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int row = 2 * rp + a;
        const int pos = cs + tok0 + row / p.G;
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int key = kp + 8 * bb;
          const int col = kv0 + key;
          const bool valid = row < m_live && col <= pos && col < clen &&
                             (p.window <= 0 || pos - col < p.window);
          sp[row * (BS + 1) + key] =
              valid ? s[a][bb] * p.sm_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one lane of warp 0 per query row
    if (tid < m_live) {
      float* srow = sp + tid * (BS + 1);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BS; ++j) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_run, mx);
      const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const float pj = srow[j] == -INFINITY ? 0.f : expf(srow[j] - m_new);
        srow[j] = pj;
        sum += pj;
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    if (4 * rg < m_live) {
      float al[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) al[a] = alpha_s[4 * rg + a];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4 * CPT; ++bb) acc[a][bb] *= al[a];
#pragma unroll 4
      for (int j = 0; j < BS; ++j) {
        float pr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pr[a] = sp[(4 * rg + a) * (BS + 1) + j];
        const float4* vrow = reinterpret_cast<const float4*>(vf + j * D);
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          const float4 v = vrow[cg + 16 * jj];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][4 * jj + 0] += pr[a] * v.x;
            acc[a][4 * jj + 1] += pr[a] * v.y;
            acc[a][4 * jj + 2] += pr[a] * v.z;
            acc[a][4 * jj + 3] += pr[a] * v.w;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (tid < M) l_s[tid] = l_run;
  __syncthreads();

  // store the tile's live rows only (the caller zeroed the rest)
  QT* out = static_cast<QT*>(p.out);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = 4 * rg + a;
    if (row >= m_live) continue;
    const float l = l_s[row];
    const float l_safe = l == 0.f ? 1.f : l;
    const size_t tok = static_cast<size_t>(b) * p.T + tok0 + row / p.G;
    const int head = kvh * p.G + row % p.G;
    QT* dst = out + (tok * p.H + head) * D;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = 4 * (cg + 16 * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(dst + c + e, acc[a][4 * jj + e] / l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename QT, typename KT, int D>
int launch_decode(const Params& p, cudaStream_t stream) {
  constexpr int bytes = DecodeLayout<KT, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<QT, KT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B, p.Hkv);
  paged_decode_kernel<QT, KT, D><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int D>
int launch_prefill(const Params& p, cudaStream_t stream) {
  constexpr int bytes = PrefillLayout<KT, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<QT, KT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + p.q_tile - 1) / p.q_tile, p.B, p.Hkv);
  paged_prefill_kernel<QT, KT, D><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int D>
int launch(const Params& p, bool prefill, cudaStream_t stream) {
  return prefill ? launch_prefill<QT, KT, D>(p, stream)
                 : launch_decode<QT, KT, D>(p, stream);
}

template <typename QT>
int launch_kv(const Params& p, bool prefill, int kv_int8, int D,
              cudaStream_t stream) {
  if (kv_int8) {
    return D == 64 ? launch<QT, int8_t, 64>(p, prefill, stream)
                   : launch<QT, int8_t, 128>(p, prefill, stream);
  }
  return D == 64 ? launch<QT, QT, 64>(p, prefill, stream)
                 : launch<QT, QT, 128>(p, prefill, stream);
}

int dispatch(bool prefill, const void* q, const void* k_pages,
             const void* v_pages, const void* k_scale, const void* v_scale,
             const void* block_tables, const void* chunk_start,
             const void* context_lens, void* out, int B, int T, int H,
             int Hkv, int D, int N, int nb, float sm_scale, int window,
             int q_bf16, int kv_int8, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0 || N <= 0 || nb <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  if (prefill ? M % G != 0 : G > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.cs = static_cast<const int*>(chunk_start);
  p.cl = static_cast<const int*>(context_lens);
  p.out = out;
  p.B = B;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.N = N;
  p.nb = nb;
  p.G = G;
  p.q_tile = prefill ? M / G : 1;
  p.window = window;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(p, prefill, kv_int8, D, s)
                : launch_kv<float>(p, prefill, kv_int8, D, s);
}

}  // namespace

// C entries for ctypes. k/v pages: [N, Hkv, 16, D] in q's type (q_bf16:
// bf16, else fp32), or int8 with fp32 scales [N, Hkv, 16] (kv_int8);
// block_tables int32 [B, nb]; context_lens (and chunk_start) int32 [B];
// window <= 0: none. The caller validates shapes. Each returns
// cudaGetLastError() after its launch (0 = launched).

// q/out: [B, H, D]; every output element is written.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, void* out, int B, int H, int Hkv, int D, int N,
    int nb, float sm_scale, int window, int q_bf16, int kv_int8,
    void* stream) {
  return dispatch(false, q, k_pages, v_pages, k_scale, v_scale, block_tables,
                  nullptr, context_lens, out, B, 1, H, Hkv, D, N, nb,
                  sm_scale, window, q_bf16, kv_int8, stream);
}

// q/out: [B, T, H, D]; the caller zeroes out (only live rows are stored).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* chunk_start, const void* context_lens, void* out, int B,
    int T, int H, int Hkv, int D, int N, int nb, float sm_scale, int window,
    int q_bf16, int kv_int8, void* stream) {
  return dispatch(true, q, k_pages, v_pages, k_scale, v_scale, block_tables,
                  chunk_start, context_lens, out, B, T, H, Hkv, D, N, nb,
                  sm_scale, window, q_bf16, kv_int8, stream);
}
