// One-position attention over the contiguous KV cache, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/decode_attention.py.
//
// Replaces the TPU kernel
//   deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel
// and computes the same function: q [B, H, D] is one new token per row;
// the cache is head-major [B, Hkv, S, D] (bf16/fp32, or int8 with fp32
// scales [B, Hkv, S]); query head kvh*G + g reads kv head kvh. Key j is
// visible iff j <= cache_index, j < S, key_mask[b, j] > 0 and, with a
// window, cache_index - j < window. Softmax runs in fp32; a row that sees
// no key returns zeros. cache_index is a device int32 scalar, read by the
// kernel (the TPU kernel prefetches it), so the launch does not depend on
// its value.
//
// Bound: bytes. A decode step reads each row's filled K/V prefix once
// (plus scales and the mask) for about 4*G flops per K/V element, far
// below the card's ridge, so the floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
// - one block per (batch row, kv head); the TPU grid's sequential key
//   axis and its m/l/acc scratch become a loop over 64-key tiles inside
//   the block, with the running max and sum in shared memory and the
//   accumulator in registers;
// - the loop visits only the tiles of the filled prefix (and, with a
//   window, only those inside it), so the bytes grow with the real length,
//   not the cache's capacity;
// - each K/V tile is loaded once, through a 2-stage cp.async ring, and
//   shared by the G query heads of its kv head (G = 4 on Llama-3-8B); an
//   int8 cache is read as int8 and dequantized in shared memory;
// - masked keys are skipped in the P.V sum (their V is never read into a
//   sum), so stale or non-finite values under the mask cannot leak.
// Limits of this first version: at B 8 x Hkv 8 the grid is 64 blocks on
// 132 SMs, and one block streams a whole row, so long caches leave the card
// short of loads in flight; splitting S across blocks (flash-decoding) is
// the next step. Compute is fp32 FMA on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;      // keys per tile
constexpr int MAXG = 8;     // query heads per kv head
constexpr int NSTAGE = 2;   // tiles in flight

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* mask;
  const int* cidx;
  void* out;
  int B, H, Hkv, S, G, window;  // window <= 0: no window
  float sm_scale;
};

template <typename KT, int D>
struct Layout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int DP = D + 4;  // padded fp32 row: float4 reads by 8
                                    // threads on 8 rows hit distinct banks
  static constexpr int TILE_BYTES = BK * D * sizeof(KT);
  static constexpr int SCALE_BYTES = INT8 ? BK * 4 : 0;
  // stage: K tile | V tile | k scales | v scales | mask
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * SCALE_BYTES + BK * 4;
  static constexpr int QF = 0;                          // float [MAXG][DP]
  static constexpr int KF = QF + MAXG * DP * 4;         // float [BK][DP]
  static constexpr int VF = KF + BK * DP * 4;           // float [BK][D]
  static constexpr int SP = VF + BK * D * 4;            // float [MAXG][BK+1]
  static constexpr int MRUN = SP + MAXG * (BK + 1) * 4;  // float [MAXG]
  static constexpr int LRUN = MRUN + MAXG * 4;          // float [MAXG]
  static constexpr int ALPHA = LRUN + MAXG * 4;         // float [MAXG]
  static constexpr int VALID = ALPHA + MAXG * 4;        // int [BK]
  static constexpr int RING = (VALID + BK * 4 + 15) / 16 * 16;
  static constexpr int BYTES = RING + NSTAGE * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0, "stage size must keep alignment");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  using L = Layout<KT, D>;
  constexpr int DP = L::DP;
  constexpr int NRG = THREADS / D;    // row groups in P.V (1 or 2)
  constexpr int RPT = MAXG / NRG;     // rows per thread in P.V
  constexpr int SRG = THREADS / BK;   // row groups in the scores (2)

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = p.G;
  const int S = p.S;
  const int cidx = *p.cidx;
  const int hi = min(cidx, S - 1);
  const int lo = p.window > 0 ? max(0, cidx - p.window + 1) : 0;
  const int tile_lo = lo / BK;
  const int ntiles = hi >= lo ? hi / BK - tile_lo + 1 : 0;
  const size_t head = static_cast<size_t>(b) * p.Hkv + kvh;

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

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % NSTAGE) * L::STAGE_BYTES;
    const int kv0 = (tile_lo + i) * BK;
    const int nrows = min(BK, S - kv0);
    const size_t row0 = head * S + kv0;
    const unsigned char* kg =
        static_cast<const unsigned char*>(p.k) + row0 * D * sizeof(KT);
    const unsigned char* vg =
        static_cast<const unsigned char*>(p.v) + row0 * D * sizeof(KT);
    const int chunks = nrows * D * static_cast<int>(sizeof(KT)) / 16;
    for (int c = tid; c < chunks; c += THREADS) {
      cp_async16(st + c * 16, kg + c * 16);
      cp_async16(st + L::TILE_BYTES + c * 16, vg + c * 16);
    }
    unsigned char* tail = st + 2 * L::TILE_BYTES;
    if (tid < nrows) {
      if (L::INT8) {
        cp_async4(tail + tid * 4, p.ks + row0 + tid);
        cp_async4(tail + L::SCALE_BYTES + tid * 4, p.vs + row0 + tid);
      }
      cp_async4(tail + 2 * L::SCALE_BYTES + tid * 4,
                p.mask + static_cast<size_t>(b) * S + kv0 + tid);
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
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();  // tile i landed; the last tile's P.V is done

    const unsigned char* st = ring + (i % NSTAGE) * L::STAGE_BYTES;
    const KT* kr = reinterpret_cast<const KT*>(st);
    const KT* vr = reinterpret_cast<const KT*>(st + L::TILE_BYTES);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE_BYTES);
    const float* vsc = ksc + BK;
    const int* msk = reinterpret_cast<const int*>(st + 2 * L::TILE_BYTES +
                                                  2 * L::SCALE_BYTES);
    const int kv0 = (tile_lo + i) * BK;
    if (tid < BK) {
      const int key = kv0 + tid;
      valid_s[tid] = key >= lo && key <= hi && msk[tid] > 0;
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

template <typename QT, typename KT, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Layout<KT, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<QT, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B, p.Hkv);
  decode_kernel<QT, KT, D><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(const Params& p, int kv_int8, int D, cudaStream_t stream) {
  if (kv_int8) {
    return D == 64 ? launch<QT, int8_t, 64>(p, stream)
                   : launch<QT, int8_t, 128>(p, stream);
  }
  return D == 64 ? launch<QT, QT, 64>(p, stream)
                 : launch<QT, QT, 128>(p, stream);
}

}  // namespace

// C entry for ctypes. q/out: [B, H, D] (q_bf16: bf16, else fp32); k/v
// caches [B, Hkv, S, D] in q's type, or int8 with fp32 scales [B, Hkv, S]
// (kv_int8); key_mask int32 [B, S]; cache_index int32 [1] on the device;
// window <= 0: none. The caller validates shapes. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* key_mask,
                                const void* cache_index, void* out, int B,
                                int H, int Hkv, int S, int D, float sm_scale,
                                int window, int q_bf16, int kv_int8,
                                void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG ||
      B > 65535 || Hkv > 65535)
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
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.G = H / Hkv;
  p.window = window;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(p, kv_int8, D, s)
                : launch_kv<float>(p, kv_int8, D, s);
}
