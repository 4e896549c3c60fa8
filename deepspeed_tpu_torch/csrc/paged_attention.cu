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
// - paged_decode_kernel (K7a): q [B, H, D], one new token per sequence
//   sitting at context_lens[b] - 1. Key p is visible iff p < context_lens[b]
//   and, with a window, context_lens[b] - 1 - p < window.
// - paged_prefill_kernel (K7b): q [B, T, H, D], one prefill chunk per
//   sequence. Row t sits at chunk_start[b] + t and sees keys p <= its
//   position with p < context_lens[b] and, with a window, position - p <
//   window; rows at or past context_lens[b] (the chunk's padded tail)
//   return zeros.
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
// K7a is split-key flash-decoding over the block table (the walk is
// paged_common.cuh's, shared with K6). It replaces the first design, one
// block per (sequence, kv head) walking all of the sequence's tiles in fp32
// FMA, whose time followed the longest context. What the design does about
// the limits of that one:
// - the longest row no longer sets the time: the key axis (the table's
//   nb * 16 keys) is cut into `splits` ranges of `per` whole 64-key tiles,
//   grid (B, Hkv, splits), the count from nb and the SM count (K4's rule,
//   ops/decode_attention.py paged_splits), never from context_lens; a split
//   past the context or outside the window writes an empty partial and
//   exits, the others walk only their visible tiles;
// - each split writes an fp32 partial that merge_kernel, launched by the
//   same C call, combines in split order (no atomics: bitwise
//   deterministic); with one split the block writes the output itself;
// - no per-tile fp32 conversion pass or serial softmax: bf16 q over a bf16
//   pool runs on the tensor cores with K4's mapping (the G heads padded to
//   16 rows, a warp per page of each 64-key tile, P as bf16(P) +
//   bf16(P - bf16(P))), over a bf16 pool or an int8 pool converted to
//   bf16 in shared memory (exact: the codes are small integers; the
//   scales stay fp32); fp32 q runs exact fp32 FMA;
// - keys outside the visible range are zero-filled or zeroed in shared
//   memory before P.V, so a NaN in a page's stale tail cannot leak.
//
// K7b keeps its first design (fp32 FMA on CUDA cores): one block per
// (tile of 32 / G chunk rows, sequence, kv head) walks single pages through
// a 4-stage cp.async ring, from the first page its first row's window can
// see to the page of its last row's position; tiles past the chunk's valid
// length exit at once (the caller zeroes the output); an int8 pool is read
// as int8 and dequantized in shared memory; keys under the mask get
// probability exactly 0 (pool pages only ever hold finite values).

#include "paged_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// paged decode (K7a): grid (B, Hkv, splits) over paged_common.cuh's walk
// ---------------------------------------------------------------------------

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Pool p,
                                                               const int* cl) {
  extern __shared__ __align__(16) unsigned char smem[];
  Item it;
  it.row = blockIdx.x;
  it.kvh = blockIdx.y;
  it.tok0 = blockIdx.x;
  it.ntok = 1;
  it.clen = cl[blockIdx.x];
  it.pos0 = it.clen - 1;
  key_range(p, it.pos0, 1, it.clen, it.lo, it.hi);
  const int s = blockIdx.z;
  it.t0 = max(s * p.per, it.lo / BK);
  it.t1 = it.hi >= it.lo ? min((s + 1) * p.per, it.hi / BK + 1) : 0;
  it.slot = p.nsplit == 1 ? -1 : s;
  if (it.t0 >= it.t1) {
    empty_item<QT>(p, it, D);
    return;
  }
  run_item<QT, KT, D>(p, it, true, smem);
}

template <typename QT, typename KT, int D>
cudaError_t launch_decode(const Pool& p, const int* cl, int B,
                          cudaStream_t stream) {
  constexpr int bytes = narrow_smem<QT, KT, D>();
  cudaError_t err = allow_smem<paged_decode_kernel<QT, KT, D>>(bytes);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<QT, KT, D>
      <<<dim3(B, p.Hkv, p.nsplit), THREADS, bytes, stream>>>(p, cl);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  merge_kernel<QT><<<merge_grid(B, p.H), MERGE_THREADS, 0, stream>>>(
      p, nullptr, D);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_decode_kv(const Pool& p, const int* cl, int B, int kv_int8,
                             int D, cudaStream_t stream) {
  if (kv_int8)
    return D == 64 ? launch_decode<QT, int8_t, 64>(p, cl, B, stream)
                   : launch_decode<QT, int8_t, 128>(p, cl, B, stream);
  return D == 64 ? launch_decode<QT, QT, 64>(p, cl, B, stream)
                 : launch_decode<QT, QT, 128>(p, cl, B, stream);
}

// ---------------------------------------------------------------------------
// paged chunked prefill (K7b), unchanged in its own namespace
// ---------------------------------------------------------------------------

namespace prefill {

constexpr int BS = 16;        // tokens per KV page
constexpr int THREADS = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* cs;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the pool page behind table entry `page` of sequence b; unallocated
// entries clamp to the last page (hidden by the length mask)
__device__ __forceinline__ int page_id(const Params& p, int b, int page) {
  int pid = p.bt[b * p.nb + page];
  if (pid < 0 || pid >= p.N) pid = p.N - 1;
  return pid;
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


template <typename QT>
int launch_kv(const Params& p, int kv_int8, int D, cudaStream_t stream) {
  if (kv_int8) {
    return D == 64 ? launch_prefill<QT, int8_t, 64>(p, stream)
                   : launch_prefill<QT, int8_t, 128>(p, stream);
  }
  return D == 64 ? launch_prefill<QT, QT, 64>(p, stream)
                 : launch_prefill<QT, QT, 128>(p, stream);
}

int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale,
             const void* block_tables, const void* chunk_start,
             const void* context_lens, void* out, int B, int T, int H,
             int Hkv, int D, int N, int nb, float sm_scale, int window,
             int q_bf16, int kv_int8, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0 || N <= 0 || nb <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  if (M % G != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  p.q_tile = M / G;
  p.window = window;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(p, kv_int8, D, s)
                : launch_kv<float>(p, kv_int8, D, s);
}

}  // namespace prefill

}  // namespace

// C entries for ctypes. k/v pages: [N, Hkv, 16, D] in q's type (q_bf16:
// bf16, else fp32), or int8 with fp32 scales [N, Hkv, 16] (kv_int8);
// block_tables int32 [B, nb]; context_lens (and chunk_start) int32 [B];
// window <= 0: none. The caller validates shapes. Each returns
// cudaGetLastError() after its launches (0 = launched).

// q/out: [B, H, D]; every output element is written. The table's nb * 16
// keys are cut into `splits` ranges of `per` 64-key tiles (the wrapper
// derives both from nb and the card); scratch is fp32
// [B * H * splits * (D + 2)] (unused with one split).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, void* out, void* scratch, int B, int H,
    int Hkv, int D, int N, int nb, float sm_scale, int window, int q_bf16,
    int kv_int8, int splits, int per, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (nb * PAGE + BK - 1) / BK;
  if (B <= 0 || N <= 0 || nb <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > MAXG || B > 65535 || Hkv > 65535 || per <= 0 ||
      splits != (tiles + per - 1) / per || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Pool p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.out = out;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = p.part_o + static_cast<size_t>(B) * H * splits * D;
  p.H = H;
  p.Hkv = Hkv;
  p.N = N;
  p.nb = nb;
  p.G = H / Hkv;
  p.window = window;
  p.nsplit = splits;
  p.per = per;
  p.sl2 = sm_scale * LOG2E;
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      q_bf16 ? launch_decode_kv<__nv_bfloat16>(p, cl, B, kv_int8, D, s)
             : launch_decode_kv<float>(p, cl, B, kv_int8, D, s));
}

// q/out: [B, T, H, D]; the caller zeroes out (only live rows are stored).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* chunk_start, const void* context_lens, void* out, int B,
    int T, int H, int Hkv, int D, int N, int nb, float sm_scale, int window,
    int q_bf16, int kv_int8, void* stream) {
  return prefill::dispatch(q, k_pages, v_pages, k_scale, v_scale,
                           block_tables, chunk_start, context_lens, out, B, T,
                           H, Hkv, D, N, nb, sm_scale, window, q_bf16,
                           kv_int8, stream);
}
