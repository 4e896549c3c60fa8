// Ragged paged attention for the packed serving step, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/ragged_attention.py.
//
// Replaces the TPU kernel
//   deepspeed_tpu/ops/pallas/ragged_attention.py::_ragged_kernel
// and computes the same function: q [T, H, D] is a packed token batch of
// per-row segments (query_start, query_len); token t of row r sits at
// position chunk_start[r] + t and attends its row's kv positions p with
// p <= pos, p < context_lens[r] and, with a window, pos - p < window. Query
// head kvh*G + g reads kv head kvh. Softmax runs in fp32.
//
// Bound: bytes. A step reads every live K/V page of every row once per kv
// head, plus q and the output; the arithmetic per byte (about 2*G*q_tile
// FLOP per K/V element) is far below the card's 295 FLOP/byte ridge, so
// the floor is (live pages + q + out) / 3.35 TB/s.
//
// What the design does about it:
// - one block per (q-tile, row, kv head); the TPU grid's sequential page
//   axis and its m/l/acc scratch become a loop over the row's pages inside
//   the block, with the running max and sum in registers;
// - the loop touches only the pages the tile can see: it stops at the
//   tile's last causal position (and context_lens) and, with a window,
//   starts at the first page the tile's first token can see;
// - pages stream through a 4-stage cp.async ring, so several page loads
//   are in flight while the block computes on an earlier one;
// - the G query heads of a kv head share each page load (GQA grouping),
//   and an int8 pool is read as int8 and dequantized in shared memory;
// - tiles past a row's query_len and rows with no context exit at once,
//   and the output is zeroed by the caller (torch.zeros), so each block
//   stores only its own live tokens: blocks need no order between them.
// Compute is fp32 FMA on CUDA cores (no wgmma/TMA yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;       // tokens per KV page
constexpr int M = 32;        // query rows per block: q_tile tokens x G heads
constexpr int THREADS = 128;
constexpr int NSTAGE = 4;    // pages in flight

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* qs;
  const int* ql;
  const int* cs;
  const int* cl;
  void* out;
  int T, H, Hkv, N, R, nb, G, q_tile, window;  // window <= 0: no window
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

template <typename KT, int D>
struct Layout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int DP = D + 4;  // padded fp32 row: float4 reads by 8
                                    // threads on 8 rows hit distinct banks
  static constexpr int PAGE_BYTES = BS * D * sizeof(KT);
  static constexpr int SCALE_BYTES = INT8 ? BS * 4 : 0;
  static constexpr int STAGE_BYTES = 2 * PAGE_BYTES + 2 * SCALE_BYTES;
  static constexpr int QF = 0;                        // float [M][DP]
  static constexpr int KF = QF + M * DP * 4;          // float [BS][DP]
  static constexpr int VF = KF + BS * DP * 4;         // float [BS][D]
  static constexpr int SP = VF + BS * D * 4;          // float [M][BS + 1]
  static constexpr int ALPHA = SP + M * (BS + 1) * 4;  // float [M]
  static constexpr int LSUM = ALPHA + M * 4;          // float [M]
  static constexpr int RING = LSUM + M * 4;           // NSTAGE stages
  static constexpr int BYTES = RING + NSTAGE * STAGE_BYTES;
  static_assert(RING % 16 == 0, "cp.async destinations need 16B alignment");
  static_assert(STAGE_BYTES % 16 == 0, "stage size must keep alignment");
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) ragged_kernel(Params p) {
  using L = Layout<KT, D>;
  constexpr int DP = L::DP;
  constexpr int CPT = D / 64;  // float4 column groups per thread in P.V

  const int it = blockIdx.x;
  const int r = blockIdx.y;
  const int kvh = blockIdx.z;
  const int ql = p.ql[r];
  const int clen = p.cl[r];
  const int tok0 = it * p.q_tile;
  if (tok0 >= ql || clen <= 0) return;  // dead tile: output stays zero
  const int qs = p.qs[r];
  const int cs = p.cs[r];
  const int n_tok = min(p.q_tile, ql - tok0);
  const int m_live = n_tok * p.G;

  // pages the tile can see: causal end at its last token, window start at
  // its first token
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
    unsigned char* st = ring + (i % NSTAGE) * L::STAGE_BYTES;
    int pid = p.bt[r * p.nb + page_lo + i];
    if (pid < 0 || pid >= p.N) pid = p.N - 1;  // clamp sentinel entries
    const size_t page = static_cast<size_t>(pid) * p.Hkv + kvh;
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

  // prologue: the first NSTAGE - 1 pages start loading before q does
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < npages) issue(s);
    cp_async_commit();
  }

  // q tile -> fp32 shared rows; row j is token tok0 + j / G, head
  // kvh * G + j % G (the reshape(T, Hkv, G, D) grouping)
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < M * D; e += THREADS) {
    const int row = e / D;
    const int c = e % D;
    float x = 0.f;
    if (row < m_live) {
      const int tok = qs + tok0 + row / p.G;
      const int head = kvh * p.G + row % p.G;
      x = to_float(q[(static_cast<size_t>(tok) * p.H + head) * D + c]);
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
    for (int b = 0; b < 4 * CPT; ++b) acc[a][b] = 0.f;
  float m_run = -INFINITY;  // row tid's running max (warp 0 only)
  float l_run = 0.f;        // row tid's running sum (warp 0 only)

  for (int i = 0; i < npages; ++i) {
    if (i + NSTAGE - 1 < npages) issue(i + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();  // page i landed; last page's P.V is done with vf

    // raw page -> fp32 K/V rows (int8: times the per-token scale)
    const unsigned char* st = ring + (i % NSTAGE) * L::STAGE_BYTES;
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
        const float4 a = q0[d4], b = q1[d4], x = k0[d4], y = k1[d4];
        s[0][0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
        s[0][1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
        s[1][0] += b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w;
        s[1][1] += b.x * y.x + b.y * y.y + b.z * y.z + b.w * y.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int row = 2 * rp + a;
        const int pos = cs + tok0 + row / p.G;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int key = kp + 8 * b;
          const int col = kv0 + key;
          const bool valid = row < m_live && col <= pos && col < clen &&
                             (p.window <= 0 || pos - col < p.window);
          sp[row * (BS + 1) + key] = valid ? s[a][b] * p.sm_scale : -INFINITY;
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
        for (int b = 0; b < 4 * CPT; ++b) acc[a][b] *= al[a];
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

  // store the tile's live rows only: a tail tile may overlap the next
  // row's segment in the packed axis
  QT* out = static_cast<QT*>(p.out);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = 4 * rg + a;
    if (row >= m_live) continue;
    const float l = l_s[row];
    const float l_safe = l == 0.f ? 1.f : l;
    const int tok = qs + tok0 + row / p.G;
    const int head = kvh * p.G + row % p.G;
    QT* dst = out + (static_cast<size_t>(tok) * p.H + head) * D;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = 4 * (cg + 16 * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + c + e, acc[a][4 * jj + e] / l_safe);
    }
  }
}

template <typename QT, typename KT, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Layout<KT, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<QT, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + p.q_tile - 1) / p.q_tile, p.R, p.Hkv);
  ragged_kernel<QT, KT, D><<<grid, THREADS, bytes, stream>>>(p);
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

// C entry for ctypes. q/out: [T, H, D] (q_bf16: bf16, else fp32);
// k/v pages: [N, Hkv, 16, D] in q's type, or int8 with fp32 scales
// [N, Hkv, 16] (kv_int8); block_tables int32 [R, nb]; query_start,
// query_len, chunk_start, context_lens int32 [R]; window <= 0: none.
// The caller validates shapes and zeroes out. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* query_start, const void* query_len, const void* chunk_start,
    const void* context_lens, void* out, int T, int H, int Hkv, int D, int N,
    int R, int nb, float sm_scale, int window, int q_bf16, int kv_int8,
    void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (H % Hkv != 0 || M % (H / Hkv) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.qs = static_cast<const int*>(query_start);
  p.ql = static_cast<const int*>(query_len);
  p.cs = static_cast<const int*>(chunk_start);
  p.cl = static_cast<const int*>(context_lens);
  p.out = out;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.N = N;
  p.R = R;
  p.nb = nb;
  p.G = H / Hkv;
  p.q_tile = M / p.G;
  p.window = window;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(p, kv_int8, D, s)
                : launch_kv<float>(p, kv_int8, D, s);
}
