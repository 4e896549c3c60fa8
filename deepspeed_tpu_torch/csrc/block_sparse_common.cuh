// What the two block-sparse attention sources share (sm_90a):
// block_sparse_attention.cu (the 64-row tensor-core route and the fp32
// CUDA-core kernels) and block_sparse_strips.cu (the 16-row tensor-core
// route for blocks that are not a multiple of 64). The parameters of a C
// entry, the work list's items, the merge of split walks, the launch with
// its shared-memory opt-in and the dispatch over the head dims. Each
// including source is its own library, so everything here has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int MERGE_THREADS = 256;  // the merge of split walks
constexpr int WORK = 5;   // ints of a work item: head, list row, first entry,
                          // entries, slot (-1: the item is the whole walk)
constexpr int MERGE = 4;  // ints of a split walk: head, list row, first
                          // slot, slots (one per item, in the walk's order)

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
  const int* work;     // bf16: [n_work, WORK] items, longest first
  const int* merge;    // bf16: [n_merge, MERGE] the split walks
  float* scratch;      // bf16: the split items' fp32 partials
  int B, H, T, nb, A, block, causal;
  int n_work, n_merge, max_blocks;  // max_blocks: the longest item
  float sm_scale;
};

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// element offset of (batch b, row, head h) in a [B, T, H, D] tensor
template <int D>
__device__ __forceinline__ size_t at_row(const Params& p, int b, int row,
                                         int h) {
  return ((static_cast<size_t>(b) * p.T + row) * p.H + h) * D;
}

// a saved lse as the exponent's offset: -inf (a row that saw no key)
// becomes +inf so that its probabilities are 0, not NaN
__device__ __forceinline__ float lse_offset(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

// ---------------------------------------------------------------------------
// the merge of split walks: one block per (split walk, ROWS-row slice of its
// block, batch row); a split item's partial holds ROWS rows
// ---------------------------------------------------------------------------

struct Split {
  int b, h, row0, n;
  size_t part0, stride;  // index of the first partial; between two items
};

template <int ROWS>
__device__ __forceinline__ Split split_walk(const Params& p) {
  const int spb = p.block / ROWS;
  const int j = blockIdx.x / p.B;
  const int s = j % spb;
  const int* e = p.merge + static_cast<size_t>(j / spb) * MERGE;
  Split w;
  w.b = blockIdx.x % p.B;
  w.h = e[0];
  w.row0 = (e[1] * spb + s) * ROWS;
  w.n = e[3];
  // partial of slot c: (c * spb + s) * B + b, as the work items number it
  w.part0 = (static_cast<size_t>(e[2]) * spb + s) * p.B + w.b;
  w.stride = static_cast<size_t>(spb) * p.B;
  return w;
}

// four fp32 values -> four bf16 at dst (8-byte aligned)
__device__ __forceinline__ void store4(bf16_t* dst, float4 x, float c) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(x.x * c, x.y * c);
  d[1] = __floats2bfloat162_rn(x.z * c, x.w * c);
}

// the forward's partials (O [ROWS][D] unnormalized, then m and l [ROWS])
// through their maxima: out = sum_c 2^(m_c - M) O_c / L, L = sum_c
// 2^(m_c - M) l_c, lse = M ln 2 + log L; a row no item saw (M = -inf)
// keeps zeros and lse = -inf
template <int D, int ROWS>
__global__ void __launch_bounds__(MERGE_THREADS) merge_fwd_kernel(Params p) {
  constexpr int PART = ROWS * (D + 2);
  __shared__ float m_s[ROWS], inv_s[ROWS];
  const Split w = split_walk<ROWS>(p);
  const float* part = p.scratch + w.part0 * PART;
  const size_t stride = w.stride * PART;
  const int tid = threadIdx.x;
  if (tid < ROWS) {
    float m = -INFINITY, l = 0.f;
    for (int c = 0; c < w.n; ++c)
      m = fmaxf(m, part[c * stride + ROWS * D + tid]);
    if (m != -INFINITY)
      for (int c = 0; c < w.n; ++c)
        l += part[c * stride + ROWS * D + ROWS + tid] *
             exp2f(part[c * stride + ROWS * D + tid] - m);
    m_s[tid] = m;
    inv_s[tid] = l == 0.f ? 0.f : 1.f / l;
    p.lse_out[(static_cast<size_t>(w.b) * p.H + w.h) * p.T + w.row0 + tid] =
        l == 0.f ? -INFINITY : m * LN2 + logf(l);
  }
  __syncthreads();
  bf16_t* out = static_cast<bf16_t*>(p.out);
  for (int x = tid; x < ROWS * D / 4; x += MERGE_THREADS) {
    const int r = x / (D / 4);
    const int d = (x % (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_s[r] != -INFINITY)
      for (int c = 0; c < w.n; ++c) {
        const float* pc = part + c * stride;
        const float a = exp2f(pc[ROWS * D + r] - m_s[r]);
        const float4 o = *reinterpret_cast<const float4*>(pc + r * D + d);
        acc.x += a * o.x;
        acc.y += a * o.y;
        acc.z += a * o.z;
        acc.w += a * o.w;
      }
    store4(out + at_row<D>(p, w.b, w.row0 + r, w.h) + d, acc, inv_s[r]);
  }
}

// dQ (NOUT 1) or dK and dV (NOUT 2): the partials ([NOUT][ROWS][D])
// summed in the items' order; dQ and dK take the softmax scale
template <int D, int NOUT, int ROWS>
__global__ void __launch_bounds__(MERGE_THREADS) merge_sum_kernel(Params p) {
  constexpr int PART = NOUT * ROWS * D;
  const Split w = split_walk<ROWS>(p);
  const float* part = p.scratch + w.part0 * PART;
  const size_t stride = w.stride * PART;
  for (int x = threadIdx.x; x < NOUT * ROWS * D / 4; x += MERGE_THREADS) {
    const int o = x / (ROWS * D / 4);
    const int r = x % (ROWS * D / 4) / (D / 4);
    const int d = (x % (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < w.n; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          part + c * stride + o * ROWS * D + r * D + d);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    bf16_t* dst = static_cast<bf16_t*>(o == 0 ? p.out : p.out2);
    store4(dst + at_row<D>(p, w.b, w.row0 + r, w.h) + d, acc,
           o == 0 ? p.sm_scale : 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// a launch with more than 48 KB of dynamic shared memory needs the opt-in
// (raised to the card's limit, once per kernel and device); the merge
// kernels' static arrays would not leave room for it
template <void (*K)(Params)>
int run(const Params& p, dim3 grid, int threads, int bytes,
        cudaStream_t stream) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = allow_smem<K>(MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  K<<<grid, threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the merge of a work list's split walks after its kernel, ROWS rows a
// partial; nothing when no walk was split
template <int D, int ROWS>
int run_merge(Which which, const Params& p, cudaStream_t stream) {
  const long long splits =
      static_cast<long long>(p.n_merge) * (p.block / ROWS) * p.B;
  if (splits == 0) return 0;
  if (splits > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(splits));
  if (which == FWD)
    return run<merge_fwd_kernel<D, ROWS>>(p, grid, MERGE_THREADS, 0, stream);
  if (which == DQ)
    return run<merge_sum_kernel<D, 1, ROWS>>(p, grid, MERGE_THREADS, 0,
                                             stream);
  return run<merge_sum_kernel<D, 2, ROWS>>(p, grid, MERGE_THREADS, 0, stream);
}

// does a work list fit the launch: items, splits and their scratch
inline bool work_list_ok(const Params& p, int rows) {
  const long long per = static_cast<long long>(p.block / rows) * p.B;
  return p.work != nullptr && p.n_work > 0 && p.max_blocks >= 0 &&
         p.n_work * per <= INT_MAX && p.n_merge * per <= INT_MAX &&
         (p.n_merge == 0 || (p.merge != nullptr && p.scratch != nullptr));
}

// L<D>::launch(args...) for head dim D, one of the five the kernels are
// compiled for
template <template <int> class L, typename... Args>
int by_head_dim(int D, Args... args) {
  switch (D) {
    case 64: return L<64>::launch(args...);
    case 80: return L<80>::launch(args...);
    case 96: return L<96>::launch(args...);
    case 128: return L<128>::launch(args...);
    case 256: return L<256>::launch(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make(const void* q, const void* k, const void* v, const int* idx,
            const int* cnt, int B, int H, int T, int block, int A, int causal,
            float sm_scale, const int* work, int n_work, const int* merge,
            int n_merge, int max_blocks, float* scratch) {
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
  p.work = work;
  p.n_work = n_work;
  p.merge = merge;
  p.n_merge = n_merge;
  p.max_blocks = max_blocks;
  p.scratch = scratch;
  return p;
}

}  // namespace
