// Block-sparse flash attention, forward and backward, hand-written for
// Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/_build.py with nvcc and
// called through ctypes from deepspeed_tpu_torch/ops/block_sparse_attention.py.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   _fwd_kernel     (:55)  -> tc_fwd_kernel (bf16), fwd_kernel (fp32): out
//                             and the fp32 logsumexp
//   _bwd_dq_kernel  (:103) -> tc_dq_kernel, dq_kernel: dQ over the same
//                             active blocks
//   _bwd_dkv_kernel (:143) -> tc_dkv_kernel, dkv_kernel: dK and dV over the
//                             transposed lists
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
// Head dims 64, 80, 96, 128 and 256. This file holds the bf16 kernels for
// blocks that are a multiple of 64 and the fp32 kernels for every block
// that is a multiple of 16; bf16 at the other multiples of 16 is
// block_sparse_strips.cu. What both share is block_sparse_common.cuh.
//
// Bound. At the main shape (B 1, T 16384, H 32, D 128, bf16, block 128,
// causal BSLongformer window 7 + global block 0: 7.6% of the causal
// blocks) the forward reads q, k, v and writes out and lse once, 0.161 ms
// of bytes at 3.35 TB/s, against 0.154 ms of operations (4 D FLOP per
// visible pair) at the bf16 peak: bytes, by a hair. dQ (6 D FLOP a pair)
// and dK/dV (8 D) are bound by operations: 0.231 and 0.308 ms. Every key
// tile a walk visits is re-read from L2 or memory, and the rows are short
// (BSLongformer's ~5 blocks, ~640 keys), so the prologue, the ring fill
// and the epilogue weigh more than in flash attention over a whole row.
//
// bf16 inputs run on the tensor cores (tc_fwd_kernel, tc_dq_kernel,
// tc_dkv_kernel), the design of flash_attention.cu's tc_* kernels with the
// building blocks of tc_common.cuh, walking active lists:
// - A block of 4 warps owns one 64-row slice of a query block (forward,
//   dQ: each warp 16 rows) or of a key block (dK/dV: each warp 16 keys)
//   and walks the key tiles (query tiles for dK/dV) of the active blocks of
//   its work item. Products are mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate) with operands from ldmatrix (.trans for V in P.V, K in
//   dS.K, dO and Q in the dK/dV products). The forward keeps Q in
//   registers as A fragments for the whole walk, and its online softmax
//   lives in the accumulator fragments (quad shuffles, exp2 with the scale
//   folded in). P, dS, P^T and dS^T are rounded to bf16 and become A
//   fragments in registers: the C layout of an m16n8 pair is the A layout
//   of the next k-step, so nothing goes through shared memory.
// - Tiles are bf16 in shared memory (XOR-swizzled rows at D 64, 128 and
//   256, rows of D + 8 at D 80 and 96: tc_common.cuh tile_ld, swz), fed by
//   a 2-stage ring of 16-byte cp.async copies: the next tile is in flight
//   while this one is multiplied. dK/dV walks query tiles of 64 rows at
//   D 64 and of 32 at the other head dims (its dK and dV accumulators take
//   80-128 registers a thread there); their lse and delta come through the
//   same ring.
// - D 256, as in flash_attention.cu: the forward reads each k-step's Q
//   fragment from shared memory (the warp's 16 x 256 output accumulator
//   takes 128 registers), dQ walks key tiles of 32, and dK/dV runs its walk
//   twice in one C call, DV_ONLY then DK_ONLY, one 128-register
//   accumulator each (5/4 of the dK/dV work, no atomics).
// - The item's active blocks (at most C of them) are copied into shared
//   memory once, at the start; tile addresses and the causal bounds come
//   from there. Causality keeps a prefix of the ascending walk (forward,
//   dQ: key tiles at or before the own slice's last row) or a suffix
//   (dK/dV: query tiles at or after the own keys); only the tiles across
//   the diagonal are masked per element.
// - Load balance (the TPU grid pads every row to the largest degree and
//   needs none; here a block with a long walk would finish last). The
//   wrapper cuts every walk longer than C = 16 active blocks
//   (block_sparse_attention.py SPLIT_BLOCKS) into ceil(cnt / C) work items
//   of at most C blocks, and orders all items by length, longest first,
//   so that the long ones start at once and the short ones fill in behind
//   them. BigBird's global row and BSLongformer's global column (degree
//   128 at T 16384) become 8 items each, where one walk would be 26 times
//   as long as a typical one (4.9 blocks). An item of a walk that is not
//   split writes its output directly. The items of a split walk write fp32
//   partials into the wrapper's scratch (forward: the unnormalized O, the
//   running max m in log2 units and the row sum l; dQ, dK, dV: their
//   partial sums), and a second kernel in the same C entry merges them:
//   the forward through lse (rows that no item saw keep zeros and -inf),
//   the gradients by sums in the items' order. No atomics: the result does
//   not depend on scheduling.
// - Grid: x = (work item, slice of the block, batch row), heaviest first.
// Rounding points: S, dP and every accumulator are fp32; P and dS are
// rounded to bf16 before their products, as in the flash kernels; the row
// sum l is taken from the unrounded P.
//
// fp32 inputs keep the first design (fwd_kernel, dq_kernel, dkv_kernel):
// exact fp32 FMA on CUDA cores, which the 2e-5 fp32 tolerance needs (TF32
// cannot meet it). One block per (TS-row slice, batch x head) walks its
// whole list from device memory through a 2-stage cp.async double buffer
// of TS-row tiles: TS = 64 where the block is a multiple of 64 and D <=
// 128, else 16 (a D 256 tile of 64 fp32 rows is 66.6 KB, and finer blocks
// need finer tiles). Tiles are kept in shared memory as fp32 rows padded
// by 16 bytes; each thread holds a TS/16 x TS/16 block of scores and a
// TS/16 x D/16 block of the accumulators, P goes through shared memory,
// and tiles past the causal diagonal are skipped. It does not use the
// work list.
//
// Each kernel raises its shared-memory limit once per device
// (allow_smem), not on every launch. PERF.md has the times.

#include "block_sparse_common.cuh"

namespace {

constexpr int BT = 64;        // rows of a bf16 slice (and of its key tiles)
constexpr int THREADS = 256;  // fp32: 16 x 16, ty picks rows, tx columns
constexpr int TC_THREADS = 128;     // bf16: 4 warps of 16 rows

// a tile of ROWS rows of D elements of type E in shared memory
template <typename E, int D, int ROWS>
struct Tile {
  static constexpr int CH = 16 / static_cast<int>(sizeof(E));  // per 16 B
  static constexpr int LD = D + CH;            // row stride: 16 B of padding
  static constexpr int ELEMS = ROWS * LD;
  static constexpr int BYTES = ELEMS * static_cast<int>(sizeof(E));
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// N consecutive floats at p (16-byte aligned when N % 4 == 0)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(p)[c];
      o[4 * c] = x.x;
      o[4 * c + 1] = x.y;
      o[4 * c + 2] = x.z;
      o[4 * c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) o[c] = p[c];
  }
}

// start copying rows [row0, row0 + TS) of head h, batch b of a [B, T, H, D]
// tensor into a shared tile (16-byte pieces; the wrapper aligns the base)
template <typename E, int D, int TS>
__device__ __forceinline__ void load_tile_async(E* dst, const void* src, int b,
                                                int h, int row0, int T,
                                                int H) {
  using L = Tile<E, D, TS>;
  constexpr int PER_ROW = D / L::CH;
  const E* s = static_cast<const E*>(src);
  for (int c = threadIdx.x; c < TS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int e = (c % PER_ROW) * L::CH;
    cp16(saddr(dst + r * L::LD + e),
         s + ((static_cast<size_t>(b) * T + row0 + r) * H + h) * D + e, true);
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernels
// ---------------------------------------------------------------------------

// s[i][j] = sum_d X[RI ty + i][d] * Y[tx + 16 j][d] over two shared tiles
// (RI = TS / 16 rows and columns a thread)
template <typename E, int D, int TS>
__device__ __forceinline__ void tile_scores(float s[TS / 16][TS / 16],
                                            const E* X, const E* Y, int ty,
                                            int tx) {
  using L = Tile<E, D, TS>;
  constexpr int RI = TS / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += L::CH) {
    float a[RI][L::CH];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      load_vec<L::CH>(X + (RI * ty + i) * L::LD + d, a[i]);
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      float y[L::CH];
      load_vec<L::CH>(Y + (tx + 16 * j) * L::LD + d, y);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
#pragma unroll
        for (int i = 0; i < RI; ++i) s[i][j] = fmaf(a[i][c], y[c], s[i][j]);
    }
  }
}

// acc[i][n] += sum_c P[RI ty + i][c] * Z[c][tx D/16 + n] over the TS c of a
// tile; P is an fp32 score tile of stride TS + 4, Z a shared tile
template <typename E, int D, int TS>
__device__ __forceinline__ void tile_accumulate(float acc[TS / 16][D / 16],
                                                const float* P, const E* Z,
                                                int ty, int tx) {
  using L = Tile<E, D, TS>;
  constexpr int N = D / 16, RI = TS / 16, PS = TS + 4;
#pragma unroll 4
  for (int c = 0; c < TS; ++c) {
    float p[RI], z[N];
#pragma unroll
    for (int i = 0; i < RI; ++i) p[i] = P[(RI * ty + i) * PS + c];
    load_vec<N>(Z + c * L::LD + tx * N, z);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[i][n] = fmaf(p[i], z[n], acc[i][n]);
  }
}

// the first row of the walk's tile t: entry t / spb of the list, slice
// t % spb of that block
template <int TS>
__device__ __forceinline__ int tile_row0(const Params& p, const int* list,
                                         int spb, int t) {
  return __ldg(list + t / spb) * p.block + (t % spb) * TS;
}

// the first tile at or after t of a walk of n that causality lets
// through: for the forward and dQ (transposed = false) key tiles at or
// before the own rows' tile, for dK/dV query tiles at or after it
template <int TS>
__device__ __forceinline__ int next_tile(const Params& p, const int* list,
                                         int spb, int n, int t, int own0,
                                         bool transposed) {
  for (; t < n && p.causal; ++t) {
    const int o0 = tile_row0<TS>(p, list, spb, t);
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

template <typename E, int D, int TS>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  using L = Tile<E, D, TS>;
  constexpr int N = D / 16, RI = TS / 16, PS = TS + 4;
  const int spb = p.block / TS;
  const int row0 = blockIdx.x * TS;
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
  int t = next_tile<TS>(p, list, spb, n, 0, row0, false);
  load_tile_async<E, D, TS>(qs, p.q, b, h, row0, p.T, p.H);
  if (t < n) {
    const int c0 = tile_row0<TS>(p, list, spb, t);
    load_tile_async<E, D, TS>(ring, p.k, b, h, c0, p.T, p.H);
    load_tile_async<E, D, TS>(ring + L::ELEMS, p.v, b, h, c0, p.T, p.H);
  }
  cp_commit();

  float acc[RI][N];
  float m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  int stage = 0;
  while (t < n) {
    const int c0 = tile_row0<TS>(p, list, spb, t);
    cp_wait<0>();
    __syncthreads();  // tile t landed; the other stage and ps are free
    const int tn = next_tile<TS>(p, list, spb, n, t + 1, row0, false);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0<TS>(p, list, spb, tn);
      load_tile_async<E, D, TS>(nxt, p.k, b, h, n0, p.T, p.H);
      load_tile_async<E, D, TS>(nxt + L::ELEMS, p.v, b, h, n0, p.T, p.H);
    }
    cp_commit();
    const E* ks = ring + 2 * stage * L::ELEMS;
    const E* vs = ks + L::ELEMS;
    const bool diag = p.causal && c0 == row0;
    float s[RI][RI];
    tile_scores<E, D, TS>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] = !diag || tx + 16 * j <= RI * ty + i ? s[i][j] * p.sm_scale
                                                       : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(RI * ty + i) * PS + tx + 16 * j] = pj;
        sum += pj;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accumulate<E, D, TS>(acc, ps, vs, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_wait<0>();

  E* out = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + RI * ty + i;
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

template <typename E, int D, int TS>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using L = Tile<E, D, TS>;
  constexpr int N = D / 16, RI = TS / 16, PS = TS + 4;
  const int spb = p.block / TS;
  const int row0 = blockIdx.x * TS;
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
  int t = next_tile<TS>(p, list, spb, n, 0, row0, false);
  load_tile_async<E, D, TS>(qs, p.q, b, h, row0, p.T, p.H);
  load_tile_async<E, D, TS>(dos, p.dout, b, h, row0, p.T, p.H);
  if (t < n) {
    const int c0 = tile_row0<TS>(p, list, spb, t);
    load_tile_async<E, D, TS>(ring, p.k, b, h, c0, p.T, p.H);
    load_tile_async<E, D, TS>(ring + L::ELEMS, p.v, b, h, c0, p.T, p.H);
  }
  cp_commit();

  float lse[RI], delta[RI];
  float acc[RI][N];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const size_t at =
        static_cast<size_t>(blockIdx.y) * p.T + row0 + RI * ty + i;
    lse[i] = lse_offset(p.lse[at]);
    delta[i] = p.delta[at];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  int stage = 0;
  while (t < n) {
    const int c0 = tile_row0<TS>(p, list, spb, t);
    cp_wait<0>();
    __syncthreads();
    const int tn = next_tile<TS>(p, list, spb, n, t + 1, row0, false);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0<TS>(p, list, spb, tn);
      load_tile_async<E, D, TS>(nxt, p.k, b, h, n0, p.T, p.H);
      load_tile_async<E, D, TS>(nxt + L::ELEMS, p.v, b, h, n0, p.T, p.H);
    }
    cp_commit();
    const E* ks = ring + 2 * stage * L::ELEMS;
    const E* vs = ks + L::ELEMS;
    const bool diag = p.causal && c0 == row0;
    float s[RI][RI], dp[RI][RI];
    tile_scores<E, D, TS>(s, qs, ks, ty, tx);
    tile_scores<E, D, TS>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float pij = !diag || tx + 16 * j <= RI * ty + i
                              ? expf(s[i][j] * p.sm_scale - lse[i])
                              : 0.f;
        dss[(RI * ty + i) * PS + tx + 16 * j] = pij * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    tile_accumulate<E, D, TS>(acc, dss, ks, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_wait<0>();

  E* dq = static_cast<E*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + RI * ty + i;
    E* dst = dq + ((static_cast<size_t>(b) * p.T + row) * p.H + h) * D +
             tx * N;
#pragma unroll
    for (int j = 0; j < N; ++j) store(dst + j, acc[i][j] * p.sm_scale);
  }
}

template <typename E, int D, int TS>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  using L = Tile<E, D, TS>;
  constexpr int N = D / 16, RI = TS / 16, PS = TS + 4;
  const int spb = p.block / TS;
  const int c0 = blockIdx.x * TS;
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
  float* rows = pt + TS * PS;  // stage s: lse at rows + 2 s TS, then delta

  // rows of the shared tile as TS / 4 pieces of 16 bytes: lse, then delta
  auto load_stats = [&](float* dst, int r0) {
    const size_t at = static_cast<size_t>(blockIdx.y) * p.T + r0;
    if (tid < TS / 4)
      cp16(saddr(dst + 4 * tid), p.lse + at + 4 * tid, true);
    else if (tid < TS / 2)
      cp16(saddr(dst + TS + 4 * (tid - TS / 4)),
           p.delta + at + 4 * (tid - TS / 4), true);
  };

  const int* list = p.idx + (static_cast<size_t>(h) * p.nb + kb) * p.A;
  const int n = __ldg(p.cnt + h * p.nb + kb) * spb;
  int t = next_tile<TS>(p, list, spb, n, 0, c0, true);
  load_tile_async<E, D, TS>(ks, p.k, b, h, c0, p.T, p.H);
  load_tile_async<E, D, TS>(vs, p.v, b, h, c0, p.T, p.H);
  if (t < n) {
    const int r0 = tile_row0<TS>(p, list, spb, t);
    load_tile_async<E, D, TS>(ring, p.q, b, h, r0, p.T, p.H);
    load_tile_async<E, D, TS>(ring + L::ELEMS, p.dout, b, h, r0, p.T, p.H);
    load_stats(rows, r0);
  }
  cp_commit();

  float dk[RI][N], dv[RI][N];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dk[i][j] = dv[i][j] = 0.f;

  int stage = 0;
  while (t < n) {
    const int r0 = tile_row0<TS>(p, list, spb, t);
    cp_wait<0>();
    __syncthreads();
    const int tn = next_tile<TS>(p, list, spb, n, t + 1, c0, true);
    if (tn < n) {
      E* nxt = ring + 2 * (stage ^ 1) * L::ELEMS;
      const int n0 = tile_row0<TS>(p, list, spb, tn);
      load_tile_async<E, D, TS>(nxt, p.q, b, h, n0, p.T, p.H);
      load_tile_async<E, D, TS>(nxt + L::ELEMS, p.dout, b, h, n0, p.T, p.H);
      load_stats(rows + 2 * TS * (stage ^ 1), n0);
    }
    cp_commit();
    const E* qs = ring + 2 * stage * L::ELEMS;
    const E* dos = qs + L::ELEMS;
    const float* lse_s = rows + 2 * TS * stage;
    const float* delta_s = lse_s + TS;
    const bool diag = p.causal && r0 == c0;
    // transposed tiles: row index i is a key (c0 + RI ty + i), column j a
    // query (r0 + tx + 16 j)
    float st[RI][RI], dpt[RI][RI];
    tile_scores<E, D, TS>(st, ks, qs, ty, tx);
    tile_scores<E, D, TS>(dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int r = tx + 16 * j;
        st[i][j] = !diag || RI * ty + i <= r
                       ? expf(st[i][j] * p.sm_scale - lse_offset(lse_s[r]))
                       : 0.f;
        pt[(RI * ty + i) * PS + r] = st[i][j];
      }
    __syncthreads();
    tile_accumulate<E, D, TS>(dv, pt, dos, ty, tx);
    __syncthreads();  // every read of P^T is done: dS^T takes its place
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int r = tx + 16 * j;
        pt[(RI * ty + i) * PS + r] = st[i][j] * (dpt[i][j] - delta_s[r]);
      }
    __syncthreads();
    tile_accumulate<E, D, TS>(dk, pt, qs, ty, tx);
    stage ^= 1;
    t = tn;
  }
  cp_wait<0>();

  E* dkp = static_cast<E*>(p.out);
  E* dvp = static_cast<E*>(p.out2);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const size_t at =
        ((static_cast<size_t>(b) * p.T + c0 + RI * ty + i) * p.H + h) * D +
        tx * N;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      store(dkp + at + j, dk[i][j] * p.sm_scale);
      store(dvp + at + j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels over the work list
// ---------------------------------------------------------------------------

// what one block does: rows (keys for dK/dV) [64 tile, 64 tile + 64) of
// head h, batch b, over entries [start, start + n) of list row tile / spb;
// part >= 0 is the index of its fp32 partial in the scratch
struct Item {
  int b, h, tile, start, n, part;
};

// blockIdx.x = (work item * spb + slice) * B + batch row, so consecutive
// blocks share an item and the grid keeps the list's longest-first order
__device__ __forceinline__ Item work_item(const Params& p) {
  const int spb = p.block / BT;
  const int j = blockIdx.x / p.B;
  const int s = j % spb;
  const int* w = p.work + static_cast<size_t>(j / spb) * WORK;
  Item it;
  it.b = blockIdx.x % p.B;
  it.h = w[0];
  it.tile = w[1] * spb + s;
  it.start = w[2];
  it.n = w[3];
  it.part = w[4] < 0 ? -1 : (w[4] * spb + s) * p.B + it.b;
  return it;
}

// the item's active blocks, copied to shared memory (read after a barrier)
__device__ __forceinline__ void load_list(int* blk, const Params& p,
                                          const Item& it) {
  const int* list =
      p.idx +
      (static_cast<size_t>(it.h) * p.nb + it.tile / (p.block / BT)) * p.A +
      it.start;
  for (int i = threadIdx.x; i < it.n; i += blockDim.x) blk[i] = list[i];
}

// Up to D 128 the warp's Q rows stay in registers (QREG); at D 256 they
// would take 64 registers beside the 128 of the output accumulator, so
// each k-step's Q fragment is read from shared memory instead.
template <int D>
__global__ void __launch_bounds__(TC_THREADS) tc_fwd_kernel(Params p) {
  constexpr int KT = D / 16, NS = BT / 8, ND = D / 8, LD = tile_ld<D>();
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* ks = qs + BT * LD;      // [2][BT][LD]
  bf16_t* vs = ks + 2 * BT * LD;  // [2][BT][LD]
  int* blk = reinterpret_cast<int*>(vs + 2 * BT * LD);

  const Item it = work_item(p);
  const int spb = p.block / BT;
  const int row0 = it.tile * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  load_list(blk, p, it);
  load_rows<D, BT, TC_THREADS>(qs, p.q, it.b, it.h, row0, p.T, p.H);
  cp_commit();
  __syncthreads();  // the list

  // key tile t: slice t % spb of block t / spb; causality keeps the tiles
  // at or before the own slice, a prefix of the ascending walk
  auto key0 = [&](int t) { return blk[t / spb] * p.block + (t % spb) * BT; };
  int n = it.n * spb;
  if (p.causal)
    while (n > 0 && key0(n - 1) > row0) --n;
  if (n > 0) {
    load_rows<D, BT, TC_THREADS>(ks, p.k, it.b, it.h, key0(0), p.T, p.H);
    load_rows<D, BT, TC_THREADS>(vs, p.v, it.b, it.h, key0(0), p.T, p.H);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  uint32_t qf[QREG ? KT : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldsm(qf[kk], a_addr<D>(qs, warp * 16, kk, lane));
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) {
      const int c1 = key0(t + 1);
      load_rows<D, BT, TC_THREADS>(ks + (stage ^ 1) * BT * LD, p.k, it.b,
                                   it.h, c1, p.T, p.H);
      load_rows<D, BT, TC_THREADS>(vs + (stage ^ 1) * BT * LD, p.v, it.b,
                                   it.h, c1, p.T, p.H);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* kt = ks + stage * BT * LD;
    const bf16_t* vt = vs + stage * BT * LD;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm(qa, a_addr<D>(qs, warp * 16, kk, lane));
      }
#pragma unroll
      for (int nj = 0; nj < NS / 2; ++nj) {
        uint32_t kb[4];
        ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
        mma(s[2 * nj], qa, kb[0], kb[1]);
        mma(s[2 * nj + 1], qa, kb[2], kb[3]);
      }
    }

    const bool diag = p.causal && key0(t) == row0;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (diag && j * 8 + 2 * (lane & 3) + (e & 1) >
                        warp * 16 + (lane >> 2) + 8 * (e >> 1))
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = ex2(m_run[i] - base[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }

#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t vb[4];
        ldsm_t(vb, bt_addr<D>(vt, kk * 16, dj, lane));
        mma(o[2 * dj], a, vb[0], vb[1]);
        mma(o[2 * dj + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
    stage ^= 1;
  }
  cp_wait<0>();

  // a split item's partial: O [BT][D] unnormalized, then m and l [BT]
  float* part = it.part < 0 ? nullptr
                            : p.scratch + static_cast<size_t>(it.part) *
                                              BT * (D + 2);
  bf16_t* out = static_cast<bf16_t*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(o[d][2 * i], o[d][2 * i + 1]);
      if ((lane & 3) == 0) {
        part[BT * D + r] = m_run[i];
        part[BT * D + BT + r] = l;
      }
      continue;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    bf16_t* dst = out + at_row<D>(p, it.b, row0 + r, it.h) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    if ((lane & 3) == 0)
      p.lse_out[(static_cast<size_t>(it.b) * p.H + it.h) * p.T + row0 + r] =
          l == 0.f ? -INFINITY : m_run[i] * LN2 + logf(l);
  }
}

// KN keys a tile: 64, or 32 at D 256, where dQ's accumulator takes 128
// registers and the S and dP tiles of 64 keys would take 64 more
template <int D, int KN>
__global__ void __launch_bounds__(TC_THREADS) tc_dq_kernel(Params p) {
  constexpr int KT = D / 16, NS = KN / 8, ND = D / 8, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* dos = qs + BT * LD;
  bf16_t* ks = dos + BT * LD;     // [2][KN][LD]
  bf16_t* vs = ks + 2 * KN * LD;  // [2][KN][LD]
  int* blk = reinterpret_cast<int*>(vs + 2 * KN * LD);

  const Item it = work_item(p);
  const int kpb = p.block / KN;  // key tiles of a block
  const int row0 = it.tile * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  load_list(blk, p, it);
  load_rows<D, BT, TC_THREADS>(qs, p.q, it.b, it.h, row0, p.T, p.H);
  load_rows<D, BT, TC_THREADS>(dos, p.dout, it.b, it.h, row0, p.T, p.H);
  __syncthreads();  // the list

  // key tile t: tile t % kpb of block t / kpb; causality keeps the tiles
  // that start at or before the slice's last row, a prefix of the walk
  auto key0 = [&](int t) { return blk[t / kpb] * p.block + (t % kpb) * KN; };
  int n = it.n * kpb;
  if (p.causal)
    while (n > 0 && key0(n - 1) > row0 + BT - 1) --n;
  if (n > 0) {
    load_rows<D, KN, TC_THREADS>(ks, p.k, it.b, it.h, key0(0), p.T, p.H);
    load_rows<D, KN, TC_THREADS>(vs, p.v, it.b, it.h, key0(0), p.T, p.H);
  }
  cp_commit();

  float lse2[2], dl[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (static_cast<size_t>(it.b) * p.H + it.h) * p.T + row0 +
                      warp * 16 + (lane >> 2) + 8 * i;
    lse2[i] = lse_offset(p.lse[at]) * LOG2E;
    dl[i] = p.delta[at];
  }
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) {
      const int c1 = key0(t + 1);
      load_rows<D, KN, TC_THREADS>(ks + (stage ^ 1) * KN * LD, p.k, it.b,
                                   it.h, c1, p.T, p.H);
      load_rows<D, KN, TC_THREADS>(vs + (stage ^ 1) * KN * LD, p.v, it.b,
                                   it.h, c1, p.T, p.H);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* kt = ks + stage * KN * LD;
    const bf16_t* vt = vs + stage * KN * LD;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], da[4];
      ldsm(qa, a_addr<D>(qs, warp * 16, kk, lane));
      ldsm(da, a_addr<D>(dos, warp * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < NS / 2; ++nj) {
        uint32_t kb[4], vb[4];
        ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
        mma(s[2 * nj], qa, kb[0], kb[1]);
        mma(s[2 * nj + 1], qa, kb[2], kb[3]);
        ldsm(vb, b_addr<D>(vt, nj * 16, kk, lane));
        mma(dp[2 * nj], da, vb[0], vb[1]);
        mma(dp[2 * nj + 1], da, vb[2], vb[3]);
      }
    }

    // the tile crosses the diagonal where a key comes after a row: key
    // key0 + c is hidden from row row0 + r when c > r + (row0 - key0)
    const int off = row0 - key0(t);
    const bool diag = p.causal && KN - 1 > off;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
        if (diag && j * 8 + 2 * (lane & 3) + (e & 1) >
                        warp * 16 + (lane >> 2) + 8 * (e >> 1) + off)
          pe = 0.f;
        s[j][e] = pe * (dp[j][e] - dl[e >> 1]);  // dS
      }

#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t kb[4];
        ldsm_t(kb, bt_addr<D>(kt, kk * 16, dj, lane));
        mma(dq[2 * dj], a, kb[0], kb[1]);
        mma(dq[2 * dj + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();
    stage ^= 1;
  }
  cp_wait<0>();

  bf16_t* out = static_cast<bf16_t*>(p.out);
  float* part = it.part < 0 ? nullptr
                            : p.scratch + static_cast<size_t>(it.part) * BT * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(dq[d][2 * i], dq[d][2 * i + 1]);
      continue;
    }
    bf16_t* dst = out + at_row<D>(p, it.b, row0 + r, it.h) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) = __floats2bfloat162_rn(
          dq[d][2 * i] * p.sm_scale, dq[d][2 * i + 1] * p.sm_scale);
  }
}

// PART: BOTH computes dK and dV in one walk; at D 256 their accumulators
// would take 256 registers a lane, so the C call runs the walk twice,
// DV_ONLY (S^T, P^T, dV) then DK_ONLY (S^T, dP^T, dS^T, dK): each pass
// holds one 128-register accumulator and writes its half of the outputs
// (or of a split item's partial), and neither needs atomics.
enum Part { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

template <int D, int BQ, int PART>
__global__ void __launch_bounds__(TC_THREADS) tc_dkv_kernel(Params p) {
  constexpr int KT = D / 16, NQ = BQ / 8, ND = D / 8, LD = tile_ld<D>();
  constexpr bool WANT_DK = PART != DV_ONLY, WANT_DV = PART != DK_ONLY;
  static_assert(2 * BQ <= TC_THREADS, "one thread per lse and delta value");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(tc_smem);
  bf16_t* vs = ks + BT * LD;
  bf16_t* qs = vs + BT * LD;       // [2][BQ][LD]
  bf16_t* dos = qs + 2 * BQ * LD;  // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ] lse
  float* dls = ls + 2 * BQ;                                 // [2][BQ] delta
  int* blk = reinterpret_cast<int*>(dls + 2 * BQ);

  const Item it = work_item(p);
  const int qpb = p.block / BQ;  // query tiles of a block
  const int c0 = it.tile * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(it.b) * p.H + it.h;
  load_list(blk, p, it);
  load_rows<D, BT, TC_THREADS>(ks, p.k, it.b, it.h, c0, p.T, p.H);
  load_rows<D, BT, TC_THREADS>(vs, p.v, it.b, it.h, c0, p.T, p.H);
  __syncthreads();  // the list

  // query tile t: rows [row0(t), row0(t) + BQ); causality keeps the tiles
  // at or after the own keys, a suffix of the ascending walk
  auto row0 = [&](int t) { return blk[t / qpb] * p.block + (t % qpb) * BQ; };
  auto load_q = [&](int t, int st) {
    const int r0 = row0(t);
    load_rows<D, BQ, TC_THREADS>(qs + st * BQ * LD, p.q, it.b, it.h, r0, p.T,
                                 p.H);
    load_rows<D, BQ, TC_THREADS>(dos + st * BQ * LD, p.dout, it.b, it.h, r0,
                                 p.T, p.H);
    const size_t at = bh * p.T + r0 + (tid % BQ);
    if (tid < BQ)
      cp4(saddr(ls + st * BQ + tid), p.lse + at, true);
    else if (tid < 2 * BQ)
      cp4(saddr(dls + st * BQ + tid - BQ), p.delta + at, true);
  };
  const int n = it.n * qpb;
  int t0 = 0;
  if (p.causal)
    while (t0 < n && row0(t0) < c0) ++t0;
  if (t0 < n) load_q(t0, 0);
  cp_commit();

  float dk[WANT_DK ? ND : 1][4], dv[WANT_DV ? ND : 1][4];
#pragma unroll
  for (int d = 0; d < (WANT_DK ? ND : 1); ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = 0.f;
#pragma unroll
  for (int d = 0; d < (WANT_DV ? ND : 1); ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[d][e] = 0.f;
  const float sl2 = p.sm_scale * LOG2E;
  int stage = 0;

  for (int t = t0; t < n; ++t) {
    if (t + 1 < n) load_q(t + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16_t* qt = qs + stage * BQ * LD;
    const bf16_t* dot = dos + stage * BQ * LD;
    const float* lt = ls + stage * BQ;
    const float* dlt = dls + stage * BQ;
    const int r0 = row0(t);

    // transposed tiles: row = a key (c0 + 16 warp + ...), column = a query
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, a_addr<D>(ks, warp * 16, kk, lane));
      if constexpr (WANT_DK) ldsm(va, a_addr<D>(vs, warp * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < NQ / 2; ++nj) {
        uint32_t qb[4], db[4];
        ldsm(qb, b_addr<D>(qt, nj * 16, kk, lane));
        mma(st[2 * nj], ka, qb[0], qb[1]);
        mma(st[2 * nj + 1], ka, qb[2], qb[3]);
        if constexpr (WANT_DK) {
          ldsm(db, b_addr<D>(dot, nj * 16, kk, lane));
          mma(dpt[2 * nj], va, db[0], db[1]);
          mma(dpt[2 * nj + 1], va, db[2], db[3]);
        }
      }
    }

    // some query of the tile comes before some key: the diagonal
    const bool diag = p.causal && r0 < c0 + BT - 1;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
        float pe = ex2(fmaf(st[j][e], sl2, -lse_offset(lt[qi]) * LOG2E));
        if (diag && r0 + qi < c0 + warp * 16 + (lane >> 2) + 8 * (e >> 1))
          pe = 0.f;
        st[j][e] = pe;                            // P^T
        dpt[j][e] = pe * (dpt[j][e] - dlt[qi]);  // dS^T
      }

#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      c_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dj = 0; dj < ND / 2; ++dj) {
        uint32_t db[4], qb[4];
        if constexpr (WANT_DV) {
          ldsm_t(db, bt_addr<D>(dot, kk * 16, dj, lane));
          mma(dv[2 * dj], ap, db[0], db[1]);
          mma(dv[2 * dj + 1], ap, db[2], db[3]);
        }
        if constexpr (WANT_DK) {
          ldsm_t(qb, bt_addr<D>(qt, kk * 16, dj, lane));
          mma(dk[2 * dj], as, qb[0], qb[1]);
          mma(dk[2 * dj + 1], as, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
    stage ^= 1;
  }
  cp_wait<0>();

  // a split item's partial: dK [BT][D] (unscaled), then dV [BT][D]
  float* part = it.part < 0
                    ? nullptr
                    : p.scratch + static_cast<size_t>(it.part) * 2 * BT * D;
  bf16_t* dkp = static_cast<bf16_t*>(p.out);
  bf16_t* dvp = static_cast<bf16_t*>(p.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if constexpr (WANT_DK)
          *reinterpret_cast<float2*>(dst + 8 * d) =
              make_float2(dk[d][2 * i], dk[d][2 * i + 1]);
        if constexpr (WANT_DV)
          *reinterpret_cast<float2*>(dst + BT * D + 8 * d) =
              make_float2(dv[d][2 * i], dv[d][2 * i + 1]);
      }
      continue;
    }
    const size_t at = at_row<D>(p, it.b, c0 + r, it.h) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if constexpr (WANT_DK)
        *reinterpret_cast<__nv_bfloat162*>(dkp + at + 8 * d) =
            __floats2bfloat162_rn(dk[d][2 * i] * p.sm_scale,
                                  dk[d][2 * i + 1] * p.sm_scale);
      if constexpr (WANT_DV)
        *reinterpret_cast<__nv_bfloat162*>(dvp + at + 8 * d) =
            __floats2bfloat162_rn(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// fp32: the CUDA-core kernels, grid (TS-row slice, batch x head)
template <int D, int TS>
int launch_fp32(Which which, const Params& p, cudaStream_t stream) {
  constexpr int tile = Tile<float, D, TS>::BYTES;
  constexpr int score = TS * (TS + 4) * 4;
  const dim3 grid(p.T / TS, p.B * p.H);
  if (which == FWD)  // Q + 2 stages of K, V
    return run<fwd_kernel<float, D, TS>>(p, grid, THREADS, 5 * tile + score,
                                         stream);
  if (which == DQ)   // Q, dO + 2 stages of K, V
    return run<dq_kernel<float, D, TS>>(p, grid, THREADS, 6 * tile + score,
                                        stream);
  // K, V + 2 stages of Q, dO, lse and delta
  return run<dkv_kernel<float, D, TS>>(p, grid, THREADS,
                                       6 * tile + score + 4 * TS * 4, stream);
}

// bf16: the tensor-core kernels over the work list, then the merge of the
// split walks (when there are any) on the same stream
template <int D>
int launch_bf16(Which which, const Params& p, cudaStream_t stream) {
  constexpr int E = static_cast<int>(sizeof(bf16_t));
  constexpr int LD = tile_ld<D>();
  if (!work_list_ok(p, BT)) return static_cast<int>(cudaErrorInvalidValue);
  const int list = (p.max_blocks * 4 + 15) / 16 * 16;
  const dim3 grid(static_cast<unsigned>(
      static_cast<long long>(p.n_work) * (p.block / BT) * p.B));
  int err;
  if (which == FWD) {  // Q + 2 stages of K, V
    err = run<tc_fwd_kernel<D>>(p, grid, TC_THREADS, 5 * BT * LD * E + list,
                                stream);
  } else if (which == DQ) {  // Q, dO + 2 stages of K, V
    constexpr int KN = D == 256 ? 32 : BT;
    err = run<tc_dq_kernel<D, KN>>(
        p, grid, TC_THREADS, (2 * BT * LD + 4 * KN * LD) * E + list, stream);
  } else {  // K, V + 2 stages of Q, dO, lse and delta
    constexpr int BQ = D == 64 ? 64 : 32;
    constexpr int bytes = (2 * BT * LD + 4 * BQ * LD) * E + 4 * BQ * 4;
    if constexpr (D <= 128) {
      err = run<tc_dkv_kernel<D, BQ, BOTH>>(p, grid, TC_THREADS,
                                            bytes + list, stream);
    } else {
      err = run<tc_dkv_kernel<D, BQ, DV_ONLY>>(p, grid, TC_THREADS,
                                               bytes + list, stream);
      if (err == 0)
        err = run<tc_dkv_kernel<D, BQ, DK_ONLY>>(p, grid, TC_THREADS,
                                                 bytes + list, stream);
    }
  }
  return err != 0 ? err : run_merge<D, BT>(which, p, stream);
}

// bf16: the 64-row slices (the block a multiple of 64); fp32: slices of
// 64 rows where the block allows and a 64-row tile fits (D <= 128), else
// of 16
template <int D>
struct Launch {
  static int launch(Which which, const Params& p, cudaStream_t stream,
                    int bf16) {
    if (bf16) {
      if (p.block % BT != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch_bf16<D>(which, p, stream);
    }
    if constexpr (D <= 128)
      if (p.block % 64 == 0) return launch_fp32<D, 64>(which, p, stream);
    return launch_fp32<D, 16>(which, p, stream);
  }
};

int dispatch(Which which, Params& p, int D, int bf16, void* stream) {
  if (p.block <= 0 || p.block % 16 != 0 || p.T % p.block != 0 ||
      p.B * p.H > 65535 || p.A <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nb = p.T / p.block;
  return by_head_dim<Launch>(D, which, p, static_cast<cudaStream_t>(stream),
                             bf16);
}

}  // namespace

// C entries for ctypes. q/k/v/out/dout/dq/dk/dv: [B, T, H, D], contiguous,
// 16-byte aligned, bf16 (bf16 != 0) or fp32; lse/delta: [B, H, T] fp32,
// 16-byte aligned; idx int32 [H, T / block, A] with cnt int32
// [H, T / block]: the active key blocks of each query block (forward, dQ)
// or the active query blocks of each key block (dK/dV), ascending; block a
// multiple of 64 dividing T for bf16, of 16 for fp32; D is 64, 80, 96, 128
// or 256. The last six arguments are the work list of the same lists,
// which the bf16 kernels walk (the fp32 kernels ignore them): work int32
// [n_work, 5] (head, list row, first entry, entries, slot or -1), longest
// first, covering every entry of every row once; merge int32 [n_merge, 4]
// (head, list row, first slot, slots) for each walk cut into several
// items; max_blocks the most entries an item holds; scratch fp32, slots *
// block * B * (D + 2) floats for the forward, * D for dQ, * 2 D for dK/dV,
// or null when n_merge is 0. Every output element is written; the merge
// runs inside the same call. Each returns cudaGetLastError() after its
// last launch (0 = launched).
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const int* kv_idx,
    const int* kv_cnt, void* out, float* lse, int B, int H, int T, int D,
    int block, int A, int causal, float sm_scale, int bf16, void* stream,
    const int* work, int n_work, const int* merge, int n_merge,
    int max_blocks, float* scratch) {
  Params p = make(q, k, v, kv_idx, kv_cnt, B, H, T, block, A, causal,
                  sm_scale, work, n_work, merge, n_merge, max_blocks, scratch);
  p.out = out;
  p.lse_out = lse;
  return dispatch(FWD, p, D, bf16, stream);
}

extern "C" int block_sparse_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* kv_idx,
    const int* kv_cnt, void* dq, int B, int H, int T, int D, int block, int A,
    int causal, float sm_scale, int bf16, void* stream, const int* work,
    int n_work, const int* merge, int n_merge, int max_blocks,
    float* scratch) {
  Params p = make(q, k, v, kv_idx, kv_cnt, B, H, T, block, A, causal,
                  sm_scale, work, n_work, merge, n_merge, max_blocks, scratch);
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
    int causal, float sm_scale, int bf16, void* stream, const int* work,
    int n_work, const int* merge, int n_merge, int max_blocks,
    float* scratch) {
  Params p = make(q, k, v, q_idx, q_cnt, B, H, T, block, A, causal,
                  sm_scale, work, n_work, merge, n_merge, max_blocks, scratch);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return dispatch(DKV, p, D, bf16, stream);
}
