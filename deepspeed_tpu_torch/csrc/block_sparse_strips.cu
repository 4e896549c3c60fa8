// Block-sparse flash attention at fine blocks: the bf16 forward, dQ and
// dK/dV for layout blocks that are a multiple of 16 but not of 64 (16, 32,
// 48, 80, ...), hand-written for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes
// from deepspeed_tpu_torch/ops/block_sparse_attention.py, which sends bf16
// inputs at these blocks here and every other case to
// block_sparse_attention.cu.
//
// Replaces, with block_sparse_attention.cu, the TPU kernels of
// deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   _fwd_kernel     (:55)  -> strip_fwd_kernel + merge_fwd_kernel
//   _bwd_dq_kernel  (:103) -> strip_dq_kernel + merge_sum_kernel
//   _bwd_dkv_kernel (:143) -> strip_dkv_kernel + merge_sum_kernel
// over the same layouts, lists and work lists, and computes the same
// function (see the top of block_sparse_attention.cu). The TPU kernel takes
// any block T / nb; DeepSpeed's sparse-attention configs default to a
// block of 16 (Fixed: 4 local blocks and 1 global one).
//
// Bound. At DeepSpeed's default (Fixed, block 16, bidirectional, T 4096,
// H 16, D 64, B 4) each query block sees 4 local and 64 global blocks,
// 27% of the keys: the forward is bound by its operations (4 D FLOP a
// visible pair), about 0.07 ms at the bf16 peak against 0.04 ms of bytes.
//
// Why strips. The 64-row route gives a block of 4 warps one 64-row slice
// of a query block; at a block of 16 each 16-row query block has its own
// active list, so a 64-row slice would have to walk four lists or the
// layout coarsened to 64 x 64 tiles, and every 64-key window of the
// default's layout holds a global column: coarsened, it is dense, 3.8 times
// the work. So here the unit of work is a strip of 16 rows, mma's M:
// - In the forward and dQ a warp owns 16 query rows of one query block
//   and walks that block's active list in steps of 16 keys (one k16 step
//   of P.V); in dK/dV a warp owns 16 keys of one key block and walks the
//   transposed list in steps of 16 queries. Q (forward, up to D 128: as A
//   fragments in registers), the online softmax and the accumulators stay
//   in registers, as in the 64-row route; P, dS, P^T and dS^T become A
//   fragments in registers (the C layout of an m16n8 pair is the A layout
//   of the next k-step).
// - The warps of a block are independent: the 4 warps take 4 neighbouring
//   strips of the longest-first work list, so they finish together, and
//   each has its own slice of shared memory: its strip's tiles (Q; Q and
//   dO; K and V), its list entries, and a ring of 3 stages (2 at D 256) of
//   16-row tiles fed by 16-byte cp.async copies, synchronised by the warp
//   alone (cp.async.wait_group, then __syncwarp).
// - Splits as in the 64-row route, counted in keys: a walk of more than
//   SPLIT_KEYS = 2048 keys (block_sparse_attention.py) is cut into items
//   whose fp32 partials (16 rows each) a second kernel of the same C entry
//   merges in the items' order. No atomics.
// - Causality keeps a prefix of the forward and dQ walks (key steps at or
//   before the strip) and a suffix of the dK/dV walk; only the one step on
//   the diagonal is masked per element.
// - Tiles: XOR-swizzled rows at D 64, 128 and 256, rows of D + 8 at D 80
//   and 96 (tc_common.cuh). D 256: the forward reads Q fragments from
//   shared memory (its output accumulator takes 128 registers), and dK/dV
//   runs its walk twice, DV_ONLY then DK_ONLY, as in the 64-row route.
// Rounding points are those of the 64-row route: S, dP and every
// accumulator fp32; P and dS rounded to bf16 before their products; the
// row sum from the unrounded P. The online softmax rescales every 16 keys
// where the 64-row route does every 64: the same function, other fp32
// rounding, well inside the bf16 tolerance.

#include "block_sparse_common.cuh"

namespace {

constexpr int SR = 16;         // rows of a strip, and keys (queries) a step
constexpr int WARPS = 4;       // strips of a block
constexpr int STRIP_THREADS = WARPS * 32;

// stages of a warp's ring: 3, or 2 at D 256 where a stage of two 16-row
// tiles is 16 KB
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 256 ? 2 : 3;
}

// elements of a 16-row bf16 tile
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return SR * tile_ld<D>();
}

// ints of a warp's copy of its list entries, a whole number of 16 bytes
__host__ __device__ inline int list_ints(const Params& p) {
  return (p.max_blocks + 3) / 4 * 4;
}

// start copying rows [row0, row0 + 16) of head h, batch b of a [B, T, H, D]
// bf16 tensor into a 16-row tile, by the 32 lanes of one warp
template <int D>
__device__ __forceinline__ void warp_rows(bf16_t* dst, const void* src, int b,
                                          int h, int row0, int T, int H,
                                          int lane) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  const bf16_t* s = static_cast<const bf16_t*>(src);
#pragma unroll
  for (int i = 0; i < SR * CH / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / CH;
    const int ch = c % CH;
    cp16(saddr(dst + swz<D>(r, ch)),
         s + ((static_cast<size_t>(b) * T + row0 + r) * H + h) * D + ch * 8,
         true);
  }
}

// what one warp does: rows (keys for dK/dV) [row0, row0 + 16) of head h,
// batch b, over entries [start, start + n) of list row row0 / block; part
// >= 0 is the index of its fp32 partial in the scratch
struct Strip {
  int b, h, row0, start, n, part;
  bool live;
};

// warp w of block x takes strip 4 x + w of the work list's (item, strip of
// the block, batch row) order, the order of the 64-row route's blocks
__device__ __forceinline__ Strip strip_item(const Params& p, int warp) {
  const int spb = p.block / SR;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  Strip it = {};
  it.live = g < static_cast<long long>(p.n_work) * spb * p.B;
  if (!it.live) return it;
  const int j = static_cast<int>(g / p.B);
  const int s = j % spb;
  const int* w = p.work + static_cast<size_t>(j / spb) * WORK;
  it.b = static_cast<int>(g % p.B);
  it.h = w[0];
  it.row0 = w[1] * p.block + s * SR;
  it.start = w[2];
  it.n = w[3];
  it.part = w[4] < 0 ? -1 : (w[4] * spb + s) * p.B + it.b;
  return it;
}

// the strip's list entries into the warp's copy (read after __syncwarp)
__device__ __forceinline__ void warp_list(int* blk, const Params& p,
                                          const Strip& it, int lane) {
  const int* list =
      p.idx + (static_cast<size_t>(it.h) * p.nb + it.row0 / p.block) * p.A +
      it.start;
  for (int i = lane; i < it.n; i += 32) blk[i] = list[i];
}

template <int D>
__global__ void __launch_bounds__(STRIP_THREADS) strip_fwd_kernel(Params p) {
  constexpr int KT = D / 16, ND = D / 8, NST = stages<D>();
  constexpr int TILE = tile_elems<D>();
  constexpr int PER_WARP = TILE + 2 * NST * TILE;  // Q, then NST x (K, V)
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem) + warp * PER_WARP;
  bf16_t* ring = qs + TILE;  // stage s: K at ring + 2 s TILE, then V
  int* blk = reinterpret_cast<int*>(reinterpret_cast<bf16_t*>(tc_smem) +
                                    WARPS * PER_WARP) +
             warp * list_ints(p);

  const Strip it = strip_item(p, warp);
  if (!it.live) return;
  warp_list(blk, p, it, lane);
  __syncwarp();

  // key step t: 16 keys of block t / kpb; causality keeps the steps at or
  // before the strip, a prefix of the ascending walk
  const int kpb = p.block / SR;
  auto key0 = [&](int t) { return blk[t / kpb] * p.block + (t % kpb) * SR; };
  int n = it.n * kpb;
  if (p.causal)
    while (n > 0 && key0(n - 1) > it.row0) --n;
  auto load = [&](int t) {
    bf16_t* st = ring + 2 * (t % NST) * TILE;
    warp_rows<D>(st, p.k, it.b, it.h, key0(t), p.T, p.H, lane);
    warp_rows<D>(st + TILE, p.v, it.b, it.h, key0(t), p.T, p.H, lane);
  };
  warp_rows<D>(qs, p.q, it.b, it.h, it.row0, p.T, p.H, lane);
  cp_commit();
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < n) load(t);
    cp_commit();
  }
  cp_wait<NST - 1>();
  __syncwarp();
  uint32_t qf[QREG ? KT : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm(qf[kk], a_addr<D>(qs, 0, kk, lane));
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  const float sl2 = p.sm_scale * LOG2E;

  for (int t = 0; t < n; ++t) {
    if (t + NST - 1 < n) load(t + NST - 1);
    cp_commit();
    cp_wait<NST - 1>();
    __syncwarp();  // step t's tiles landed, for every lane
    const bf16_t* kt = ring + 2 * (t % NST) * TILE;
    const bf16_t* vt = kt + TILE;

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], kb[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm(qa, a_addr<D>(qs, 0, kk, lane));
      }
      ldsm(kb, b_addr<D>(kt, 0, kk, lane));
      mma(s[0], qa, kb[0], kb[1]);
      mma(s[1], qa, kb[2], kb[3]);
    }

    const bool diag = p.causal && key0(t) == it.row0;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (diag && j * 8 + 2 * (lane & 3) + (e & 1) >
                        (lane >> 2) + 8 * (e >> 1))
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }

    uint32_t a[4];
    c_to_a(a, s[0], s[1]);
#pragma unroll
    for (int dj = 0; dj < ND / 2; ++dj) {
      uint32_t vb[4];
      ldsm_t(vb, bt_addr<D>(vt, 0, dj, lane));
      mma(o[2 * dj], a, vb[0], vb[1]);
      mma(o[2 * dj + 1], a, vb[2], vb[3]);
    }
    __syncwarp();  // this stage is free for step t + NST
  }
  cp_wait<0>();

  // a split item's partial: O [16][D] unnormalized, then m and l [16]
  float* part = it.part < 0 ? nullptr
                            : p.scratch + static_cast<size_t>(it.part) *
                                              SR * (D + 2);
  bf16_t* out = static_cast<bf16_t*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int r = (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(o[d][2 * i], o[d][2 * i + 1]);
      if ((lane & 3) == 0) {
        part[SR * D + r] = m_run[i];
        part[SR * D + SR + r] = l;
      }
      continue;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    bf16_t* dst =
        out + at_row<D>(p, it.b, it.row0 + r, it.h) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    if ((lane & 3) == 0)
      p.lse_out[(static_cast<size_t>(it.b) * p.H + it.h) * p.T + it.row0 +
                r] = l == 0.f ? -INFINITY : m_run[i] * LN2 + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(STRIP_THREADS) strip_dq_kernel(Params p) {
  constexpr int KT = D / 16, ND = D / 8, NST = stages<D>();
  constexpr int TILE = tile_elems<D>();
  constexpr int PER_WARP = 2 * TILE + 2 * NST * TILE;  // Q, dO, NST x (K, V)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16_t* qs = reinterpret_cast<bf16_t*>(tc_smem) + warp * PER_WARP;
  bf16_t* dos = qs + TILE;
  bf16_t* ring = dos + TILE;  // stage s: K at ring + 2 s TILE, then V
  int* blk = reinterpret_cast<int*>(reinterpret_cast<bf16_t*>(tc_smem) +
                                    WARPS * PER_WARP) +
             warp * list_ints(p);

  const Strip it = strip_item(p, warp);
  if (!it.live) return;
  warp_list(blk, p, it, lane);
  __syncwarp();

  const int kpb = p.block / SR;
  auto key0 = [&](int t) { return blk[t / kpb] * p.block + (t % kpb) * SR; };
  int n = it.n * kpb;
  if (p.causal)
    while (n > 0 && key0(n - 1) > it.row0) --n;
  auto load = [&](int t) {
    bf16_t* st = ring + 2 * (t % NST) * TILE;
    warp_rows<D>(st, p.k, it.b, it.h, key0(t), p.T, p.H, lane);
    warp_rows<D>(st + TILE, p.v, it.b, it.h, key0(t), p.T, p.H, lane);
  };
  warp_rows<D>(qs, p.q, it.b, it.h, it.row0, p.T, p.H, lane);
  warp_rows<D>(dos, p.dout, it.b, it.h, it.row0, p.T, p.H, lane);
  cp_commit();
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < n) load(t);
    cp_commit();
  }

  float lse2[2], dl[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (static_cast<size_t>(it.b) * p.H + it.h) * p.T +
                      it.row0 + (lane >> 2) + 8 * i;
    lse2[i] = lse_offset(p.lse[at]) * LOG2E;
    dl[i] = p.delta[at];
  }
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const float sl2 = p.sm_scale * LOG2E;

  for (int t = 0; t < n; ++t) {
    if (t + NST - 1 < n) load(t + NST - 1);
    cp_commit();
    cp_wait<NST - 1>();
    __syncwarp();
    const bf16_t* kt = ring + 2 * (t % NST) * TILE;
    const bf16_t* vt = kt + TILE;

    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], da[4], kb[4], vb[4];
      ldsm(qa, a_addr<D>(qs, 0, kk, lane));
      ldsm(da, a_addr<D>(dos, 0, kk, lane));
      ldsm(kb, b_addr<D>(kt, 0, kk, lane));
      mma(s[0], qa, kb[0], kb[1]);
      mma(s[1], qa, kb[2], kb[3]);
      ldsm(vb, b_addr<D>(vt, 0, kk, lane));
      mma(dp[0], da, vb[0], vb[1]);
      mma(dp[1], da, vb[2], vb[3]);
    }

    const bool diag = p.causal && key0(t) == it.row0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
        if (diag && j * 8 + 2 * (lane & 3) + (e & 1) >
                        (lane >> 2) + 8 * (e >> 1))
          pe = 0.f;
        s[j][e] = pe * (dp[j][e] - dl[e >> 1]);  // dS
      }

    uint32_t a[4];
    c_to_a(a, s[0], s[1]);
#pragma unroll
    for (int dj = 0; dj < ND / 2; ++dj) {
      uint32_t kb[4];
      ldsm_t(kb, bt_addr<D>(kt, 0, dj, lane));
      mma(dq[2 * dj], a, kb[0], kb[1]);
      mma(dq[2 * dj + 1], a, kb[2], kb[3]);
    }
    __syncwarp();
  }
  cp_wait<0>();

  bf16_t* out = static_cast<bf16_t*>(p.out);
  float* part = it.part < 0 ? nullptr
                            : p.scratch + static_cast<size_t>(it.part) * SR * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(dq[d][2 * i], dq[d][2 * i + 1]);
      continue;
    }
    bf16_t* dst =
        out + at_row<D>(p, it.b, it.row0 + r, it.h) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) = __floats2bfloat162_rn(
          dq[d][2 * i] * p.sm_scale, dq[d][2 * i + 1] * p.sm_scale);
  }
}

// PART: BOTH computes dK and dV in one walk; at D 256 the C call runs it
// twice, DV_ONLY then DK_ONLY, one 128-register accumulator a pass, each
// writing its half of the outputs (or of a split item's partial)
enum Part { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

template <int D, int PART>
__global__ void __launch_bounds__(STRIP_THREADS) strip_dkv_kernel(Params p) {
  constexpr int KT = D / 16, ND = D / 8, NST = stages<D>();
  constexpr int TILE = tile_elems<D>();
  // K, V, then NST x (Q, dO); then NST x (lse, delta) of 16 floats each
  constexpr int PER_WARP = 2 * TILE + 2 * NST * TILE;
  constexpr bool WANT_DK = PART != DV_ONLY, WANT_DV = PART != DK_ONLY;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16_t* ks = reinterpret_cast<bf16_t*>(tc_smem) + warp * PER_WARP;
  bf16_t* vs = ks + TILE;
  bf16_t* ring = vs + TILE;  // stage s: Q at ring + 2 s TILE, then dO
  float* stats = reinterpret_cast<float*>(reinterpret_cast<bf16_t*>(tc_smem) +
                                          WARPS * PER_WARP) +
                 warp * NST * 2 * SR;
  int* blk = reinterpret_cast<int*>(
                 reinterpret_cast<float*>(reinterpret_cast<bf16_t*>(tc_smem) +
                                          WARPS * PER_WARP) +
                 WARPS * NST * 2 * SR) +
             warp * list_ints(p);

  const Strip it = strip_item(p, warp);
  if (!it.live) return;
  const int c0 = it.row0;  // the strip's first key
  const size_t bh = static_cast<size_t>(it.b) * p.H + it.h;
  warp_list(blk, p, it, lane);
  __syncwarp();

  // query step t: 16 rows of block t / qpb; causality keeps the steps at
  // or after the strip, a suffix of the ascending walk
  const int qpb = p.block / SR;
  auto row0 = [&](int t) { return blk[t / qpb] * p.block + (t % qpb) * SR; };
  const int n = it.n * qpb;
  int t0 = 0;
  if (p.causal)
    while (t0 < n && row0(t0) < c0) ++t0;
  auto load = [&](int t) {
    const int st = t % NST;
    const int r0 = row0(t);
    warp_rows<D>(ring + 2 * st * TILE, p.q, it.b, it.h, r0, p.T, p.H, lane);
    warp_rows<D>(ring + (2 * st + 1) * TILE, p.dout, it.b, it.h, r0, p.T,
                 p.H, lane);
    // lanes 0-15 the rows' lse, lanes 16-31 their delta
    const float* src = lane < SR ? p.lse : p.delta;
    cp4(saddr(stats + (2 * st + lane / SR) * SR + lane % SR),
        src + bh * p.T + r0 + lane % SR, true);
  };
  warp_rows<D>(ks, p.k, it.b, it.h, c0, p.T, p.H, lane);
  warp_rows<D>(vs, p.v, it.b, it.h, c0, p.T, p.H, lane);
  cp_commit();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (t0 + i < n) load(t0 + i);
    cp_commit();
  }

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

  for (int t = t0; t < n; ++t) {
    if (t + NST - 1 < n) load(t + NST - 1);
    cp_commit();
    cp_wait<NST - 1>();
    __syncwarp();
    const int st = t % NST;
    const bf16_t* qt = ring + 2 * st * TILE;
    const bf16_t* dot = qt + TILE;
    const float* lt = stats + 2 * st * SR;
    const float* dlt = lt + SR;

    // transposed tiles: row = a key (c0 + ...), column = a query
    float sT[2][4], dpt[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ka[4], qb[4];
      ldsm(ka, a_addr<D>(ks, 0, kk, lane));
      ldsm(qb, b_addr<D>(qt, 0, kk, lane));
      mma(sT[0], ka, qb[0], qb[1]);
      mma(sT[1], ka, qb[2], qb[3]);
      if constexpr (WANT_DK) {
        uint32_t va[4], db[4];
        ldsm(va, a_addr<D>(vs, 0, kk, lane));
        ldsm(db, b_addr<D>(dot, 0, kk, lane));
        mma(dpt[0], va, db[0], db[1]);
        mma(dpt[1], va, db[2], db[3]);
      }
    }

    // the step on the diagonal: query r0 + qi is hidden from key c0 + kr
    // when qi < kr
    const bool diag = p.causal && row0(t) == c0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
        float pe = ex2(fmaf(sT[j][e], sl2, -lse_offset(lt[qi]) * LOG2E));
        if (diag && qi < (lane >> 2) + 8 * (e >> 1)) pe = 0.f;
        sT[j][e] = pe;                            // P^T
        dpt[j][e] = pe * (dpt[j][e] - dlt[qi]);  // dS^T
      }

    uint32_t ap[4], as[4];
    c_to_a(ap, sT[0], sT[1]);
    c_to_a(as, dpt[0], dpt[1]);
#pragma unroll
    for (int dj = 0; dj < ND / 2; ++dj) {
      if constexpr (WANT_DV) {
        uint32_t db[4];
        ldsm_t(db, bt_addr<D>(dot, 0, dj, lane));
        mma(dv[2 * dj], ap, db[0], db[1]);
        mma(dv[2 * dj + 1], ap, db[2], db[3]);
      }
      if constexpr (WANT_DK) {
        uint32_t qb[4];
        ldsm_t(qb, bt_addr<D>(qt, 0, dj, lane));
        mma(dk[2 * dj], as, qb[0], qb[1]);
        mma(dk[2 * dj + 1], as, qb[2], qb[3]);
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  // a split item's partial: dK [16][D] (unscaled), then dV [16][D]
  float* part = it.part < 0
                    ? nullptr
                    : p.scratch + static_cast<size_t>(it.part) * 2 * SR * D;
  bf16_t* dkp = static_cast<bf16_t*>(p.out);
  bf16_t* dvp = static_cast<bf16_t*>(p.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (lane >> 2) + 8 * i;
    if (part != nullptr) {
      float* dst = part + r * D + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if constexpr (WANT_DK)
          *reinterpret_cast<float2*>(dst + 8 * d) =
              make_float2(dk[d][2 * i], dk[d][2 * i + 1]);
        if constexpr (WANT_DV)
          *reinterpret_cast<float2*>(dst + SR * D + 8 * d) =
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
// launch: ceil(strips / 4) blocks of 4 warps, then the merge of the split
// walks (when there are any) on the same stream
// ---------------------------------------------------------------------------

template <int D>
struct LaunchStrips {
  static int launch(Which which, const Params& p, cudaStream_t stream) {
    constexpr int E = static_cast<int>(sizeof(bf16_t));
    constexpr int TILE = tile_elems<D>(), NST = stages<D>();
    if (!work_list_ok(p, SR)) return static_cast<int>(cudaErrorInvalidValue);
    const long long strips =
        static_cast<long long>(p.n_work) * (p.block / SR) * p.B;
    const dim3 grid(static_cast<unsigned>((strips + WARPS - 1) / WARPS));
    const int lists = WARPS * list_ints(p) * 4;
    int err;
    if (which == FWD) {
      err = run<strip_fwd_kernel<D>>(
          p, grid, STRIP_THREADS, WARPS * (1 + 2 * NST) * TILE * E + lists,
          stream);
    } else if (which == DQ) {
      err = run<strip_dq_kernel<D>>(
          p, grid, STRIP_THREADS, WARPS * (2 + 2 * NST) * TILE * E + lists,
          stream);
    } else {
      const int bytes = WARPS * (2 + 2 * NST) * TILE * E +
                        WARPS * NST * 2 * SR * 4 + lists;
      if constexpr (D <= 128) {
        err = run<strip_dkv_kernel<D, BOTH>>(p, grid, STRIP_THREADS, bytes,
                                             stream);
      } else {
        err = run<strip_dkv_kernel<D, DV_ONLY>>(p, grid, STRIP_THREADS,
                                                bytes, stream);
        if (err == 0)
          err = run<strip_dkv_kernel<D, DK_ONLY>>(p, grid, STRIP_THREADS,
                                                  bytes, stream);
      }
    }
    return err != 0 ? err : run_merge<D, SR>(which, p, stream);
  }
};

int dispatch(Which which, Params& p, int D, int bf16, void* stream) {
  if (!bf16 || p.block <= 0 || p.block % SR != 0 || p.T % p.block != 0 ||
      p.A <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nb = p.T / p.block;
  return by_head_dim<LaunchStrips>(D, which, p,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entries for ctypes, with the arguments of block_sparse_attention.cu's
// (see there): bf16 only (bf16 must be 1), any block that is a multiple of
// 16 dividing T, D 64, 80, 96, 128 or 256; scratch fp32, slots * block * B
// * (D + 2) floats for the forward, * D for dQ, * 2 D for dK/dV, or null
// when n_merge is 0. Each returns cudaGetLastError() after its last launch
// (0 = launched).
extern "C" int block_sparse_strips_fwd(
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

extern "C" int block_sparse_strips_bwd_dq(
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

extern "C" int block_sparse_strips_bwd_dkv(
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
