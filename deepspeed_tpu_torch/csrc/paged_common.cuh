// The split-key walk over a paged KV pool shared by the unified ragged
// kernel (ragged_attention.cu, K6) and the paged decode and chunked-prefill
// kernels (paged_attention.cu, K7a and K7b), hand-written for Hopper
// (sm_90a).
//
// The pool is k/v [N, Hkv, 16, D] (bf16/fp32, or int8 with fp32 scales
// [N, Hkv, 16]) addressed through a block table [rows, nb]; an entry
// outside [0, N) is clamped to page N - 1. Query head kvh * G + g reads kv
// head kvh. A block runs one work item: a tile of one row's tokens (one
// token, or a chunk of them), one kv head, and one split, i.e. a range of
// whole 64-key tiles (four pages) of that row's key axis. It writes either
// the output (the item is its tokens' only split) or an fp32 partial per
// (token, head): the running max m in log2 units, the sum l and the
// unnormalised accumulator, which merge_kernel combines in split order.
//
// Inside an item:
// - tiles are gathered page by page through the table into a cp.async
//   ring (tensor cores: TC_STAGES deep, the split's page ids staged in
//   shared memory first; CUDA cores: 2 deep); pages that hold no key in
//   the item's visible range [lo, hi] are zero-filled without a read;
// - keys outside [lo, hi] never reach a sum: their scores are replaced by
//   -inf (a select, not arithmetic) and their V rows are zeroed in shared
//   memory (bf16), their P * scale selected to 0 (int8) or skipped (CUDA
//   cores), so a NaN in a recycled page's tail or in the clamped sentinel
//   page cannot leak (0 x NaN is NaN);
// - tc_decode (bf16 q, a narrow item: tokens x G heads <= 16 rows, e.g.
//   one decode token): K4's mapping. The rows are padded to 16 and held
//   in registers as the A operand of mma.sync m16n8k16; warp w takes page
//   w of every tile with its own running state (causal limits per row when
//   the item holds several tokens), and the four warps merge at the end.
//   P.V takes bf16(P) + bf16(P - bf16(P)).
// - tc_chunk (bf16 q, a chunk): K1's mapping. 64 rows = 64 / G tokens x G
//   heads, four warps of 16 rows each over the whole tile; causal and
//   window limits per row on the tiles that need them; P.V as in
//   tc_decode (K1's bf16 P alone missed the bf16 tolerance here).
// - both take a bf16 pool, or an int8 pool (I8) whose codes are converted
//   to bf16 in shared memory (exactly: they are integers below 128), with
//   the K scale on the fp32 score and the V scale folded into P;
// - cc_item (fp32 q): exact fp32 FMA on CUDA cores over MR rows (8 for a
//   narrow item, 32 for a chunk), as K4's decode_split_kernel: scores per (row,
//   key), one warp per row for the online softmax, P.V with a column per
//   thread; int8 codes times their per-key scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int PAGE = 16;          // tokens of a pool page
constexpr int BK = 64;            // keys of a tile
constexpr int PPT = BK / PAGE;    // pages of a tile
constexpr int THREADS = 128;
constexpr int MAXG = 8;           // most query heads of a K7a token
constexpr int NARROW = 16;        // rows of a tensor-core narrow item
constexpr int TC_ROWS = 64;       // rows of a tensor-core chunk item
constexpr int CC_ROWS = 32;       // rows of a CUDA-core chunk item
constexpr int NSTAGE = 2;         // tiles in flight on the CUDA cores
constexpr int TC_STAGES = 3;      // tiles in flight on the tensor cores
constexpr int PID_CACHE = 128;    // page ids of a split staged in shared
                                  // memory (the first 32 tiles)
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

struct Pool {
  const void* q;     // [*, H, D]: token stride H * D
  const void* k;     // [N, Hkv, 16, D]
  const void* v;
  const float* ks;   // [N, Hkv, 16] (int8 pool)
  const float* vs;
  const int* bt;     // [rows, nb]
  void* out;         // [*, H, D] in q's type
  float* part_o;     // [*, H, nsplit, D]: unnormalised accumulators
  float* part_ml;    // [*, H, nsplit, 2]: m (log2 units), l
  int H, Hkv, N, nb, G, window;  // window <= 0: none
  int nsplit, per;               // split slots of a row; tiles of a split
  float sl2;                     // sm_scale * log2(e)
};

struct Item {
  int row, kvh;
  int tok0, ntok;  // q / out index of the first token, tokens
  int pos0;        // position of the first token
  int clen;        // the row's context length
  int lo, hi;      // keys some token of the item sees
  int t0, t1;      // the split's tiles [t0, t1), inside [lo, hi]
  int slot;        // partial slot, or -1: write the output
};

// keys [lo, hi] that some token at positions [pos0, pos0 + ntok) of a row
// with clen keys sees (hi < lo: none); the table addresses nb * 16 keys
__device__ __forceinline__ void key_range(const Pool& p, int pos0, int ntok,
                                          int clen, int& lo, int& hi) {
  hi = min(min(pos0 + ntok, clen), p.nb * PAGE) - 1;
  lo = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
}

// does the token at pos see key?
__device__ __forceinline__ bool sees(const Pool& p, int pos, int clen,
                                     int key) {
  return key <= pos && key < clen && key < p.nb * PAGE &&
         (p.window <= 0 || pos - key < p.window);
}

// the [16, D] block of (table entry `page` of `row`, kv head kvh)
__device__ __forceinline__ size_t page_block(const Pool& p, int row, int page,
                                             int kvh) {
  int pid = p.bt[static_cast<size_t>(row) * p.nb + page];
  if (pid < 0 || pid >= p.N) pid = p.N - 1;  // unallocated: clamp
  return static_cast<size_t>(pid) * p.Hkv + kvh;
}

// does a tile-row's page hold a key in [lo, hi]?
__device__ __forceinline__ bool page_in(const Item& it, int key) {
  const int first = key & ~(PAGE - 1);
  return first <= it.hi && first + PAGE - 1 >= it.lo;
}

__device__ __forceinline__ size_t part_row(const Pool& p, int tok, int head,
                                           int slot) {
  return (static_cast<size_t>(tok) * p.H + head) * p.nsplit + slot;
}

// an item whose split sees no key: zeros for the output, or an empty
// partial (m = -inf, l = 0) the merge skips
template <typename QT>
__device__ void empty_item(const Pool& p, const Item& it, int D) {
  const int rows = it.ntok * p.G;
  if (it.slot < 0) {
    for (int e = threadIdx.x; e < rows * D; e += THREADS) {
      const int r = e / D;
      store(static_cast<QT*>(p.out) +
                (static_cast<size_t>(it.tok0 + r / p.G) * p.H + it.kvh * p.G +
                 r % p.G) * D + e % D,
            0.f);
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      float* ml = p.part_ml + 2 * part_row(p, it.tok0 + r / p.G,
                                           it.kvh * p.G + r % p.G, it.slot);
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// tensor cores: bf16 q over a bf16 pool, or over an int8 pool (I8)
// ---------------------------------------------------------------------------
//
// An int8 pool's codes are integers in [-127, 127], exact in bf16, so its
// tiles are converted to bf16 in shared memory after they land; the K
// scale multiplies the fp32 score and the V scale folds into P (fp32)
// before P's bf16 hi + lo split. The scores are the fp32 products of the
// CUDA-core route up to summation order, P.V keeps ~16 bits of P * scale.

template <int D, int ROWS = TC_ROWS, bool I8 = false>
struct TcLayout {
  static constexpr int TILE = BK * D * (I8 ? 1 : 2);  // a raw K or V tile
  static constexpr int STAGE = 2 * TILE + (I8 ? 2 * BK * 4 : 0);  // + scales
  static constexpr int PID = ROWS * D * 2;            // after q
  static constexpr int RING = PID + PID_CACHE * 4;    // after the ids
  static constexpr int CONV = RING + TC_STAGES * STAGE;  // I8: bf16 K, V
  static constexpr int BYTES = CONV + (I8 ? 2 * BK * D * 2 : 0);
  // after the walk a narrow item's ring holds the warps' partials:
  // o [4][NARROW][D], then m and l [4][NARROW] each
  static_assert(4 * NARROW * D * 4 + 2 * 4 * NARROW * 4 <= TC_STAGES * STAGE,
                "partials fit in the ring");
  static_assert(STAGE % 16 == 0 && RING % 16 == 0, "16-byte alignment");
};

// stage the pool page of each table entry of the split's tiles (clamped;
// entries past the table read as page N - 1, never loaded) in pid_s, up to
// PID_CACHE of them; the caller synchronises before the first use
__device__ __forceinline__ void stage_pids(const Pool& p, const Item& it,
                                           int* pid_s) {
  const int n = min((it.t1 - it.t0) * PPT, PID_CACHE);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int page = it.t0 * PPT + i;
    int pid = page < p.nb ? p.bt[static_cast<size_t>(it.row) * p.nb + page]
                          : p.N - 1;
    if (pid < 0 || pid >= p.N) pid = p.N - 1;  // unallocated: clamp
    pid_s[i] = pid;
  }
}

// the [16, D] block of page pg of tile t: from pid_s, or the table past
// PID_CACHE entries
__device__ __forceinline__ size_t tile_block(const Pool& p, const Item& it,
                                             const int* pid_s, int t,
                                             int pg) {
  const int i = (t - it.t0) * PPT + pg;
  return i < PID_CACHE ? static_cast<size_t>(pid_s[i]) * p.Hkv + it.kvh
                       : page_block(p, it.row, t * PPT + pg, it.kvh);
}

// start copying tile t of the item into a ring stage: bf16 as swizzled K
// and V tiles (a thread's x-th chunk lies in page x * (THREADS / CH) /
// PAGE, so each thread looks its four pages up once); int8 as raw rows
// plus the K and V scales. Pages with no key in [lo, hi] are zero-filled.
template <int D, bool I8>
__device__ __forceinline__ void tc_load_tile(const Pool& p, const Item& it,
                                             int t, const int* pid_s,
                                             unsigned char* st) {
  using L = TcLayout<D, TC_ROWS, I8>;
  if constexpr (!I8) {
    constexpr int CH = D / 8;           // 16-byte chunks of a row
    constexpr int RPP = THREADS / CH;   // rows of one pass of the block
    static_assert(RPP <= PAGE && PAGE % RPP == 0, "a pass within a page");
    const bf16_t* kg = static_cast<const bf16_t*>(p.k);
    const bf16_t* vg = static_cast<const bf16_t*>(p.v);
    bf16_t* kt = reinterpret_cast<bf16_t*>(st);
    bf16_t* vt = reinterpret_cast<bf16_t*>(st + L::TILE);
    size_t base[PPT];
    bool in[PPT];
#pragma unroll
    for (int pg = 0; pg < PPT; ++pg) {
      in[pg] = page_in(it, t * BK + pg * PAGE);
      base[pg] = in[pg] ? tile_block(p, it, pid_s, t, pg) * (PAGE * D) : 0;
    }
    const int ch = threadIdx.x % CH;
#pragma unroll
    for (int x = 0; x < BK * CH / THREADS; ++x) {
      const int r = threadIdx.x / CH + x * RPP;
      const int pg = x * RPP / PAGE;
      const size_t src =
          in[pg] ? base[pg] + static_cast<size_t>(r % PAGE) * D + ch * 8 : 0;
      cp16(saddr(kt + swz<D>(r, ch)), kg + src, in[pg]);
      cp16(saddr(vt + swz<D>(r, ch)), vg + src, in[pg]);
    }
  } else {
    constexpr int CH = D / 16;          // 16-byte chunks of a code row
    const unsigned char* kg = static_cast<const unsigned char*>(p.k);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v);
#pragma unroll
    for (int x = 0; x < BK * CH / THREADS; ++x) {
      const int c = threadIdx.x + x * THREADS;
      const int r = c / CH;
      const bool in = page_in(it, t * BK + r);
      const size_t src =
          in ? (tile_block(p, it, pid_s, t, r / PAGE) * PAGE + r % PAGE) * D +
                   (c % CH) * 16
             : 0;
      cp16(saddr(st + r * D + (c % CH) * 16), kg + src, in);
      cp16(saddr(st + L::TILE + r * D + (c % CH) * 16), vg + src, in);
    }
    if (threadIdx.x < BK) {
      const int r = threadIdx.x;
      const bool in = page_in(it, t * BK + r);
      const size_t at =
          in ? tile_block(p, it, pid_s, t, r / PAGE) * PAGE + r % PAGE : 0;
      cp4(saddr(st + 2 * L::TILE + r * 4), p.ks + at, in);
      cp4(saddr(st + 2 * L::TILE + BK * 4 + r * 4), p.vs + at, in);
    }
  }
}

// the ring's first TC_STAGES - 1 tiles (q, already in flight, joins the
// first group)
template <int D, bool I8>
__device__ __forceinline__ void tc_prologue(const Pool& p, const Item& it,
                                            const int* pid_s,
                                            unsigned char* ring) {
  using L = TcLayout<D, TC_ROWS, I8>;
  const int ntiles = it.t1 - it.t0;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ntiles)
      tc_load_tile<D, I8>(p, it, it.t0 + s, pid_s, ring + s * L::STAGE);
    cp_commit();
  }
}

// before tile i's compute: start tile i + TC_STAGES - 1, wait for tile i;
// returns its stage. I8: its codes converted into the bf16 tiles at conv.
template <int D, bool I8>
__device__ __forceinline__ unsigned char* tc_advance(const Pool& p,
                                                     const Item& it,
                                                     const int* pid_s,
                                                     unsigned char* ring,
                                                     bf16_t* conv, int i) {
  using L = TcLayout<D, TC_ROWS, I8>;
  const int next = i + TC_STAGES - 1;
  if (next < it.t1 - it.t0)
    tc_load_tile<D, I8>(p, it, it.t0 + next, pid_s,
                        ring + (next % TC_STAGES) * L::STAGE);
  cp_commit();
  cp_wait<TC_STAGES - 1>();
  __syncthreads();  // tile i (and q) landed
  unsigned char* st = ring + (i % TC_STAGES) * L::STAGE;
  if constexpr (I8) {
    constexpr int CH = D / 16;
    for (int c = threadIdx.x; c < 2 * BK * CH; c += THREADS) {
      const int kv = c / (BK * CH);      // 0: K, 1: V
      const int r = (c / CH) % BK;
      const int ch = c % CH;
      const uint4 w =
          *reinterpret_cast<const uint4*>(st + kv * L::TILE + r * D + ch * 16);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t word = words[e / 2];
        const int sh = 16 * (e % 2);
        b[e] = pack(static_cast<float>(static_cast<int8_t>(word >> sh)),
                    static_cast<float>(static_cast<int8_t>(word >> (sh + 8))));
      }
      bf16_t* dst = conv + kv * BK * D;
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch)) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch + 1)) =
          make_uint4(b[4], b[5], b[6], b[7]);
    }
    __syncthreads();
  }
  return st;
}

// the bf16 K and V tiles of a landed stage
template <int D, bool I8>
__device__ __forceinline__ bf16_t* tc_k(unsigned char* st, bf16_t* conv) {
  return I8 ? conv : reinterpret_cast<bf16_t*>(st);
}
template <int D, bool I8>
__device__ __forceinline__ bf16_t* tc_v(unsigned char* st, bf16_t* conv) {
  return I8 ? conv + BK * D
            : reinterpret_cast<bf16_t*>(st + TcLayout<D, TC_ROWS, I8>::TILE);
}

// the per-key K and V scales of a landed I8 stage
template <int D>
__device__ __forceinline__ const float* tc_scales(const unsigned char* st) {
  return reinterpret_cast<const float*>(st +
                                        2 * TcLayout<D, TC_ROWS, true>::TILE);
}

// a narrow item: ntok tokens x G heads <= 16 rows (row g: token g / G,
// head kvh * G + g % G), padded to 16; warp w takes page w of every tile
template <int D, bool I8>
__device__ void tc_decode(const Pool& p, const Item& it, unsigned char* smem) {
  using L = TcLayout<D, NARROW, I8>;
  constexpr int KT = D / 16, ND = D / 8, CH = D / 8;
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem);
  int* pid_s = reinterpret_cast<int*>(smem + L::PID);
  unsigned char* ring = smem + L::RING;
  bf16_t* conv = reinterpret_cast<bf16_t*>(smem + L::CONV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = p.G;
  const int rows = it.ntok * G;
  const int ntiles = it.t1 - it.t0;

  {
    const bf16_t* q = static_cast<const bf16_t*>(p.q);
    for (int c = tid; c < NARROW * CH; c += THREADS) {
      const int r = c / CH;
      const size_t src =
          r < rows ? (static_cast<size_t>(it.tok0 + r / G) * p.H +
                      it.kvh * G + r % G) * D + (c % CH) * 8
                   : 0;
      cp16(saddr(qs + swz<D>(r, c % CH)), q + src, r < rows);
    }
  }
  stage_pids(p, it, pid_s);
  __syncthreads();
  tc_prologue<D, I8>(p, it, pid_s, ring);

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[KT][4];

  for (int i = 0; i < ntiles; ++i) {
    unsigned char* st = tc_advance<D, I8>(p, it, pid_s, ring, conv, i);
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) ldsm(qf[kk], a_addr<D>(qs, 0, kk, lane));
    }
    bf16_t* kt = tc_k<D, I8>(st, conv);
    bf16_t* vt = tc_v<D, I8>(st, conv);
    const int r0 = warp * 16;  // this warp's page of the tile
    const int key = (it.t0 + i) * BK + r0 + (lane & 15);
    const bool ok = key >= it.lo && key <= it.hi;
    const uint32_t bits = __ballot_sync(~0u, ok) & 0xFFFFu;
    if (bits != 0) {
      if (!I8 && bits != 0xFFFFu) {
        // zero the V rows of keys outside [lo, hi]: they never reach a sum
        // (I8: their codes are finite and their P * scale is a select)
        for (int c = lane; c < 16 * CH; c += 32) {
          const int r = c / CH;
          if (!((bits >> r) & 1))
            *reinterpret_cast<uint4*>(vt + swz<D>(r0 + r, c % CH)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      // two accumulators per n8 tile (even and odd k-steps) halve the
      // dependent mma chain
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 2) {
        uint32_t kb[4], kb2[4];
        ldsm(kb, b_addr<D>(kt, r0, kk, lane));
        ldsm(kb2, b_addr<D>(kt, r0, kk + 1, lane));
        mma(s[0], qf[kk], kb[0], kb[1]);
        mma(s[1], qf[kk], kb[2], kb[3]);
        mma(s2[0], qf[kk + 1], kb2[0], kb2[1]);
        mma(s2[1], qf[kk + 1], kb2[2], kb2[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      const float* ksc = I8 ? tc_scales<D>(st) + r0 : nullptr;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * (lane & 3) + (e & 1);
          // one token: [lo, hi] is its visible range; more: causal per row
          const int row = (lane >> 2) + 8 * (e >> 1);
          bool vis = (bits >> col) & 1;
          if (it.ntok > 1)
            vis = vis && row < rows &&
                  sees(p, it.pos0 + row / G, it.clen, key - (lane & 15) + col);
          float x = -INFINITY;
          if (vis) x = (I8 ? s[j][e] * ksc[col] : s[j][e]) * p.sl2;
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
      if constexpr (I8) {
        const float* vsc = tc_scales<D>(st) + BK + r0;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * (lane & 3) + (e & 1);
            s[j][e] = (bits >> col) & 1 ? s[j][e] * vsc[col] : 0.f;
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

  // the four warps' partials -> shared memory (rows < ntok * G), then one
  // per row
  float* po = reinterpret_cast<float*>(ring);  // [4][NARROW][D]
  float* pm = po + 4 * NARROW * D;             // [4][NARROW]
  float* pl = pm + 4 * NARROW;                 // [4][NARROW]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int g = (lane >> 2) + 8 * h;
    if (g >= rows) continue;
    if ((lane & 3) == 0) {
      pm[warp * NARROW + g] = m_run[h];
      pl[warp * NARROW + g] = l;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * (lane & 3);
      po[(warp * NARROW + g) * D + col] = o[d][2 * h];
      po[(warp * NARROW + g) * D + col + 1] = o[d][2 * h + 1];
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, pm[w * NARROW + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = pm[w * NARROW + g];
        if (mw == -INFINITY) continue;
        const float a = ex2(mw - m);
        acc += a * po[(w * NARROW + g) * D + d];
        l += a * pl[w * NARROW + g];
      }
    }
    const int tok = it.tok0 + g / G;
    const int head = it.kvh * G + g % G;
    if (it.slot < 0) {
      store(static_cast<bf16_t*>(p.out) +
                (static_cast<size_t>(tok) * p.H + head) * D + d,
            l == 0.f ? 0.f : acc / l);
    } else {
      const size_t row = part_row(p, tok, head, it.slot);
      p.part_o[row * D + d] = acc;
      if (d == 0) {
        p.part_ml[2 * row] = m;
        p.part_ml[2 * row + 1] = l;
      }
    }
  }
}

// a chunk: 64 rows (64 / G tokens x G heads), warp w rows 16w .. 16w + 15
template <int D, bool I8>
__device__ void tc_chunk(const Pool& p, const Item& it, unsigned char* smem) {
  using L = TcLayout<D, TC_ROWS, I8>;
  constexpr int KT = D / 16, ND = D / 8, CH = D / 8, NS = BK / 8;
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem);
  int* pid_s = reinterpret_cast<int*>(smem + L::PID);
  unsigned char* ring = smem + L::RING;
  bf16_t* conv = reinterpret_cast<bf16_t*>(smem + L::CONV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = p.G;
  const int ntiles = it.t1 - it.t0;

  {
    const bf16_t* q = static_cast<const bf16_t*>(p.q);
    for (int c = tid; c < TC_ROWS * CH; c += THREADS) {
      const int r = c / CH;
      const bool in = r / G < it.ntok;
      const size_t src =
          in ? (static_cast<size_t>(it.tok0 + r / G) * p.H + it.kvh * G +
                r % G) * D + (c % CH) * 8
             : 0;
      cp16(saddr(qs + swz<D>(r, c % CH)), q + src, in);
    }
  }
  stage_pids(p, it, pid_s);
  __syncthreads();
  tc_prologue<D, I8>(p, it, pid_s, ring);

  // keys every live row sees: [lo_all, hi_all]
  const int pos_last = it.pos0 + it.ntok - 1;
  const int hi_all = min(min(it.pos0, it.clen - 1), p.nb * PAGE - 1);
  const int lo_all = p.window > 0 ? max(0, pos_last - p.window + 1) : 0;

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[KT][4];
  int tok_of[2];                            // token of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) tok_of[i] = (warp * 16 + (lane >> 2) + 8 * i) / G;

  for (int i = 0; i < ntiles; ++i) {
    unsigned char* st = tc_advance<D, I8>(p, it, pid_s, ring, conv, i);
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm(qf[kk], a_addr<D>(qs, warp * 16, kk, lane));
    }
    bf16_t* kt = tc_k<D, I8>(st, conv);
    bf16_t* vt = tc_v<D, I8>(st, conv);
    const int c0 = (it.t0 + i) * BK;
    if (!I8 && (c0 < it.lo || c0 + BK - 1 > it.hi)) {
      // zero the V rows of keys outside [lo, hi] (uniform branch; I8:
      // their codes are finite and their P * scale is a select)
      for (int c = tid; c < BK * CH; c += THREADS) {
        const int key = c0 + c / CH;
        if (key < it.lo || key > it.hi)
          *reinterpret_cast<uint4*>(vt + swz<D>(c / CH, c % CH)) =
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
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int nj = 0; nj < NS / 2; ++nj) {
        uint32_t kb[4];
        ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
        mma(s[2 * nj], qf[kk], kb[0], kb[1]);
        mma(s[2 * nj + 1], qf[kk], kb[2], kb[3]);
      }

    const float* ksc = I8 ? tc_scales<D>(st) : nullptr;
    const bool edge = c0 < lo_all || c0 + BK - 1 > hi_all;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * (lane & 3) + (e & 1);
        float x = (I8 ? s[j][e] * ksc[col] : s[j][e]) * p.sl2;
        if (edge) {
          const int tok = tok_of[e >> 1];
          if (tok >= it.ntok || !sees(p, it.pos0 + tok, it.clen, c0 + col))
            x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      const float alpha = ex2(m_run[h] - base[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * h] *= alpha;
        o[d][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
    if constexpr (I8) {
      const float* vsc = tc_scales<D>(st) + BK;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + j * 8 + 2 * (lane & 3) + (e & 1);
          s[j][e] = key >= it.lo && key <= it.hi
                        ? s[j][e] * vsc[key - c0]
                        : 0.f;
        }
    }
    // P = hi + lo, both bf16 (bf16 P alone misses the bf16 tolerance)
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
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const int tok = tok_of[h];
    if (tok >= it.ntok) continue;
    const int head = it.kvh * G + r % G;
    const int col = 2 * (lane & 3);
    if (it.slot < 0) {
      const float inv = l == 0.f ? 0.f : 1.f / l;
      bf16_t* dst = static_cast<bf16_t*>(p.out) +
                    (static_cast<size_t>(it.tok0 + tok) * p.H + head) * D +
                    col;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
            __floats2bfloat162_rn(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
    } else {
      const size_t row = part_row(p, it.tok0 + tok, head, it.slot);
      float* dst = p.part_o + row * D + col;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(o[d][2 * h], o[d][2 * h + 1]);
      if ((lane & 3) == 0) {
        p.part_ml[2 * row] = m_run[h];
        p.part_ml[2 * row + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: fp32 q and pool, or an int8 pool; exact fp32
// ---------------------------------------------------------------------------

template <typename KT, int D, int MR>
struct CcLayout {
  static constexpr bool INT8 = sizeof(KT) == 1;
  static constexpr int RS = D * sizeof(KT) + 16;  // padded ring row, bytes
  static constexpr int TILE = BK * RS;
  static constexpr int SCALES = INT8 ? BK * 4 : 0;
  // stage: K tile | V tile | k scales | v scales
  static constexpr int STAGE = 2 * TILE + 2 * SCALES;
  static constexpr int QF = 0;                      // float [MR][D]
  static constexpr int SP = QF + MR * D * 4;        // float [MR][BK]
  static constexpr int MRUN = SP + MR * BK * 4;     // float [MR]
  static constexpr int LRUN = MRUN + MR * 4;        // float [MR]
  static constexpr int ALPHA = LRUN + MR * 4;       // float [MR]
  static constexpr int VALID = ALPHA + MR * 4;      // int [BK]
  static constexpr int RING = (VALID + BK * 4 + 15) / 16 * 16;
  static constexpr int BYTES = RING + NSTAGE * STAGE;
  static_assert(STAGE % 16 == 0, "stage size must keep alignment");
  static_assert(BYTES <= MAX_SMEM, "shared memory of one block");
};

// four consecutive elements of a ring row as floats
__device__ __forceinline__ float4 load4(const unsigned char* row, int d4,
                                        float) {
  return reinterpret_cast<const float4*>(row)[d4];
}
__device__ __forceinline__ float4 load4(const unsigned char* row, int d4,
                                        int8_t) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(row)[d4];
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xFF)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xFF)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xFF)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

// MR rows: row g is token g / G, head kvh * G + g % G
template <typename QT, typename KT, int D, int MR>
__device__ void cc_item(const Pool& p, const Item& it, unsigned char* smem) {
  using L = CcLayout<KT, D, MR>;
  constexpr int NRG = THREADS / D;  // row groups in P.V (1 or 2)
  constexpr int RPT = MR / NRG;     // rows per thread in P.V
  constexpr int SRG = THREADS / BK; // row groups in the scores (2)
  constexpr int CH = D * sizeof(KT) / 16;  // 16-byte chunks of a row
  const int tid = threadIdx.x;
  const int G = p.G;
  const int live = it.ntok * G;     // rows < live hold a token
  const int ntiles = it.t1 - it.t0;

  float* qf = reinterpret_cast<float*>(smem + L::QF);
  float* sp = reinterpret_cast<float*>(smem + L::SP);
  float* m_run = reinterpret_cast<float*>(smem + L::MRUN);
  float* l_run = reinterpret_cast<float*>(smem + L::LRUN);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);
  unsigned char* ring = smem + L::RING;

  // tile t -> stage s; pages with no key in [lo, hi] read as zeros
  auto issue = [&](int t, int s) {
    unsigned char* st = ring + s * L::STAGE;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v);
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH;
      const bool in = page_in(it, t * BK + r);
      size_t src = 0;
      if (in)
        src = (page_block(p, it.row, t * PPT + r / PAGE, it.kvh) * PAGE +
               r % PAGE) * (D * sizeof(KT)) + (c % CH) * 16;
      const int off = r * L::RS + (c % CH) * 16;
      cp16(saddr(st + off), kg + src, in);
      cp16(saddr(st + L::TILE + off), vg + src, in);
    }
    if (L::INT8 && tid < BK) {
      const bool in = page_in(it, t * BK + tid);
      const size_t at =
          in ? page_block(p, it.row, t * PPT + tid / PAGE, it.kvh) * PAGE +
                   tid % PAGE
             : 0;
      unsigned char* tail = st + 2 * L::TILE;
      cp4(saddr(tail + tid * 4), p.ks + at, in);
      cp4(saddr(tail + L::SCALES + tid * 4), p.vs + at, in);
    }
  };

  issue(it.t0, 0);
  cp_commit();

  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < MR * D; e += THREADS) {
    const int g = e / D;
    float x = 0.f;
    if (g < live)
      x = to_float(q[(static_cast<size_t>(it.tok0 + g / G) * p.H +
                      it.kvh * G + g % G) * D + e % D]);
    qf[e] = x;
  }
  if (tid < MR) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }

  const int c = tid % D;     // P.V: column c of rows rgp + NRG * a
  const int rgp = tid / D;
  float acc[RPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a) acc[a] = 0.f;
  const int j = tid % BK;    // scores: key j of rows sg + SRG * a
  const int sg = tid / BK;

  for (int i = 0; i < ntiles; ++i) {
    cp_wait<0>();
    __syncthreads();  // tile i landed; tile i - 1's P.V is done, so its
                      // stage takes tile i + 1
    if (i + 1 < ntiles) issue(it.t0 + i + 1, (i + 1) % NSTAGE);
    cp_commit();

    const unsigned char* st = ring + (i % NSTAGE) * L::STAGE;
    const unsigned char* kr = st;
    const unsigned char* vr = st + L::TILE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE);
    const float* vsc = ksc + BK;
    const int kv0 = (it.t0 + i) * BK;
    if (tid < BK) valid_s[tid] = kv0 + tid >= it.lo && kv0 + tid <= it.hi;

    // scores in log2 units; a (row, key) the row does not see gets -inf
    {
      const int key = kv0 + j;
      const bool any = key >= it.lo && key <= it.hi;
      float dot[MR / SRG];
#pragma unroll
      for (int a = 0; a < MR / SRG; ++a) dot[a] = 0.f;
      if (any) {
        const unsigned char* krow = kr + j * L::RS;
#pragma unroll 4
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kx = load4(krow, d4, KT());
#pragma unroll
          for (int a = 0; a < MR / SRG; ++a) {
            const int g = sg + SRG * a;
            if (g < live) {
              const float4 qx = reinterpret_cast<const float4*>(qf + g * D)[d4];
              dot[a] = fmaf(qx.x, kx.x, dot[a]);
              dot[a] = fmaf(qx.y, kx.y, dot[a]);
              dot[a] = fmaf(qx.z, kx.z, dot[a]);
              dot[a] = fmaf(qx.w, kx.w, dot[a]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MR / SRG; ++a) {
        const int g = sg + SRG * a;
        float s = -INFINITY;
        if (any && g < live && sees(p, it.pos0 + g / G, it.clen, key)) {
          float x = dot[a];
          if (L::INT8) x *= ksc[j];
          s = x * p.sl2;
        }
        sp[g * BK + j] = s;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ..., a lane two keys
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < live; g += THREADS / 32) {
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

    // acc = acc * alpha + P . V over the keys in [lo, hi] only
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int g = rgp + NRG * a;
      if (g < live) acc[a] *= alpha_s[g];
    }
    for (int key = 0; key < BK; ++key) {
      if (!valid_s[key]) continue;  // uniform across the block
      float vx = to_float(reinterpret_cast<const KT*>(vr + key * L::RS)[c]);
      if (L::INT8) vx *= vsc[key];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int g = rgp + NRG * a;
        if (g < live) acc[a] = fmaf(sp[g * BK + key], vx, acc[a]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int g = rgp + NRG * a;
    if (g >= live) continue;
    const int tok = it.tok0 + g / G;
    const int head = it.kvh * G + g % G;
    const float l = l_run[g];
    if (it.slot < 0) {
      store(static_cast<QT*>(p.out) + (static_cast<size_t>(tok) * p.H + head) *
                                          D + c,
            l == 0.f ? 0.f : acc[a] / l);
    } else {
      const size_t row = part_row(p, tok, head, it.slot);
      p.part_o[row * D + c] = acc[a];
      if (c == 0) {
        p.part_ml[2 * row] = m_run[g];
        p.part_ml[2 * row + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// merge: out[t, h] = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s over
// the token's splits [s_lo, s_lo + n), in split order
// ---------------------------------------------------------------------------

// One warp per (token, head), grid (tokens, ceil(H / 4)), combining the
// token's partial slots in split order (empty ones carry m = -inf and are
// skipped). info (K6): per token (s_lo << 16 | n); n == 0: zeros (no row
// claims the token, or its tile sees no key), n == 1: the walk wrote the
// output. nullptr (K7a): every token merges all nsplit slots.
template <typename QT>
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(Pool p,
                                                              const int* info,
                                                              int D) {
  const int t = blockIdx.x;
  const int h = blockIdx.y * (MERGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (h >= p.H) return;
  int s_lo = 0, n = p.nsplit;
  if (info != nullptr) {
    const int x = info[t];
    s_lo = x >> 16;
    n = x & 0xFFFF;
    if (n == 1) return;
  }
  QT* out = static_cast<QT*>(p.out) + (static_cast<size_t>(t) * p.H + h) * D;
  const size_t row0 = part_row(p, t, h, s_lo);
  const float* ml = p.part_ml + 2 * row0;
  const float* po = p.part_o + row0 * D;
  float m = -INFINITY;
  for (int s = 0; s < n; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // columns lane + 32 c
  if (m != -INFINITY)
    for (int s = 0; s < n; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;
      const float w = exp2f(ms - m);
      l += ml[2 * s + 1] * w;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (lane + 32 * c < D)
          acc[c] += po[static_cast<size_t>(s) * D + lane + 32 * c] * w;
    }
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (lane + 32 * c < D) store(out + lane + 32 * c, acc[c] * inv);
}

// merge_kernel's grid for `tokens` tokens
__host__ __forceinline__ dim3 merge_grid(int tokens, int H) {
  return dim3(tokens, (H + MERGE_THREADS / 32 - 1) / (MERGE_THREADS / 32));
}

// does (QT, KT) run on the tensor cores? bf16 q over a bf16 or int8 pool
template <typename QT, typename KT>
__host__ __device__ constexpr bool tensor_cores() {
  return sizeof(QT) == 2 && (sizeof(KT) == 2 || sizeof(KT) == 1);
}

// dispatch one item to its mapping: `narrow` items hold at most
// narrow_rows<QT, KT>() rows (tokens x heads)
template <typename QT, typename KT, int D>
__device__ __forceinline__ void run_item(const Pool& p, const Item& it,
                                         bool narrow, unsigned char* smem) {
  if constexpr (tensor_cores<QT, KT>()) {
    constexpr bool I8 = sizeof(KT) == 1;
    if (narrow)
      tc_decode<D, I8>(p, it, smem);
    else
      tc_chunk<D, I8>(p, it, smem);
  } else {
    if (narrow)
      cc_item<QT, KT, D, MAXG>(p, it, smem);
    else
      cc_item<QT, KT, D, CC_ROWS>(p, it, smem);
  }
}

// dynamic shared memory of run_item's kernel instance
template <typename QT, typename KT, int D>
constexpr int item_smem() {
  if constexpr (tensor_cores<QT, KT>())
    return TcLayout<D, TC_ROWS, sizeof(KT) == 1>::BYTES;
  else
    return CcLayout<KT, D, CC_ROWS>::BYTES > CcLayout<KT, D, MAXG>::BYTES
               ? CcLayout<KT, D, CC_ROWS>::BYTES
               : CcLayout<KT, D, MAXG>::BYTES;
}

// dynamic shared memory of a kernel that runs narrow items only
template <typename QT, typename KT, int D>
constexpr int narrow_smem() {
  if constexpr (tensor_cores<QT, KT>())
    return TcLayout<D, NARROW, sizeof(KT) == 1>::BYTES;
  else
    return CcLayout<KT, D, MAXG>::BYTES;
}

// rows of a chunk item on the route of (QT, KT)
template <typename QT, typename KT>
__host__ __device__ constexpr int chunk_rows() {
  return tensor_cores<QT, KT>() ? TC_ROWS : CC_ROWS;
}

// most rows of a narrow item on the route of (QT, KT)
template <typename QT, typename KT>
constexpr int narrow_rows() {
  return tensor_cores<QT, KT>() ? NARROW : MAXG;
}

}  // namespace
