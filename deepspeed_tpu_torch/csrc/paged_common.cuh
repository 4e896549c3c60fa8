// The split-key walk over a paged KV pool shared by the unified ragged
// kernel (ragged_attention.cu, K6) and the paged decode and chunked-prefill
// kernels (paged_attention.cu, K7a and K7b), hand-written for Hopper
// (sm_90a).
//
// The pool is k/v [N, Hkv, bs, D] (bf16/fp32, or int8 with fp32 scales
// [N, Hkv, bs]) for any page size bs >= 1 and D 64, 80, 96, 128 or 256,
// addressed through a block table [rows, nb]; an entry outside [0, N) is
// clamped to page N - 1. Query head kvh * G + g reads kv head kvh, for any
// whole group G. A block runs one work item: a tile of one row's tokens
// (one token, or a chunk of them), heads [g0, g0 + gn) of one kv head's
// group, and one split, i.e. a range of whole 64-key tiles of that row's
// key axis. It writes either the output (the item is its tokens' only
// split) or an fp32 partial per (token, head): the running max m in log2
// units, the sum l and the unnormalised accumulator, which merge_kernel
// combines in split order.
//
// Inside an item:
// - key k of a row lies in table entry k / bs, row k % bs of that page (a
//   shift where bs is a power of two). A tile's 64 keys are gathered
//   through the table into a cp.async ring (tensor cores: 3 tiles deep
//   where shared memory holds them, else 2; CUDA cores: 2, or 1 for fp32
//   at D 256), each pass of the block copying whole rows; the split's
//   table entries are staged in shared memory first (PID_CACHE of them,
//   later ones read from the table), and a tensor-core thread's keys are
//   consecutive, so where they share a page one lookup serves them all. Keys outside the item's visible range [lo, hi] are zero-filled
//   without a read and their scores are replaced by -inf (a select, not
//   arithmetic), so a NaN in a recycled page's tail or in the clamped
//   sentinel page cannot reach a sum (0 x NaN is NaN);
// - row r of an item is token r / gn, head kvh * G + g0 + r % gn. A chunk
//   item holds floor(rows / gn) tokens (G 7 on the tensor cores: 9 tokens x
//   7 heads = 63 of 64 rows); a group larger than the route's chunk rows is
//   cut into nch chunks of at most that many heads, one token an item, and
//   each chunk reads the tile again. Otherwise gn = G and each tile is
//   read once for the whole group;
// - tc_decode (bf16 q, a narrow item: tokens x heads <= 16 rows, e.g. one
//   decode token of a group up to 16): K4's mapping. The rows are padded to
//   16 and held as the A operand of mma.sync m16n8k16; warp w takes keys
//   16w..16w+15 of every tile with its own running state (causal limits
//   per row when the item holds several tokens), and the four warps merge
//   at the end. P.V takes bf16(P) + bf16(P - bf16(P)).
// - tc_chunk (bf16 q, any wider item: a chunk, or one token of a group over
//   16 heads): K1's mapping. 64 rows, four warps of 16 rows each over the
//   whole tile, as K4's decode_tc_multi_kernel (a warp whose rows all lie
//   past the item idles); causal and window limits per row on the tiles
//   that need them; P.V as in tc_decode (K1's bf16 P alone missed the bf16
//   tolerance here).
// - both take a bf16 pool, or an int8 pool (I8) whose codes are converted
//   to bf16 in shared memory (exactly: they are integers below 128), with
//   the K scale on the fp32 score and the V scale folded into P. Up to D
//   128 a warp's Q fragments stay in registers for the walk; at D 256 the
//   16 x 256 fp32 accumulator takes 128 registers a lane, so each k-step's
//   Q fragment is read from shared memory. Tiles are bf16 rows swizzled as
//   in tc_common.cuh (D 80 and 96: rows padded to D + 8);
// - cc_item (fp32 q): exact fp32 FMA on CUDA cores over MR rows (8 for a
//   narrow item, 32 for a chunk), as K4's decode_split_kernel: scores per
//   (row, key), one warp per row for the online softmax, P.V with a column
//   per thread (two at D 256); int8 codes times their per-key scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int BK = 64;            // keys of a tile
constexpr int THREADS = 128;
constexpr int NARROW = 16;        // rows of a tensor-core narrow item
constexpr int TC_ROWS = 64;       // rows of a tensor-core chunk item
constexpr int CC_NARROW = 8;      // rows of a CUDA-core narrow item
constexpr int CC_ROWS = 32;       // rows of a CUDA-core chunk item
constexpr int PID_CACHE = 128;    // table entries of a split staged in
                                  // shared memory
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
  const void* k;     // [N, Hkv, bs, D]
  const void* v;
  const float* ks;   // [N, Hkv, bs] (int8 pool)
  const float* vs;
  const int* bt;     // [rows, nb]
  void* out;         // [*, H, D] in q's type
  float* part_o;     // [*, H, nsplit, D]: unnormalised accumulators
  float* part_ml;    // [*, H, nsplit, 2]: m (log2 units), l
  int H, Hkv, N, nb, G, window;  // window <= 0: none
  int bs, shift;     // tokens of a page; log2(bs) if a power of two, else -1
  int nch, gc;       // a chunk item's head chunks of a group, heads a chunk
  int nsplit, per;   // split slots of a row; tiles of a split
  float sl2;         // sm_scale * log2(e)
};

struct Item {
  int row, kvh;
  int g0, gn;      // the item's heads [g0, g0 + gn) of kv head kvh's group
  int tok0, ntok;  // q / out index of the first token, tokens
  int pos0;        // position of the first token
  int clen;        // the row's context length
  int lo, hi;      // keys some token of the item sees
  int t0, t1;      // the split's tiles [t0, t1), inside [lo, hi]
  int slot;        // partial slot, or -1: write the output
};

// a chunk item's head chunks of a group of G on a route of `rows` rows and
// the heads of each: the whole group where it fits, else the fewest chunks
// of equal size (the last may be smaller)
__host__ __device__ __forceinline__ void head_chunks(int G, int rows,
                                                     int& nch, int& gc) {
  nch = (G + rows - 1) / rows;
  gc = (G + nch - 1) / nch;
}

// log2(bs) where bs is a power of two, else -1
__host__ __forceinline__ int page_shift(int bs) {
  if (bs <= 0 || (bs & (bs - 1)) != 0) return -1;
  int s = 0;
  while ((1 << s) < bs) ++s;
  return s;
}

// the table entry of key
__device__ __forceinline__ int page_of(const Pool& p, int key) {
  return p.shift >= 0 ? key >> p.shift : key / p.bs;
}

// keys [lo, hi] that some token at positions [pos0, pos0 + ntok) of a row
// with clen keys sees (hi < lo: none); the table addresses nb * bs keys
__device__ __forceinline__ void key_range(const Pool& p, int pos0, int ntok,
                                          int clen, int& lo, int& hi) {
  hi = min(min(pos0 + ntok, clen), p.nb * p.bs) - 1;
  lo = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
}

// does the token at pos see key?
__device__ __forceinline__ bool sees(const Pool& p, int pos, int clen,
                                     int key) {
  return key <= pos && key < clen && key < p.nb * p.bs &&
         (p.window <= 0 || pos - key < p.window);
}

// the query head of an item's row r
__device__ __forceinline__ int row_head(const Pool& p, const Item& it,
                                        int r) {
  return it.kvh * p.G + it.g0 + r % it.gn;
}

__device__ __forceinline__ size_t part_row(const Pool& p, int tok, int head,
                                           int slot) {
  return (static_cast<size_t>(tok) * p.H + head) * p.nsplit + slot;
}

// the table entry of the item's first key that is read: the split's first
// key inside [lo, hi]
__device__ __forceinline__ int first_page(const Pool& p, const Item& it) {
  return page_of(p, max(it.t0 * BK, it.lo));
}

// stage the pool page of the table entries that hold the split's keys in
// [lo, hi] (clamped), up to PID_CACHE of them from first_page on, in pid_s;
// the caller synchronises before the first use
__device__ __forceinline__ void stage_pids(const Pool& p, const Item& it,
                                           int* pid_s) {
  const int p0 = first_page(p, it);
  const int n = min(page_of(p, min(it.t1 * BK - 1, it.hi)) - p0 + 1,
                    PID_CACHE);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    int pid = p.bt[static_cast<size_t>(it.row) * p.nb + p0 + i];
    if (pid < 0 || pid >= p.N) pid = p.N - 1;  // unallocated: clamp
    pid_s[i] = pid;
  }
}

// the pool row ((page * Hkv + kvh) * bs + key % bs) of a key in [lo, hi]
// of the split: its page from pid_s (staged from table entry p0 on), or
// from the table past PID_CACHE entries
__device__ __forceinline__ size_t key_row(const Pool& p, const Item& it,
                                          const int* pid_s, int p0,
                                          int key) {
  const int page = page_of(p, key);
  int pid;
  if (page - p0 < PID_CACHE) {
    pid = pid_s[page - p0];
  } else {
    pid = p.bt[static_cast<size_t>(it.row) * p.nb + page];
    if (pid < 0 || pid >= p.N) pid = p.N - 1;  // unallocated: clamp
  }
  return (static_cast<size_t>(pid) * p.Hkv + it.kvh) * p.bs +
         (key - page * p.bs);
}

// an item whose split sees no key: zeros for the output, or an empty
// partial (m = -inf, l = 0) the merge skips
template <typename QT>
__device__ void empty_item(const Pool& p, const Item& it, int D) {
  const int rows = it.ntok * it.gn;
  if (it.slot < 0) {
    for (int e = threadIdx.x; e < rows * D; e += THREADS) {
      const int r = e / D;
      store(static_cast<QT*>(p.out) +
                (static_cast<size_t>(it.tok0 + r / it.gn) * p.H +
                 row_head(p, it, r)) * D + e % D,
            0.f);
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      float* ml = p.part_ml + 2 * part_row(p, it.tok0 + r / it.gn,
                                           row_head(p, it, r), it.slot);
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

template <int D, int ROWS, bool I8>
struct TcLayout {
  static constexpr int LD = tile_ld<D>();                // bf16 row stride
  static constexpr int TILE = I8 ? BK * D : BK * LD * 2;  // a raw K or V tile
  static constexpr int STAGE = 2 * TILE + (I8 ? 2 * BK * 4 : 0);  // + scales
  static constexpr int PID = ROWS * LD * 2;              // after q
  static constexpr int RING = PID + PID_CACHE * 4;       // after the ids
  static constexpr int CONVB = I8 ? 2 * BK * LD * 2 : 0;  // I8: bf16 K, V
  // three tiles in flight where shared memory holds them, else two
  static constexpr int STAGES =
      RING + 3 * STAGE + CONVB <= MAX_SMEM ? 3 : 2;
  static constexpr int CONV = RING + STAGES * STAGE;
  static constexpr int BYTES = CONV + CONVB;
  // after the walk a narrow item's ring holds the warps' partials:
  // o [4][NARROW][D], then m and l [4][NARROW] each
  static_assert(4 * NARROW * D * 4 + 2 * 4 * NARROW * 4 <= STAGES * STAGE,
                "partials fit in the ring");
  static_assert(STAGE % 16 == 0 && RING % 16 == 0, "16-byte alignment");
  static_assert(BYTES <= MAX_SMEM, "shared memory of one block");
};

// the pool rows of a thread's keys [k0, k0 + n) in [lo, hi] that lie in
// one page: the row of k0 (rows of a page are consecutive), or 0 when none
// of them is in [lo, hi] (every copy is then a zero-fill)
__device__ __forceinline__ size_t run_row(const Pool& p, const Item& it,
                                          const int* pid_s, int p0, int k0,
                                          int n) {
  const int first = max(k0, it.lo);
  if (first > min(k0 + n - 1, it.hi)) return 0;
  return key_row(p, it, pid_s, p0, first) - (first - k0);
}

// start copying tile t of the item into a ring stage: bf16 as swizzled K
// and V tiles, int8 as raw rows plus the K and V scales (4-byte copies,
// so any page size keeps them aligned). A pass of the block copies whole
// rows (coalesced); where a row's chunks divide the block (D 64, 128,
// 256), thread t takes KPT consecutive keys of rows (t / CH) * KPT + x,
// so where the page size is a multiple of KPT its keys lie in one page
// and it looks one page up a tile; otherwise a lookup a key. Keys outside
// [lo, hi] are zero-filled without a read.
template <int D, bool I8>
__device__ __forceinline__ void tc_load_tile(const Pool& p, const Item& it,
                                             int t, const int* pid_s, int p0,
                                             unsigned char* st) {
  constexpr int TILE = TcLayout<D, TC_ROWS, I8>::TILE;
  constexpr int CH = I8 ? D / 16 : D / 8;  // 16-byte chunks of a row
  constexpr int N = BK * CH;               // chunks of a tile
  constexpr bool RUNS = THREADS % CH == 0;  // whole rows a pass
  constexpr int KPT = RUNS ? BK / (THREADS / CH) : 1;  // keys of a thread
  constexpr int EB = I8 ? 16 : 8;          // elements of a chunk
  using E = std::conditional_t<I8, unsigned char, bf16_t>;
  const E* kg = static_cast<const E*>(p.k);
  const E* vg = static_cast<const E*>(p.v);
  const int kb = t * BK;
  if (RUNS && p.bs % KPT == 0) {
    const int ch = threadIdx.x % CH;
    const int r0 = threadIdx.x / CH * KPT;
    const size_t row = run_row(p, it, pid_s, p0, kb + r0, KPT);
#pragma unroll
    for (int x = 0; x < KPT; ++x) {
      const int r = r0 + x;
      const bool in = kb + r >= it.lo && kb + r <= it.hi;
      const size_t src = in ? (row + x) * D + ch * EB : 0;
      if constexpr (I8) {
        cp16(saddr(st + r * D + ch * 16), kg + src, in);
        cp16(saddr(st + TILE + r * D + ch * 16), vg + src, in);
      } else {
        bf16_t* kt = reinterpret_cast<bf16_t*>(st);
        cp16(saddr(kt + swz<D>(r, ch)), kg + src, in);
        cp16(saddr(kt + TILE / 2 + swz<D>(r, ch)), vg + src, in);
      }
    }
  } else {
#pragma unroll 1
    for (int x = 0; x < (N + THREADS - 1) / THREADS; ++x) {
      const int c = threadIdx.x + x * THREADS;
      if (N % THREADS != 0 && c >= N) break;  // the last, partial pass
      const int r = c / CH;
      const int ch = c % CH;
      const int key = kb + r;
      const bool in = key >= it.lo && key <= it.hi;
      const size_t src =
          in ? key_row(p, it, pid_s, p0, key) * D + ch * EB : 0;
      if constexpr (I8) {
        cp16(saddr(st + r * D + ch * 16), kg + src, in);
        cp16(saddr(st + TILE + r * D + ch * 16), vg + src, in);
      } else {
        bf16_t* kt = reinterpret_cast<bf16_t*>(st);
        cp16(saddr(kt + swz<D>(r, ch)), kg + src, in);
        cp16(saddr(kt + TILE / 2 + swz<D>(r, ch)), vg + src, in);
      }
    }
  }
  if constexpr (I8) {
    if (threadIdx.x < BK) {
      const int key = kb + threadIdx.x;
      const bool in = key >= it.lo && key <= it.hi;
      const size_t at = in ? key_row(p, it, pid_s, p0, key) : 0;
      cp4(saddr(st + 2 * TILE + threadIdx.x * 4), p.ks + at, in);
      cp4(saddr(st + 2 * TILE + BK * 4 + threadIdx.x * 4), p.vs + at, in);
    }
  }
}

// the ring's first L::STAGES - 1 tiles (q, already in flight, joins the
// first group)
template <typename L, int D, bool I8>
__device__ __forceinline__ void tc_prologue(const Pool& p, const Item& it,
                                            const int* pid_s, int p0,
                                            unsigned char* ring) {
  const int ntiles = it.t1 - it.t0;
  // one copy of the loader: its unrolled copies cost the walk more than
  // the loop does
#pragma unroll 1
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < ntiles)
      tc_load_tile<D, I8>(p, it, it.t0 + s, pid_s, p0, ring + s * L::STAGE);
    cp_commit();
  }
}

// before tile i's compute: start tile i + L::STAGES - 1, wait for tile i;
// returns its stage. I8: its codes converted into the bf16 tiles at conv.
template <typename L, int D, bool I8>
__device__ __forceinline__ unsigned char* tc_advance(const Pool& p,
                                                     const Item& it,
                                                     const int* pid_s, int p0,
                                                     unsigned char* ring,
                                                     bf16_t* conv, int i) {
  constexpr int S = L::STAGES;
  const int next = i + S - 1;
  if (next < it.t1 - it.t0)
    tc_load_tile<D, I8>(p, it, it.t0 + next, pid_s, p0,
                        ring + (next % S) * L::STAGE);
  cp_commit();
  cp_wait<S - 1>();
  __syncthreads();  // tile i (and q) landed
  unsigned char* st = ring + (i % S) * L::STAGE;
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
      bf16_t* dst = conv + kv * BK * L::LD;
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
  return I8 ? conv + BK * tile_ld<D>()
            : reinterpret_cast<bf16_t*>(st + TcLayout<D, TC_ROWS, I8>::TILE);
}

// the per-key K and V scales of a landed I8 stage
template <int D>
__device__ __forceinline__ const float* tc_scales(const unsigned char* st) {
  return reinterpret_cast<const float*>(st +
                                        2 * TcLayout<D, TC_ROWS, true>::TILE);
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

// the item's query rows (row r: token r / gn, head row_head(r)) into a
// swizzled [n][LD] tile, rows at or past `live` zero-filled
template <int D>
__device__ __forceinline__ void tc_load_q(const Pool& p, const Item& it,
                                          bf16_t* qs, int n, int live) {
  constexpr int CH = D / 8;
  const bf16_t* q = static_cast<const bf16_t*>(p.q);
  for (int c = threadIdx.x; c < n * CH; c += THREADS) {
    const int r = c / CH;
    const bool in = r < live;
    const size_t src =
        in ? (static_cast<size_t>(it.tok0 + r / it.gn) * p.H +
              row_head(p, it, r)) * D + (c % CH) * 8
           : 0;
    cp16(saddr(qs + swz<D>(r, c % CH)), q + src, in);
  }
}

// a narrow item: ntok tokens x gn heads <= 16 rows, padded to 16; warp w
// takes keys 16w..16w+15 of every tile
template <int D, bool I8>
__device__ void tc_decode(const Pool& p, const Item& it, unsigned char* smem) {
  using L = TcLayout<D, NARROW, I8>;
  constexpr int KT = D / 16, ND = D / 8;
  constexpr bool QREG = D <= 128;
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem);
  int* pid_s = reinterpret_cast<int*>(smem + L::PID);
  unsigned char* ring = smem + L::RING;
  bf16_t* conv = reinterpret_cast<bf16_t*>(smem + L::CONV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gn = it.gn;
  const int rows = it.ntok * gn;
  const int ntiles = it.t1 - it.t0;
  const int p0 = first_page(p, it);

  tc_load_q<D>(p, it, qs, NARROW, rows);
  stage_pids(p, it, pid_s);
  __syncthreads();
  tc_prologue<L, D, I8>(p, it, pid_s, p0, ring);

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[QREG ? KT : 1][4];

  for (int i = 0; i < ntiles; ++i) {
    unsigned char* st = tc_advance<L, D, I8>(p, it, pid_s, p0, ring, conv, i);
    if constexpr (QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm(qf[kk], a_addr<D>(qs, 0, kk, lane));
      }
    }
    bf16_t* kt = tc_k<D, I8>(st, conv);
    bf16_t* vt = tc_v<D, I8>(st, conv);
    const int r0 = warp * 16;  // this warp's 16 keys of the tile
    const int key = (it.t0 + i) * BK + r0 + (lane & 15);
    const bool ok = key >= it.lo && key <= it.hi;
    const uint32_t bits = __ballot_sync(~0u, ok) & 0xFFFFu;
    if (bits != 0) {
      // keys outside [lo, hi] landed as zeros; their scores are -inf below
      // two accumulators per n8 tile (even and odd k-steps) halve the
      // dependent mma chain
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 2) {
        uint32_t qa[4], kb[4];
        q_frag<D, QREG, KT>(qa, qf, qs, 0, kk, lane);
        ldsm(kb, b_addr<D>(kt, r0, kk, lane));
        mma(s[0], qa, kb[0], kb[1]);
        mma(s[1], qa, kb[2], kb[3]);
        if (kk + 1 < KT) {
          uint32_t qa2[4], kb2[4];
          q_frag<D, QREG, KT>(qa2, qf, qs, 0, kk + 1, lane);
          ldsm(kb2, b_addr<D>(kt, r0, kk + 1, lane));
          mma(s2[0], qa2, kb2[0], kb2[1]);
          mma(s2[1], qa2, kb2[2], kb2[3]);
        }
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
                  sees(p, it.pos0 + row / gn, it.clen, key - (lane & 15) + col);
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
    __syncthreads();  // this stage is free for a later tile
  }
  cp_wait<0>();
  __syncthreads();

  // the four warps' partials -> shared memory (rows < ntok * gn), then one
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
    const int tok = it.tok0 + g / gn;
    const int head = row_head(p, it, g);
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

// a chunk item: 64 rows (ntok tokens x gn heads), warp w rows
// 16w .. 16w + 15 over all 64 keys of every tile
template <int D, bool I8>
__device__ void tc_chunk(const Pool& p, const Item& it, unsigned char* smem) {
  using L = TcLayout<D, TC_ROWS, I8>;
  constexpr int KT = D / 16, ND = D / 8, NS = BK / 8;
  constexpr bool QREG = D <= 128;
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem);
  int* pid_s = reinterpret_cast<int*>(smem + L::PID);
  unsigned char* ring = smem + L::RING;
  bf16_t* conv = reinterpret_cast<bf16_t*>(smem + L::CONV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gn = it.gn;
  const int live = it.ntok * gn;         // rows < live hold a token
  const bool busy = warp * 16 < live;    // the warp holds a live row
  const int ntiles = it.t1 - it.t0;
  const int p0 = first_page(p, it);

  tc_load_q<D>(p, it, qs, TC_ROWS, live);
  stage_pids(p, it, pid_s);
  __syncthreads();
  tc_prologue<L, D, I8>(p, it, pid_s, p0, ring);

  // keys every live row sees: [lo_all, hi_all]
  const int pos_last = it.pos0 + it.ntok - 1;
  const int hi_all = min(min(it.pos0, it.clen - 1), p.nb * p.bs - 1);
  const int lo_all = p.window > 0 ? max(0, pos_last - p.window + 1) : 0;

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sums
  uint32_t qf[QREG ? KT : 1][4];
  int tok_of[2];                            // token of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
    tok_of[i] = (warp * 16 + (lane >> 2) + 8 * i) / gn;

  for (int i = 0; i < ntiles; ++i) {
    unsigned char* st = tc_advance<L, D, I8>(p, it, pid_s, p0, ring, conv, i);
    if (busy) {
      if constexpr (QREG) {
        if (i == 0) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk)
            ldsm(qf[kk], a_addr<D>(qs, warp * 16, kk, lane));
        }
      }
      bf16_t* kt = tc_k<D, I8>(st, conv);
      bf16_t* vt = tc_v<D, I8>(st, conv);
      const int c0 = (it.t0 + i) * BK;
      // keys outside [lo, hi] landed as zeros; their scores are -inf below

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t qa[4];
        q_frag<D, QREG, KT>(qa, qf, qs, warp * 16, kk, lane);
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          uint32_t kb[4];
          ldsm(kb, b_addr<D>(kt, nj * 16, kk, lane));
          mma(s[2 * nj], qa, kb[0], kb[1]);
          mma(s[2 * nj + 1], qa, kb[2], kb[3]);
        }
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
    }
    __syncthreads();  // this stage is free for a later tile
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
    const int head = row_head(p, it, r);
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
  static constexpr int PID = VALID + BK * 4;        // int [PID_CACHE]
  static constexpr int RING = (PID + PID_CACHE * 4 + 15) / 16 * 16;
  // two tiles in flight where they fit (all but fp32 at D 256)
  static constexpr int NST = RING + 2 * STAGE <= MAX_SMEM ? 2 : 1;
  static constexpr int BYTES = RING + NST * STAGE;
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

// MR rows: row g is token g / gn, head row_head(g)
template <typename QT, typename KT, int D, int MR>
__device__ void cc_item(const Pool& p, const Item& it, unsigned char* smem) {
  using L = CcLayout<KT, D, MR>;
  constexpr int NST = L::NST;
  // P.V mapping: thread (rgp, c) takes rows rgp + NRG * a and columns
  // c + THREADS * j; threads past NRG row groups idle
  constexpr int NRG = D <= THREADS ? THREADS / D : 1;  // row groups
  constexpr int RPT = (MR + NRG - 1) / NRG;            // rows a thread
  constexpr int CPT = (D + THREADS - 1) / THREADS;     // columns a thread
  constexpr int SRG = THREADS / BK;  // row groups in the scores (2)
  constexpr int CH = D * sizeof(KT) / 16;  // 16-byte chunks of a row
  const int tid = threadIdx.x;
  const int gn = it.gn;
  const int live = it.ntok * gn;     // rows < live hold a token
  const int ntiles = it.t1 - it.t0;
  const int p0 = first_page(p, it);

  float* qf = reinterpret_cast<float*>(smem + L::QF);
  float* sp = reinterpret_cast<float*>(smem + L::SP);
  float* m_run = reinterpret_cast<float*>(smem + L::MRUN);
  float* l_run = reinterpret_cast<float*>(smem + L::LRUN);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);
  int* pid_s = reinterpret_cast<int*>(smem + L::PID);
  unsigned char* ring = smem + L::RING;

  // tile i of the split -> stage i % NST; keys outside [lo, hi] read as
  // zeros
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % NST) * L::STAGE;
    const int kb = (it.t0 + i) * BK;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v);
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH;
      const int key = kb + r;
      const bool in = key >= it.lo && key <= it.hi;
      const size_t src =
          in ? key_row(p, it, pid_s, p0, key) * (D * sizeof(KT)) +
                   (c % CH) * 16
             : 0;
      const int off = r * L::RS + (c % CH) * 16;
      cp16(saddr(st + off), kg + src, in);
      cp16(saddr(st + L::TILE + off), vg + src, in);
    }
    if (L::INT8 && tid < BK) {
      const int key = kb + tid;
      const bool in = key >= it.lo && key <= it.hi;
      const size_t at = in ? key_row(p, it, pid_s, p0, key) : 0;
      unsigned char* tail = st + 2 * L::TILE;
      cp4(saddr(tail + tid * 4), p.ks + at, in);
      cp4(saddr(tail + L::SCALES + tid * 4), p.vs + at, in);
    }
  };

  stage_pids(p, it, pid_s);
  __syncthreads();
  issue(0);
  cp_commit();

  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < MR * D; e += THREADS) {
    const int g = e / D;
    float x = 0.f;
    if (g < live)
      x = to_float(q[(static_cast<size_t>(it.tok0 + g / gn) * p.H +
                      row_head(p, it, g)) * D + e % D]);
    qf[e] = x;
  }
  if (tid < MR) {
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
    for (int jj = 0; jj < CPT; ++jj) acc[a][jj] = 0.f;
  const int j = tid % BK;    // scores: key j of rows sg + SRG * a
  const int sg = tid / BK;

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
        if (any && g < live && sees(p, it.pos0 + g / gn, it.clen, key)) {
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
        const float p0v = s0 == -INFINITY ? 0.f : exp2f(s0 - m_new);
        const float p1v = s1 == -INFINITY ? 0.f : exp2f(s1 - m_new);
        const float sum = warp_sum(p0v + p1v);
        srow[lane] = p0v;
        srow[lane + 32] = p1v;
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
    if (pv) {
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int g = rgp + NRG * a;
        if (g < live)
#pragma unroll
          for (int jj = 0; jj < CPT; ++jj) acc[a][jj] *= alpha_s[g];
      }
      for (int key = 0; key < BK; ++key) {
        if (!valid_s[key]) continue;  // uniform across the block
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          float vx = to_float(
              reinterpret_cast<const KT*>(vr + key * L::RS)[c + THREADS * jj]);
          if (L::INT8) vx *= vsc[key];
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const int g = rgp + NRG * a;
            if (g < live) acc[a][jj] = fmaf(sp[g * BK + key], vx, acc[a][jj]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for a later tile
  }
  cp_wait<0>();

  if (!pv) return;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int g = rgp + NRG * a;
    if (g >= live) continue;
    const int tok = it.tok0 + g / gn;
    const int head = row_head(p, it, g);
    const float l = l_run[g];
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int col = c + THREADS * jj;
      if (it.slot < 0) {
        store(static_cast<QT*>(p.out) +
                  (static_cast<size_t>(tok) * p.H + head) * D + col,
              l == 0.f ? 0.f : acc[a][jj] / l);
      } else {
        const size_t row = part_row(p, tok, head, it.slot);
        p.part_o[row * D + col] = acc[a][jj];
        if (col == 0) {
          p.part_ml[2 * row] = m_run[g];
          p.part_ml[2 * row + 1] = l;
        }
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
// output. nullptr (K7a, K7b): every token merges all nsplit slots. A lane
// takes columns lane + 32 c.
template <typename QT, int D>
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(Pool p,
                                                              const int* info) {
  constexpr int NC = (D + 31) / 32;
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
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  if (m != -INFINITY)
    for (int s = 0; s < n; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;
      const float w = exp2f(ms - m);
      l += ml[2 * s + 1] * w;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (D % 32 == 0 || lane + 32 * c < D)
          acc[c] += po[static_cast<size_t>(s) * D + lane + 32 * c] * w;
    }
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (D % 32 == 0 || lane + 32 * c < D)
      store(out + lane + 32 * c, acc[c] * inv);
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
      cc_item<QT, KT, D, CC_NARROW>(p, it, smem);
    else
      cc_item<QT, KT, D, CC_ROWS>(p, it, smem);
  }
}

// dynamic shared memory of a narrow item and of a chunk item on the route
// of (QT, KT), and of a kernel that may run either
template <typename QT, typename KT, int D>
constexpr int narrow_smem() {
  if constexpr (tensor_cores<QT, KT>())
    return TcLayout<D, NARROW, sizeof(KT) == 1>::BYTES;
  else
    return CcLayout<KT, D, CC_NARROW>::BYTES;
}
template <typename QT, typename KT, int D>
constexpr int chunk_smem() {
  if constexpr (tensor_cores<QT, KT>())
    return TcLayout<D, TC_ROWS, sizeof(KT) == 1>::BYTES;
  else
    return CcLayout<KT, D, CC_ROWS>::BYTES;
}
template <typename QT, typename KT, int D>
constexpr int item_smem() {
  return narrow_smem<QT, KT, D>() > chunk_smem<QT, KT, D>()
             ? narrow_smem<QT, KT, D>()
             : chunk_smem<QT, KT, D>();
}

// rows of a chunk item on the route of (QT, KT)
template <typename QT, typename KT>
__host__ __device__ constexpr int chunk_rows() {
  return tensor_cores<QT, KT>() ? TC_ROWS : CC_ROWS;
}

// most rows of a narrow item on the route of (QT, KT)
template <typename QT, typename KT>
__host__ __device__ constexpr int narrow_rows() {
  return tensor_cores<QT, KT>() ? NARROW : CC_NARROW;
}

// run `launch<QT, KT, D>` for the head dim D of a call; unknown dims fail
template <template <typename, typename, int> class F, typename QT,
          typename KT, typename... A>
cudaError_t by_head_dim(int D, A&&... args) {
  switch (D) {
    case 64: return F<QT, KT, 64>::run(args...);
    case 80: return F<QT, KT, 80>::run(args...);
    case 96: return F<QT, KT, 96>::run(args...);
    case 128: return F<QT, KT, 128>::run(args...);
    case 256: return F<QT, KT, 256>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

// the head dims the walk is compiled for
__host__ __forceinline__ bool head_dim_ok(int D) {
  return D == 64 || D == 80 || D == 96 || D == 128 || D == 256;
}

}  // namespace
