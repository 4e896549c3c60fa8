// Ragged paged attention for the packed serving step, hand-written for
// Hopper (sm_90a) as a split-key walk over the block table. Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes
// from deepspeed_tpu_torch/ops/ragged_attention.py.
//
// Replaces the TPU kernel
//   deepspeed_tpu/ops/pallas/ragged_attention.py::_ragged_kernel
// and computes the same function: q [T, H, D] is a packed token batch of
// per-row segments (query_start, query_len); token t of row r sits at
// position chunk_start[r] + t and attends its row's kv positions p with
// p <= pos, p < context_lens[r] and, with a window, pos - p < window. Query
// head kvh*G + g reads kv head kvh, for any whole group G; the pool's pages
// hold any number bs of tokens, D is 64, 80, 96, 128 or 256. Softmax runs in
// fp32; a token that sees no key, and a token no row claims, comes back as
// zeros.
//
// Bound: bytes. A step reads every visible K/V page of every row once per
// kv head, plus q and the output; the arithmetic per byte is far below the
// card's ridge, so the floor is those bytes over 3.35 TB/s.
//
// This replaces the first design (one block per (32-row q tile, row, kv
// head) walking the row's pages one at a time in fp32 FMA). What the new
// design does about its five limits:
// 1. One block no longer walks a whole long row. A row's key axis is cut
//    into splits of `per` whole 64-key tiles (from the shapes and the SM
//    count, ops/ragged_attention.py launch_params). A work item is (row,
//    query tile, kv head, split); an item that is its tokens' only split
//    writes the output, the others write fp32 partials (m in log2 units,
//    l, the unnormalised accumulator) that merge_kernel, launched by the
//    same C call, combines in split order: the sums' order never depends
//    on which block ran an item or when, so the result is bitwise
//    deterministic.
// 2. No per-page barriers or serial softmax: an item walks 64-key tiles
//    (gathered key by key through the table, any page size) through a
//    cp.async ring, and the online softmax runs in the mma accumulator
//    fragments (bf16) or one warp per row (fp32).
// 3. Decode rows do not waste a 32-row tile: a row of a few tokens
//    (tokens x G heads <= 16, e.g. one decode token, or a speculative
//    verify row) is one narrow item on K4's mapping, its rows padded to 16
//    and the four warps on different 16-key slices of each tile; longer
//    rows, and any row of a group over 16, are cut into chunk tiles on
//    K1's mapping, floor(64 / G) tokens x G heads, a warp per 16 rows (a
//    group over 64 heads: one token a tile, its heads in chunks of at most
//    64).
// 4. Tensor cores for bf16 q (mma.sync m16n8k16, Q and P in registers)
//    over a bf16 pool, or an int8 pool whose codes are converted to bf16
//    exactly in shared memory (the scales stay fp32: K's on the score, V's
//    folded into P); fp32 q runs exact fp32 FMA on CUDA cores inside the
//    same split walk (paged_common.cuh).
// 5. No dead grid: ragged_plan_kernel (one block) reads the descriptors on
//    the device and lays out the items (chunk rows first, the heavier
//    class) and each packed token's split range; a persistent grid of
//    `grid` blocks (two per SM) runs items b, then the next from an
//    atomic queue head, so a block that finishes early takes more.
//    The launch depends on T, R, nb, bs, Hkv, D and the SM count only, never
//    on the descriptors' values, so a captured CUDA graph replays for new
//    ones. merge_kernel writes zeros for every token no row claims, so the
//    wrapper's output needs no fill. Three launches: the plan, the walk,
//    the merge.

#include "paged_common.cuh"

namespace {

constexpr int PLAN_THREADS = 256;
constexpr int PLAN_ROWS = 1024;  // rows the plan counts per round

struct Ragged {
  const int* qs;
  const int* ql;
  const int* cs;
  const int* cl;
  int* next;    // [1]: the work queue's head
  int* order;   // [R]: rows, chunk rows first
  int* prefix;  // [R + 1]: items before order[k]
  int* info;    // [T]: (s_lo << 16 | n) of each token's tile, 0 = zeros
  int* runs;    // [1] or null: one is added per launch that runs
  int T, R, chunk_rows, narrow_rows, grid;
};

// tokens of row r inside the packed axis (0 for an idle row), and its query
// tile: all of them if they make a narrow item (tokens x G <= narrow_rows),
// else chunk_rows / gc tokens (one where the group is cut into chunks)
__device__ __forceinline__ int row_tokens(const Ragged& g, int r) {
  const int qs = g.qs[r];
  const int ql = g.ql[r];
  if (ql <= 0 || g.cl[r] <= 0 || qs < 0 || qs >= g.T) return 0;
  return min(ql, g.T - qs);
}

__device__ __forceinline__ bool narrow_row(const Pool& p, const Ragged& g,
                                           int nq) {
  return nq * p.G <= g.narrow_rows;
}

__device__ __forceinline__ int row_tile(const Pool& p, const Ragged& g,
                                        int nq) {
  return narrow_row(p, g, nq) ? max(nq, 1) : g.chunk_rows / p.gc;
}

// work items of one (query tile, split) of a row: one per kv head, times
// the head chunks of a chunk item
__device__ __forceinline__ int heads_items(const Pool& p, bool narrow) {
  return narrow ? p.Hkv : p.Hkv * p.nch;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// the splits [s_lo, s_lo + n) of a tile of ntok tokens from pos0, and its
// visible keys [lo, hi]
__device__ __forceinline__ void tile_splits(const Pool& p, int pos0, int ntok,
                                            int clen, int& s_lo, int& n,
                                            int& lo, int& hi) {
  key_range(p, pos0, ntok, clen, lo, hi);
  if (hi < lo) {
    s_lo = n = 0;
    return;
  }
  s_lo = lo / BK / p.per;
  n = hi / BK / p.per - s_lo + 1;
}

// One block lays out the work: every row's items (its query tiles' splits
// times Hkv, times the head chunks of a chunk row), chunk rows first (the
// heavier items), as order and prefix; each claimed token's split range as
// info; the queue head at the grid size (block b's first item is b). A
// warp counts a row (its lanes take the row's query tiles), PLAN_ROWS rows
// a round, and thread 0 appends them in row order.
__global__ void __launch_bounds__(PLAN_THREADS) ragged_plan_kernel(Pool p,
                                                                   Ragged g) {
  __shared__ int items_s[PLAN_ROWS];  // a round's item counts, -1: not now
  constexpr int WARPS = PLAN_THREADS / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < g.T; t += PLAN_THREADS) g.info[t] = 0;
  __syncthreads();
  int k = 0, run = 0;  // thread 0: rows and items laid out so far
  for (int pass = 0; pass < 2; ++pass) {
    for (int base = 0; base < g.R; base += PLAN_ROWS) {
      for (int i = warp; i < PLAN_ROWS && base + i < g.R; i += WARPS) {
        const int r = base + i;
        const int nq = row_tokens(g, r);
        const int qt = row_tile(p, g, nq);
        const int qs = g.qs[r];
        const int cs = g.cs[r];
        const int cl = g.cl[r];
        int items = 0;
        for (int tok = lane * qt; tok < nq; tok += 32 * qt) {
          const int ntok = min(qt, nq - tok);
          int s_lo, n, lo, hi;
          tile_splits(p, cs + tok, ntok, cl, s_lo, n, lo, hi);
          items += n;
          if (pass == 0)
            for (int j = 0; j < ntok; ++j)
              g.info[qs + tok + j] = (s_lo << 16) | n;
        }
        items = warp_sum_int(items);
        const bool narrow = narrow_row(p, g, nq);
        if (lane == 0)
          items_s[i] = narrow == (pass == 1)
                           ? items * heads_items(p, narrow)
                           : -1;
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int i = 0; i < PLAN_ROWS && base + i < g.R; ++i)
          if (items_s[i] >= 0) {
            g.order[k] = base + i;
            g.prefix[k++] = run;
            run += items_s[i];
          }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    g.prefix[g.R] = run;
    *g.next = g.grid;
    if (g.runs != nullptr) ++*g.runs;
  }
}

// Persistent blocks take items heaviest class first: block b starts with
// item b, then takes the queue's next item each time it finishes one, so
// the blocks that finish early take more (and a step with fewer items than
// blocks touches no counter). An item's arithmetic does not depend on the
// block that runs it.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) ragged_walk_kernel(Pool p,
                                                              Ragged g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int taken;
  const int total = g.prefix[g.R];
  for (int item = blockIdx.x; item < total;) {
    // the last position a with prefix[a] <= item (a row with items): each
    // warp reads 32 prefixes a round trip (prefix never decreases)
    int a = 0;
    for (int base = 0; base < g.R; base += 32) {
      const int k = base + (threadIdx.x & 31);
      const unsigned le = __ballot_sync(~0u, k < g.R && g.prefix[k] <= item);
      if (le != 0u) a = base + 31 - __clz(le);
      if (le != ~0u) break;
    }
    const int r = g.order[a];
    const int nq = row_tokens(g, r);
    const bool narrow = narrow_row(p, g, nq);
    const int heads = heads_items(p, narrow);
    int j = item - g.prefix[a];
    Item it;
    it.row = r;
    const int kc = j % heads;  // kv head (x head chunk)
    j /= heads;
    it.kvh = narrow ? kc : kc / p.nch;
    it.g0 = narrow ? 0 : kc % p.nch * p.gc;
    it.gn = narrow ? p.G : min(p.gc, p.G - it.g0);
    const int qt = row_tile(p, g, nq);
    it.clen = g.cl[r];
    int s_lo = 0, n = 0, tok = 0;
    for (;; tok += qt) {
      it.ntok = min(qt, nq - tok);
      tile_splits(p, g.cs[r] + tok, it.ntok, it.clen, s_lo, n, it.lo, it.hi);
      if (j < n) break;
      j -= n;
    }
    it.tok0 = g.qs[r] + tok;
    it.pos0 = g.cs[r] + tok;
    const int s = s_lo + j;
    it.t0 = max(s * p.per, it.lo / BK);
    it.t1 = min((s + 1) * p.per, it.hi / BK + 1);
    it.slot = n == 1 ? -1 : s;
    run_item<QT, KT, D>(p, it, narrow, smem);
    if (threadIdx.x == 0) taken = atomicAdd(g.next, 1);
    __syncthreads();  // the next item reuses shared memory
    item = taken;
    __syncthreads();  // every thread read `taken`
  }
}

template <typename QT, typename KT, int D>
struct Walk {
  // the plan, the walk, the merge
  static cudaError_t run(Pool p, Ragged g, cudaStream_t stream) {
    g.chunk_rows = chunk_rows<QT, KT>();
    g.narrow_rows = narrow_rows<QT, KT>();
    head_chunks(p.G, g.chunk_rows, p.nch, p.gc);
    constexpr int bytes = item_smem<QT, KT, D>();
    cudaError_t err = allow_smem<ragged_walk_kernel<QT, KT, D>>(bytes);
    if (err != cudaSuccess) return err;
    ragged_plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(p, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ragged_walk_kernel<QT, KT, D><<<g.grid, THREADS, bytes, stream>>>(p, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_kernel<QT, D><<<merge_grid(g.T, p.H), MERGE_THREADS, 0, stream>>>(
        p, g.info);
    return cudaGetLastError();
  }
};

}  // namespace

// C entry for ctypes. q/out: [T, H, D] (q_bf16: bf16, else fp32);
// k/v pages: [N, Hkv, bs, D] in q's type, or int8 with fp32 scales
// [N, Hkv, bs] (kv_int8), for D 64, 80, 96, 128 or 256 and any page size
// bs; Hkv divides H (any group); block_tables int32 [R, nb]; query_start,
// query_len, chunk_start, context_lens int32 [R]; window <= 0: none.
// A row's key axis (nb * bs keys) is cut into `splits` ranges of `per`
// 64-key tiles, and `grid` blocks take the work items (the wrapper
// derives all three from the shapes and the card). iscratch: int32
// [2R + 2 + T]; fscratch: fp32 [T * H * splits * (D + 2)]. runs: int32 [1]
// or null; each launch adds one to it on the device when it runs (a CUDA
// graph's replays included). Every element of out is written. The caller
// validates shapes. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* query_start, const void* query_len, const void* chunk_start,
    const void* context_lens, void* out, void* iscratch, void* fscratch,
    void* runs, int T, int H, int Hkv, int D, int N, int R, int nb, int bs,
    float sm_scale, int window, int q_bf16, int kv_int8, int splits, int per,
    int grid, void* stream) {
  if (!head_dim_ok(D) || T <= 0 || R <= 0 || R > 65535 || N <= 0 ||
      nb <= 0 || bs <= 0 || static_cast<long long>(nb) * bs > 0x3FFFFFFFLL ||
      Hkv <= 0 || H <= 0 || H % Hkv != 0 || per <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (nb * bs + BK - 1) / BK;
  if (splits != (tiles + per - 1) / per || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Pool p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.out = out;
  p.part_o = static_cast<float*>(fscratch);
  p.part_ml = p.part_o + static_cast<size_t>(T) * H * splits * D;
  p.H = H;
  p.Hkv = Hkv;
  p.N = N;
  p.nb = nb;
  p.G = H / Hkv;
  p.window = window;
  p.bs = bs;
  p.shift = page_shift(bs);
  p.nch = 1;
  p.gc = p.G;
  p.nsplit = splits;
  p.per = per;
  p.sl2 = sm_scale * LOG2E;
  Ragged g;
  g.qs = static_cast<const int*>(query_start);
  g.ql = static_cast<const int*>(query_len);
  g.cs = static_cast<const int*>(chunk_start);
  g.cl = static_cast<const int*>(context_lens);
  g.next = static_cast<int*>(iscratch);
  g.order = g.next + 1;
  g.prefix = g.order + R;
  g.info = g.prefix + R + 1;
  g.runs = static_cast<int*>(runs);
  g.T = T;
  g.R = R;
  g.grid = grid;
  g.chunk_rows = g.narrow_rows = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      q_bf16 ? (kv_int8 ? by_head_dim<Walk, __nv_bfloat16, int8_t>(D, p, g, s)
                        : by_head_dim<Walk, __nv_bfloat16, __nv_bfloat16>(
                              D, p, g, s))
             : (kv_int8 ? by_head_dim<Walk, float, int8_t>(D, p, g, s)
                        : by_head_dim<Walk, float, float>(D, p, g, s));
  return static_cast<int>(err);
}
