// Paged decode attention and paged chunked-prefill attention for the
// two-program serving engine, hand-written for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/_build.py with nvcc and called through ctypes from
// deepspeed_tpu_torch/ops/decode_attention.py.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/pallas/decode_attention.py::_paged_decode_kernel
//   deepspeed_tpu/ops/pallas/decode_attention.py::_paged_prefill_kernel
// and computes the same two functions over a paged pool k/v [N, Hkv, bs, D]
// (bf16/fp32, or int8 with fp32 scales [N, Hkv, bs]; any page size bs,
// D 64, 80, 96, 128 or 256) addressed through block_tables [B, nb] (an
// entry outside [0, N) is unallocated and is clamped to page N - 1, whose
// contents the length mask hides):
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
// Query head kvh * G + g reads kv head kvh, for any whole group G. Softmax
// runs in fp32; a row that sees no key returns zeros. block_tables,
// chunk_start and context_lens are read on the device, so no launch
// parameter depends on them (the TPU kernels prefetch them as scalars).
//
// Bound: bytes. Each visible K/V page (and its scales) is read once per kv
// head for a few FLOP per element, far below the card's ridge, so the floor
// is (visible keys + q + out) / 3.35 TB/s.
//
// Both are split-key walks over the block table (paged_common.cuh's, shared
// with K6). They replace first designs that gave one block a whole
// (sequence, kv head) for K7a, and a (32 / G chunk rows, sequence, kv
// head) tile for K7b, walking pages in fp32 FMA on CUDA cores: the longest
// row set the time, a chunk at B 1 left half the SMs idle, and every page
// was a serial step. What the walk does about them:
// - the longest row no longer sets the time: the key axis (the table's
//   nb * bs keys) is cut into `splits` ranges of `per` whole 64-key tiles,
//   the count from nb * bs, the query tiles and the SM count (K4's rule,
//   ops/decode_attention.py paged_splits), never from context_lens or
//   chunk_start. K7a's grid is (B, Hkv x head chunks, splits); K7b's is
//   (B * query tiles, Hkv x head chunks, splits), a query tile being
//   floor(64 / G) chunk tokens x G heads (the tensor cores' chunk item) or
//   floor(32 / G) (the CUDA cores'); a group larger than those rows takes
//   one token a tile and its heads in chunks. A split past the context or
//   outside the window writes an empty partial and exits, the others walk
//   only their visible tiles;
// - each split writes an fp32 partial that merge_kernel, launched by the
//   same C call, combines in split order (no atomics: bitwise
//   deterministic); with one split the block writes the output itself.
//   K7b's tokens at or past context_lens[b] get zeros or empty partials
//   from their own tile's blocks, so every output element is written and
//   the caller's output needs no fill;
// - no per-tile fp32 conversion pass or serial softmax: bf16 q runs on the
//   tensor cores, over a bf16 pool or an int8 pool converted to bf16 in
//   shared memory (exact: the codes are small integers; the scales stay
//   fp32). K7a's decode token takes K4's mapping where its group fits 16
//   rows (a warp per 16 keys of each 64-key tile), else K1's as a chunk of
//   one token (a warp per 16 heads, as K4's decode_tc_multi_kernel); K7b's
//   chunk tile takes K1's (64 rows, a warp per 16, causal and window
//   limits per row on the edge tiles). Both take P as bf16(P) +
//   bf16(P - bf16(P)). fp32 q runs exact fp32 FMA;
// - keys outside the visible range are zero-filled before P.V, so a NaN in
//   a page's stale tail cannot leak.
// So every launch parameter is a function of the shapes, and a captured
// CUDA graph replays either kernel for new tables, starts and lengths.

#include "paged_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// paged decode (K7a): grid (B, Hkv x nch, splits) over paged_common.cuh's
// walk
// ---------------------------------------------------------------------------

// Block (b, kvh * nch + c, s) runs the one token of sequence b, heads
// [c * gc, c * gc + gc) of kv head kvh's group, on split s: a narrow item
// where the group fits narrow_rows (then nch = 1), else a chunk item.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Pool p,
                                                               const int* cl,
                                                               int* runs,
                                                               bool narrow) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_run(runs);
  Item it;
  it.row = blockIdx.x;
  it.kvh = blockIdx.y / p.nch;
  it.g0 = blockIdx.y % p.nch * p.gc;
  it.gn = min(p.gc, p.G - it.g0);
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
  run_item<QT, KT, D>(p, it, narrow, smem);
}

template <typename QT, typename KT, int D>
struct Decode {
  static cudaError_t run(Pool p, const int* cl, int* runs, int B,
                         cudaStream_t stream) {
    const bool narrow = p.G <= narrow_rows<QT, KT>();
    if (narrow) {
      p.nch = 1;
      p.gc = p.G;
    } else {
      head_chunks(p.G, chunk_rows<QT, KT>(), p.nch, p.gc);
    }
    if (p.Hkv > 65535 / p.nch) return cudaErrorInvalidValue;
    cudaError_t err =
        allow_smem<paged_decode_kernel<QT, KT, D>>(item_smem<QT, KT, D>());
    if (err != cudaSuccess) return err;
    const int bytes =
        narrow ? narrow_smem<QT, KT, D>() : chunk_smem<QT, KT, D>();
    paged_decode_kernel<QT, KT, D>
        <<<dim3(B, p.Hkv * p.nch, p.nsplit), THREADS, bytes, stream>>>(
            p, cl, runs, narrow);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.nsplit == 1) return err;
    merge_kernel<QT, D><<<merge_grid(B, p.H), MERGE_THREADS, 0, stream>>>(
        p, nullptr);
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// paged chunked prefill (K7b): grid (B * query tiles, Hkv x nch, splits)
// over the same walk, each tile one chunk item
// ---------------------------------------------------------------------------

// Block (b * tiles + i, kvh * nch + c, s) runs tokens [i * qt, i * qt + qt)
// of sequence b's chunk (qt = the route's chunk rows / gc) and heads
// [c * gc, c * gc + gc) of kv head kvh's group on split s. Its tokens at or
// past the context get zeros (one split) or an empty partial for the
// merge, so every output element is written.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(
    Pool p, const int* cs, const int* cl, int T, int* runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_run(runs);
  const int qt = chunk_rows<QT, KT>() / p.gc;
  const int tiles = (T + qt - 1) / qt;
  const int b = blockIdx.x / tiles;
  const int first = blockIdx.x % tiles * qt;
  const int s = blockIdx.z;
  Item it;
  it.row = b;
  it.kvh = blockIdx.y / p.nch;
  it.g0 = blockIdx.y % p.nch * p.gc;
  it.gn = min(p.gc, p.G - it.g0);
  it.clen = cl[b];
  it.pos0 = cs[b] + first;
  it.tok0 = b * T + first;
  it.ntok = max(0, min(qt, min(T, it.clen - cs[b]) - first));
  it.slot = p.nsplit == 1 ? -1 : s;
  Item dead = it;
  dead.tok0 = it.tok0 + it.ntok;
  dead.ntok = min(qt, T - first) - it.ntok;
  if (dead.ntok > 0) empty_item<QT>(p, dead, D);
  if (it.ntok == 0) return;
  key_range(p, it.pos0, it.ntok, it.clen, it.lo, it.hi);
  it.t0 = max(s * p.per, it.lo / BK);
  it.t1 = it.hi >= it.lo ? min((s + 1) * p.per, it.hi / BK + 1) : 0;
  if (it.t0 >= it.t1) {
    empty_item<QT>(p, it, D);
    return;
  }
  run_item<QT, KT, D>(p, it, false, smem);
}

template <typename QT, typename KT, int D>
struct Prefill {
  static cudaError_t run(Pool p, const int* cs, const int* cl, int* runs,
                         int B, int T, cudaStream_t stream) {
    head_chunks(p.G, chunk_rows<QT, KT>(), p.nch, p.gc);
    const int qt = chunk_rows<QT, KT>() / p.gc;
    const long long tiles = (T + qt - 1) / qt;
    if (p.Hkv > 65535 / p.nch || B * tiles > 0x7FFFFFFFLL)
      return cudaErrorInvalidValue;
    constexpr int bytes = chunk_smem<QT, KT, D>();
    cudaError_t err = allow_smem<paged_prefill_kernel<QT, KT, D>>(bytes);
    if (err != cudaSuccess) return err;
    paged_prefill_kernel<QT, KT, D>
        <<<dim3(static_cast<unsigned>(B * tiles), p.Hkv * p.nch, p.nsplit),
           THREADS, bytes, stream>>>(p, cs, cl, T, runs);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.nsplit == 1) return err;
    merge_kernel<QT, D><<<merge_grid(B * T, p.H), MERGE_THREADS, 0, stream>>>(
        p, nullptr);
    return cudaGetLastError();
  }
};

// the Pool of a C entry's arguments
Pool make_pool(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale,
               const void* block_tables, void* out, void* scratch,
               size_t tokens, int H, int Hkv, int D, int N, int nb, int bs,
               float sm_scale, int window, int splits, int per) {
  Pool p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.out = out;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = p.part_o + tokens * H * splits * D;
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
  return p;
}

// are the shapes ones the walk takes, and do the split count and the
// tiles of a split cover the table's nb * bs keys?
bool shapes_ok(int H, int Hkv, int D, int N, int nb, int bs, int splits,
               int per) {
  if (!head_dim_ok(D) || N <= 0 || nb <= 0 || bs <= 0 || Hkv <= 0 ||
      H <= 0 || H % Hkv != 0 || static_cast<long long>(nb) * bs > 0x3FFFFFFFLL)
    return false;
  const int tiles = (nb * bs + BK - 1) / BK;
  return per > 0 && splits == (tiles + per - 1) / per && splits <= 65535;
}

// the launcher of (QT, the pool's type) for head dim D
template <template <typename, typename, int> class F, typename QT,
          typename... A>
cudaError_t dispatch(int kv_int8, int D, A&&... args) {
  return kv_int8 ? by_head_dim<F, QT, int8_t>(D, args...)
                 : by_head_dim<F, QT, QT>(D, args...);
}

}  // namespace

// C entries for ctypes. k/v pages: [N, Hkv, bs, D] in q's type (q_bf16:
// bf16, else fp32), or int8 with fp32 scales [N, Hkv, bs] (kv_int8), for
// D 64, 80, 96, 128 or 256 and any page size bs; block_tables int32
// [B, nb]; context_lens (and chunk_start) int32 [B]; Hkv divides H (any
// group); window <= 0: none. The table's nb * bs keys are cut into
// `splits` ranges of `per` 64-key tiles (the wrapper derives both from the
// shapes and the card); scratch is fp32 [tokens * H * splits * (D + 2)]
// (unused with one split); runs is int32 [1] or null, one added on the
// device per launch that runs (a CUDA graph's replays included). Every
// output element is written. The caller validates shapes. Each returns
// cudaGetLastError() after its launches (0 = launched).

// q/out: [B, H, D]
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, void* out, void* scratch, int B, int H,
    int Hkv, int D, int N, int nb, int bs, float sm_scale, int window,
    int q_bf16, int kv_int8, int splits, int per, void* runs, void* stream) {
  if (B <= 0 || !shapes_ok(H, Hkv, D, N, nb, bs, splits, per) ||
      static_cast<long long>(B) * H > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool p = make_pool(q, k_pages, v_pages, k_scale, v_scale,
                           block_tables, out, scratch, B, H, Hkv, D, N, nb,
                           bs, sm_scale, window, splits, per);
  const int* cl = static_cast<const int*>(context_lens);
  int* r = static_cast<int*>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      q_bf16 ? dispatch<Decode, __nv_bfloat16>(kv_int8, D, p, cl, r, B, s)
             : dispatch<Decode, float>(kv_int8, D, p, cl, r, B, s));
}

// q/out: [B, T, H, D]; the grid is (B * query tiles, Hkv x head chunks,
// splits), a query tile floor(64 / G) tokens for bf16 q (the tensor cores),
// floor(32 / G) for fp32 q, one token where G exceeds those rows
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* chunk_start, const void* context_lens, void* out,
    void* scratch, int B, int T, int H, int Hkv, int D, int N, int nb,
    int bs, float sm_scale, int window, int q_bf16, int kv_int8, int splits,
    int per, void* runs, void* stream) {
  if (B <= 0 || T <= 0 || !shapes_ok(H, Hkv, D, N, nb, bs, splits, per) ||
      static_cast<long long>(B) * T * H > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool p = make_pool(q, k_pages, v_pages, k_scale, v_scale,
                           block_tables, out, scratch,
                           static_cast<size_t>(B) * T, H, Hkv, D, N, nb, bs,
                           sm_scale, window, splits, per);
  const int* cs = static_cast<const int*>(chunk_start);
  const int* cl = static_cast<const int*>(context_lens);
  int* r = static_cast<int*>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      q_bf16
          ? dispatch<Prefill, __nv_bfloat16>(kv_int8, D, p, cs, cl, r, B, T, s)
          : dispatch<Prefill, float>(kv_int8, D, p, cs, cl, r, B, T, s));
}
