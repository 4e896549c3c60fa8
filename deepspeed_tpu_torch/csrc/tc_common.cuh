// Tensor-core building blocks shared by the bf16 attention kernels of
// flash_attention.cu and block_sparse_attention.cu (sm_90a): cp.async
// copies into XOR-swizzled bf16 tiles, ldmatrix operand fetches,
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the C -> A fragment
// conversion that keeps P and dS in registers, and the once-per-device
// shared-memory opt-in. Each including source is its own library, so
// everything here has internal linkage.
//
// Tiles are bf16 rows. Where D is a whole number of 64-element (128-byte)
// groups (D 64, 128, 256) a row holds D elements and its 16-byte chunk c
// sits at c ^ (row & 7) (the XOR stays inside the chunk's group of 8), so
// the 8 rows an ldmatrix phase reads fall on distinct banks. Other head
// dims (D 80, 96) pad each row to D + 8 elements instead: an odd number of
// 16-byte chunks a row puts 8 consecutive rows on 8 distinct bank groups
// with no swizzle. tile_ld<D>() is the row stride either way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16_t = __nv_bfloat16;

constexpr int MAX_SMEM = 232448;     // the card's opt-in shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// one added to *runs (when not null) by the first thread of block (0, 0, 0):
// a device count of the kernel's runs, which a CUDA graph's replays add to
__device__ __forceinline__ void count_run(int* runs) {
  if (runs != nullptr && threadIdx.x == 0 && blockIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(runs, 1);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// row stride, in elements, of a bf16 tile of head dim D
template <int D>
__host__ __device__ constexpr int tile_ld() {
  static_assert(D % 16 == 0, "head dims are whole k16 steps");
  return D % 64 == 0 ? D : D + 8;
}

// element offset of (row r, 16-byte chunk ch) in a [rows][tile_ld<D>()]
// tile: XOR-swizzled where D % 64 == 0, padded rows otherwise
template <int D>
__device__ __forceinline__ int swz(int r, int ch) {
  if constexpr (D % 64 == 0)
    return r * D + ((ch ^ (r & 7)) << 3);
  else
    return r * tile_ld<D>() + (ch << 3);
}

// ldmatrix addresses, for the 16 x 16 piece at (row r0, column 16 kk) of a
// swizzled tile. A operand: rows r0..r0+15 as the m dimension. B operand
// (rows are the n dimension, columns the k dimension): two n8 tiles.
// Transposed B operand (rows are the k dimension, columns n): two n8 tiles.
template <int D>
__device__ __forceinline__ uint32_t a_addr(const bf16_t* t, int r0, int kk,
                                           int lane) {
  return saddr(t + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}
template <int D>
__device__ __forceinline__ uint32_t b_addr(const bf16_t* t, int r0, int kk,
                                           int lane) {
  return saddr(t + swz<D>(r0 + (lane & 7) + ((lane >> 4) << 3),
                          2 * kk + ((lane >> 3) & 1)));
}
template <int D>
__device__ __forceinline__ uint32_t bt_addr(const bf16_t* t, int r0, int nn,
                                            int lane) {
  return saddr(t + swz<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          2 * nn + (lane >> 4)));
}

// start copying rows [row0, row0 + ROWS) of head h, batch b of a
// [B, T, Hn, D] bf16 tensor into a swizzled shared tile; rows at or past T
// are zero-filled
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16_t* dst, const void* src, int b,
                                          int h, int row0, int T, int Hn) {
  constexpr int CH = D / 8;
  constexpr int N = ROWS * CH;
  const bf16_t* s = static_cast<const bf16_t*>(src);
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (N % NT != 0 && c >= N) break;  // the last, partial pass
    const int r = c / CH;
    const int ch = c % CH;
    const int row = row0 + r;
    const bool in = row < T;
    cp16(saddr(dst + swz<D>(r, ch)),
         s + ((static_cast<size_t>(b) * T + (in ? row : 0)) * Hn + h) * D +
             ch * 8,
         in);
  }
}

// A fragments (16 x 16, k-step kk) from score-shaped accumulators: the C
// layout of n8 tiles 2 kk and 2 kk + 1 is the A layout of one k-step
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Raise kernel K's dynamic shared-memory limit once per device, not on
// every launch.
template <auto K>
cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned> done{0u};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

}  // namespace
