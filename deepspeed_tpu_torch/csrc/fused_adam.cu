// Multi-tensor fused Adam / AdamW step, hand-written for Hopper (sm_90a).
// Built by deepspeed_tpu_torch/ops/_build.py with nvcc and called through
// ctypes from deepspeed_tpu_torch/ops/fused_adam.py.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py::
// _adam_kernel and computes the same function for every element of every
// fp32 parameter tensor:
//   g *= grad_scale                       (the clip factor, read on device)
//   L2 mode:  g += wd * p
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//   u = -step_size * m / (sqrt(v) * inv_bc2 + eps)
//   AdamW:    u -= lr * wd * p
// then p += u in place (or, for LAMB's direction, g = u and p untouched).
// As the TPU kernel's alpha_ref, step_size = lr / (1 - b1^t), lr and
// inv_bc2 = 1 / sqrt(1 - b2^t) come from a device fp32 array computed from
// the optimizer's device step count; a device skip flag (the fp16
// overflow) makes every block return before it writes anything, which is
// the JAX step's keep(new, old). So a captured training step reads them
// at each replay and nothing waits for the host.
//
// Bound: bytes. Per element it reads p, g, m, v (16 bytes) and writes p,
// m, v (12 bytes) for ~15 FLOP, far below the ridge, so the floor is
// 28 bytes x elements / 3.35 TB/s.
//
// What the design does about it:
// - one launch covers the whole parameter list: the TPU kernel swept each
//   leaf with its own pallas_call; here a device table lists every
//   tensor's four pointers and length, and one block per 32K-element
//   chunk of any tensor (multi-tensor apply, as the reference DeepSpeed
//   csrc/adam/multi_tensor_adam.cu does), so small tensors cost no launch;
// - 16-byte vector loads and stores for the body of each chunk, scalar
//   code only for a tensor's last < 4 elements;
// - the clip factor, the step's scalars and the skip flag come from
//   device memory, so the step never waits for the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once on the host
  int adam_w, write_update;
};

struct Step {
  float step_size, lr, inv_bc2, gs;  // from device memory, per launch
};

__device__ __forceinline__ void adam_elem(float& p, float& g, float& m,
                                          float& v, const Step& s,
                                          const Hyper& h) {
  float gg = g * s.gs;
  // rounded as two operations, not contracted into one fma: where wd * p
  // nearly cancels g, the sum keeps the reference's rounding
  if (!h.adam_w && h.wd != 0.f) gg = __fadd_rn(gg, __fmul_rn(h.wd, p));
  m = h.b1 * m + h.omb1 * gg;
  v = h.b2 * v + h.omb2 * (gg * gg);
  float u = -s.step_size * (m / (sqrtf(v) * s.inv_bc2 + h.eps));
  if (h.adam_w && h.wd != 0.f) u -= s.lr * h.wd * p;
  if (h.write_update)
    g = u;
  else
    p += u;
}

// table: n_tensors rows of (p, g, m, v, numel) as int64, then one
// (tensor, start) row per chunk
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const int64_t* table, int n_tensors, int chunk,
                const float* alpha, const bool* skip,
                const float* grad_scale, int* runs, Hyper h) {
  // a device count of the launches that ran (a CUDA graph's replays
  // included), skipped steps too
  if (runs != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(runs, 1);
  if (skip != nullptr && *skip) return;
  const Step s = {alpha[0], alpha[1], alpha[2],
                  grad_scale != nullptr ? *grad_scale : 1.f};
  const int64_t* c = table + 5 * n_tensors + 2 * blockIdx.x;
  const int64_t* t = table + 5 * c[0];
  float* p = reinterpret_cast<float*>(t[0]);
  float* g = reinterpret_cast<float*>(t[1]);
  float* m = reinterpret_cast<float*>(t[2]);
  float* v = reinterpret_cast<float*>(t[3]);
  const int64_t start = c[1];
  const int64_t end = min(t[4], start + chunk);

  // chunk starts are multiples of 4 and tensors 16-byte aligned
  const int64_t vec_end = start + ((end - start) & ~int64_t(3));
  for (int64_t i = start + 4 * threadIdx.x; i < vec_end; i += 4 * THREADS) {
    float4 P = *reinterpret_cast<float4*>(p + i);
    float4 G = *reinterpret_cast<float4*>(g + i);
    float4 M = *reinterpret_cast<float4*>(m + i);
    float4 V = *reinterpret_cast<float4*>(v + i);
    adam_elem(P.x, G.x, M.x, V.x, s, h);
    adam_elem(P.y, G.y, M.y, V.y, s, h);
    adam_elem(P.z, G.z, M.z, V.z, s, h);
    adam_elem(P.w, G.w, M.w, V.w, s, h);
    if (h.write_update)
      *reinterpret_cast<float4*>(g + i) = G;
    else
      *reinterpret_cast<float4*>(p + i) = P;
    *reinterpret_cast<float4*>(m + i) = M;
    *reinterpret_cast<float4*>(v + i) = V;
  }
  for (int64_t i = vec_end + threadIdx.x; i < end; i += THREADS)
    adam_elem(p[i], g[i], m[i], v[i], s, h);
}

}  // namespace

// C entry for ctypes. table: device int64 [5 * n_tensors + 2 * n_chunks]
// as above; chunk: elements per chunk (a multiple of 4); alpha: device
// fp32 [3] = (step_size, lr, inv_bc2); skip: a device bool, or null (never
// skip); grad_scale: a device fp32 scalar or null (1); runs: a device
// int32 [1] the kernel adds one to, or null. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int fused_adam(const void* table, int n_tensors, int n_chunks,
                          int chunk, const void* alpha, const void* skip,
                          const void* grad_scale, void* runs, float b1,
                          float omb1, float b2, float omb2, float eps,
                          float wd, int adam_w, int write_update,
                          void* stream) {
  if (n_chunks <= 0) return 0;
  if (chunk % 4 != 0 || alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Hyper h = {b1, omb1, b2, omb2, eps, wd, adam_w, write_update};
  adam_kernel<<<n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), n_tensors, chunk,
      static_cast<const float*>(alpha), static_cast<const bool*>(skip),
      static_cast<const float*>(grad_scale), static_cast<int*>(runs), h);
  return static_cast<int>(cudaGetLastError());
}
