// SIMD-vectorized Adam/AdamW over flat fp32 partitions, run on the TPU-VM
// host CPU. TPU-native counterpart of the reference's csrc/adam/cpu_adam.cpp
// (AVX Step_AVX in csrc/includes/cpu_adam.h): the op exists so ZeRO-Offload
// can keep optimizer state in host RAM and step it at memory bandwidth while
// the chip holds only bf16 working weights.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image). All
// buffers are caller-owned numpy arrays; the optional bf16 output implements
// the fused fp32->bf16 copy-back the reference does for fp16 ("param_half").
//
// Build: see csrc/Makefile (g++ -O3 -march=native); AVX512/AVX2 paths are
// selected at compile time via the usual feature macros, scalar otherwise.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "bf16.h"

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct AdamState {
  float alpha;
  float beta1;
  float beta2;
  float eps;
  float weight_decay;
  bool adamw_mode;  // true: decoupled decay (AdamW); false: L2 into grad
};

std::unordered_map<int, AdamState> g_states;
std::mutex g_mu;


// Scalar reference step for the tail (and non-SIMD builds).
void adam_scalar(const AdamState& s, float bc1, float bc2, float lr,
                 float* p, const float* g, float* m, float* v, int64_t begin,
                 int64_t end, uint16_t* bf16_out) {
  for (int64_t i = begin; i < end; ++i) {
    float grad = g[i];
    if (!s.adamw_mode && s.weight_decay > 0.f) grad += s.weight_decay * p[i];
    m[i] = s.beta1 * m[i] + (1.f - s.beta1) * grad;
    v[i] = s.beta2 * v[i] + (1.f - s.beta2) * grad * grad;
    float mhat = m[i] / bc1;
    float vhat = v[i] / bc2;
    float update = mhat / (std::sqrt(vhat) + s.eps);
    if (s.adamw_mode && s.weight_decay > 0.f) update += s.weight_decay * p[i];
    p[i] -= lr * update;
    if (bf16_out) bf16_out[i] = f32_to_bf16(p[i]);
  }
}

#if defined(__AVX512F__)
constexpr int64_t kWidth = 16;
void adam_simd(const AdamState& s, float bc1, float bc2, float lr, float* p,
               const float* g, float* m, float* v, int64_t begin, int64_t end,
               uint16_t* bf16_out) {
  const __m512 vb1 = _mm512_set1_ps(s.beta1);
  const __m512 vb2 = _mm512_set1_ps(s.beta2);
  const __m512 vomb1 = _mm512_set1_ps(1.f - s.beta1);
  const __m512 vomb2 = _mm512_set1_ps(1.f - s.beta2);
  const __m512 veps = _mm512_set1_ps(s.eps);
  const __m512 vwd = _mm512_set1_ps(s.weight_decay);
  const __m512 vlr = _mm512_set1_ps(lr);
  const __m512 vrbc1 = _mm512_set1_ps(1.f / bc1);
  const __m512 vrbc2 = _mm512_set1_ps(1.f / bc2);
  int64_t i = begin;
  for (; i + kWidth <= end; i += kWidth) {
    __m512 grad = _mm512_loadu_ps(g + i);
    __m512 par = _mm512_loadu_ps(p + i);
    if (!s.adamw_mode && s.weight_decay > 0.f)
      grad = _mm512_fmadd_ps(vwd, par, grad);
    __m512 mm = _mm512_loadu_ps(m + i);
    __m512 vv = _mm512_loadu_ps(v + i);
    mm = _mm512_fmadd_ps(vb1, mm, _mm512_mul_ps(vomb1, grad));
    vv = _mm512_fmadd_ps(vb2, vv, _mm512_mul_ps(vomb2, _mm512_mul_ps(grad, grad)));
    __m512 mhat = _mm512_mul_ps(mm, vrbc1);
    __m512 vhat = _mm512_mul_ps(vv, vrbc2);
    __m512 upd = _mm512_div_ps(mhat, _mm512_add_ps(_mm512_sqrt_ps(vhat), veps));
    if (s.adamw_mode && s.weight_decay > 0.f)
      upd = _mm512_fmadd_ps(vwd, par, upd);
    par = _mm512_fnmadd_ps(vlr, upd, par);
    _mm512_storeu_ps(p + i, par);
    _mm512_storeu_ps(m + i, mm);
    _mm512_storeu_ps(v + i, vv);
    if (bf16_out) {
      // per-lane round-to-nearest-even bf16 (no AVX512-BF16 dependence)
      alignas(64) float tmp[kWidth];
      _mm512_store_ps(tmp, par);
      for (int64_t l = 0; l < kWidth; ++l) bf16_out[i + l] = f32_to_bf16(tmp[l]);
    }
  }
  adam_scalar(s, bc1, bc2, lr, p, g, m, v, i, end, bf16_out);
}
#elif defined(__AVX2__)
constexpr int64_t kWidth = 8;
void adam_simd(const AdamState& s, float bc1, float bc2, float lr, float* p,
               const float* g, float* m, float* v, int64_t begin, int64_t end,
               uint16_t* bf16_out) {
  const __m256 vb1 = _mm256_set1_ps(s.beta1);
  const __m256 vb2 = _mm256_set1_ps(s.beta2);
  const __m256 vomb1 = _mm256_set1_ps(1.f - s.beta1);
  const __m256 vomb2 = _mm256_set1_ps(1.f - s.beta2);
  const __m256 veps = _mm256_set1_ps(s.eps);
  const __m256 vwd = _mm256_set1_ps(s.weight_decay);
  const __m256 vlr = _mm256_set1_ps(lr);
  const __m256 vrbc1 = _mm256_set1_ps(1.f / bc1);
  const __m256 vrbc2 = _mm256_set1_ps(1.f / bc2);
  int64_t i = begin;
  for (; i + kWidth <= end; i += kWidth) {
    __m256 grad = _mm256_loadu_ps(g + i);
    __m256 par = _mm256_loadu_ps(p + i);
    if (!s.adamw_mode && s.weight_decay > 0.f)
      grad = _mm256_fmadd_ps(vwd, par, grad);
    __m256 mm = _mm256_loadu_ps(m + i);
    __m256 vv = _mm256_loadu_ps(v + i);
    mm = _mm256_fmadd_ps(vb1, mm, _mm256_mul_ps(vomb1, grad));
    vv = _mm256_fmadd_ps(vb2, vv, _mm256_mul_ps(vomb2, _mm256_mul_ps(grad, grad)));
    __m256 mhat = _mm256_mul_ps(mm, vrbc1);
    __m256 vhat = _mm256_mul_ps(vv, vrbc2);
    __m256 upd = _mm256_div_ps(mhat, _mm256_add_ps(_mm256_sqrt_ps(vhat), veps));
    if (s.adamw_mode && s.weight_decay > 0.f)
      upd = _mm256_fmadd_ps(vwd, par, upd);
    par = _mm256_fnmadd_ps(vlr, upd, par);
    _mm256_storeu_ps(p + i, par);
    _mm256_storeu_ps(m + i, mm);
    _mm256_storeu_ps(v + i, vv);
    if (bf16_out) {
      alignas(32) float tmp[kWidth];
      _mm256_store_ps(tmp, par);
      for (int64_t l = 0; l < kWidth; ++l) bf16_out[i + l] = f32_to_bf16(tmp[l]);
    }
  }
  adam_scalar(s, bc1, bc2, lr, p, g, m, v, i, end, bf16_out);
}
#else
void adam_simd(const AdamState& s, float bc1, float bc2, float lr, float* p,
               const float* g, float* m, float* v, int64_t begin, int64_t end,
               uint16_t* bf16_out) {
  adam_scalar(s, bc1, bc2, lr, p, g, m, v, begin, end, bf16_out);
}
#endif

}  // namespace

extern "C" {

int ds_adam_create(int optimizer_id, float alpha, float beta1, float beta2,
                   float eps, float weight_decay, int adamw_mode) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_states[optimizer_id] =
      AdamState{alpha, beta1, beta2, eps, weight_decay, adamw_mode != 0};
  return 0;
}

int ds_adam_destroy(int optimizer_id) {
  std::lock_guard<std::mutex> lk(g_mu);
  return g_states.erase(optimizer_id) ? 0 : -1;
}

// One Adam step over a flat fp32 partition. `step` is 1-based; `lr`
// overrides the stored alpha when >= 0 (LR schedules live in Python).
// `bf16_out` (nullable) receives the updated params rounded to bf16.
int ds_adam_step(int optimizer_id, int64_t step, int64_t n, float* params,
                 const float* grads, float* exp_avg, float* exp_avg_sq,
                 float lr, uint16_t* bf16_out, int num_threads) {
  AdamState s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_states.find(optimizer_id);
    if (it == g_states.end()) return -1;
    s = it->second;
  }
  if (lr >= 0.f) s.alpha = lr;
  const float bc1 = 1.f - std::pow(s.beta1, static_cast<float>(step));
  const float bc2 = 1.f - std::pow(s.beta2, static_cast<float>(step));

  if (num_threads <= 1 || n < (1 << 16)) {
    adam_simd(s, bc1, bc2, s.alpha, params, grads, exp_avg, exp_avg_sq, 0, n,
              bf16_out);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  chunk = (chunk + 63) & ~int64_t(63);  // cache-line-aligned element chunks
  for (int t = 0; t < num_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    pool.emplace_back([&, begin, end] {
      adam_simd(s, bc1, bc2, s.alpha, params, grads, exp_avg, exp_avg_sq,
                begin, end, bf16_out);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
