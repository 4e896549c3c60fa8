// SIMD Adagrad over flat fp32 partitions (host CPU). Counterpart of the
// reference's csrc/adagrad/cpu_adagrad.cpp; same C-ABI/threading pattern as
// cpu_adam.cpp (see that file for the design rationale).

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

struct AdagradState {
  float alpha;
  float eps;
  float weight_decay;
};

std::unordered_map<int, AdagradState> g_states;
std::mutex g_mu;


void adagrad_scalar(const AdagradState& s, float lr, float* p, const float* g,
                    float* h, int64_t begin, int64_t end, uint16_t* bf16_out) {
  for (int64_t i = begin; i < end; ++i) {
    float grad = g[i];
    if (s.weight_decay > 0.f) grad += s.weight_decay * p[i];
    h[i] += grad * grad;
    p[i] -= lr * grad / (std::sqrt(h[i]) + s.eps);
    if (bf16_out) bf16_out[i] = f32_to_bf16(p[i]);
  }
}

#if defined(__AVX512F__)
void adagrad_simd(const AdagradState& s, float lr, float* p, const float* g,
                  float* h, int64_t begin, int64_t end, uint16_t* bf16_out) {
  const __m512 veps = _mm512_set1_ps(s.eps);
  const __m512 vwd = _mm512_set1_ps(s.weight_decay);
  const __m512 vlr = _mm512_set1_ps(lr);
  int64_t i = begin;
  for (; i + 16 <= end; i += 16) {
    __m512 grad = _mm512_loadu_ps(g + i);
    __m512 par = _mm512_loadu_ps(p + i);
    if (s.weight_decay > 0.f) grad = _mm512_fmadd_ps(vwd, par, grad);
    __m512 hh = _mm512_loadu_ps(h + i);
    hh = _mm512_fmadd_ps(grad, grad, hh);
    __m512 upd = _mm512_div_ps(grad, _mm512_add_ps(_mm512_sqrt_ps(hh), veps));
    par = _mm512_fnmadd_ps(vlr, upd, par);
    _mm512_storeu_ps(p + i, par);
    _mm512_storeu_ps(h + i, hh);
    if (bf16_out) {
      alignas(64) float tmp[16];
      _mm512_store_ps(tmp, par);
      for (int l = 0; l < 16; ++l) bf16_out[i + l] = f32_to_bf16(tmp[l]);
    }
  }
  adagrad_scalar(s, lr, p, g, h, i, end, bf16_out);
}
#else
void adagrad_simd(const AdagradState& s, float lr, float* p, const float* g,
                  float* h, int64_t begin, int64_t end, uint16_t* bf16_out) {
  adagrad_scalar(s, lr, p, g, h, begin, end, bf16_out);
}
#endif

}  // namespace

extern "C" {

int ds_adagrad_create(int optimizer_id, float alpha, float eps,
                      float weight_decay) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_states[optimizer_id] = AdagradState{alpha, eps, weight_decay};
  return 0;
}

int ds_adagrad_destroy(int optimizer_id) {
  std::lock_guard<std::mutex> lk(g_mu);
  return g_states.erase(optimizer_id) ? 0 : -1;
}

int ds_adagrad_step(int optimizer_id, int64_t n, float* params,
                    const float* grads, float* sum_sq, float lr,
                    uint16_t* bf16_out, int num_threads) {
  AdagradState s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_states.find(optimizer_id);
    if (it == g_states.end()) return -1;
    s = it->second;
  }
  if (lr >= 0.f) s.alpha = lr;
  if (num_threads <= 1 || n < (1 << 16)) {
    adagrad_simd(s, s.alpha, params, grads, sum_sq, 0, n, bf16_out);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  chunk = (chunk + 63) & ~int64_t(63);
  for (int t = 0; t < num_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    pool.emplace_back([&, begin, end] {
      adagrad_simd(s, s.alpha, params, grads, sum_sq, begin, end, bf16_out);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
