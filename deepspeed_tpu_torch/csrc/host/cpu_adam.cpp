// Host (CPU) optimizers over offloaded fp32 states: the host side of ZeRO-Offload.
//
// Port of the JAX package's csrc/cpu_adam.cpp (reference
// csrc/adam/cpu_adam_impl.cpp, csrc/adagrad/cpu_adagrad.cpp,
// csrc/lion/cpu_lion_impl.cpp). The arithmetic of the three steps is that
// file's, statement for statement, so the two packages step the same inputs
// to the same bits. The one change: every entry point takes the number of
// OpenMP threads (the caller passes torch.get_num_threads()) instead of
// taking every core. Vectorisation is left to the compiler (-O3
// -march=native).
//
// Beside the steps, the gradient pass of the offloaded step: scale a
// gradient in place (the inverse loss scale, the clip coefficient) and sum
// its squares in double, block by block in a fixed order, so the norm does
// not depend on the thread count.

#include <cmath>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int64_t kNormBlock = 1 << 16;  // elements a partial sum of squares

int clamp_threads(int nthreads) { return nthreads > 0 ? nthreads : 1; }

}  // namespace

extern "C" {

// One fused Adam(W) step over flat fp32 arrays.
//   adamw_mode: 1 => decoupled weight decay (AdamW), 0 => L2-into-grad Adam
// Bias correction follows the reference (step is 1-based).
void ds_adam_step(float* params, const float* grads, float* exp_avg, float* exp_avg_sq, int64_t n, float lr,
                  float beta1, float beta2, float eps, float weight_decay, int64_t step, int adamw_mode,
                  int nthreads) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float step_size = lr / bc1;
  const float bc2_sqrt = std::sqrt(bc2);

#pragma omp parallel for schedule(static) num_threads(clamp_threads(nthreads))
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    if (!adamw_mode && weight_decay != 0.0f) g += weight_decay * params[i];
    float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
    float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) / bc2_sqrt + eps;
    // decoupled decay uses the raw lr (bias correction applies to the
    // moment estimate only), as optax.adamw and torch AdamW
    float decay = (adamw_mode && weight_decay != 0.0f) ? lr * weight_decay * params[i] : 0.0f;
    params[i] -= step_size * (m / denom) + decay;
  }
}

// Adagrad step (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(float* params, const float* grads, float* sq_sum, int64_t n, float lr, float eps,
                     float weight_decay, int nthreads) {
#pragma omp parallel for schedule(static) num_threads(clamp_threads(nthreads))
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    if (weight_decay != 0.0f) g += weight_decay * params[i];
    float s = sq_sum[i] + g * g;
    sq_sum[i] = s;
    params[i] -= lr * g / (std::sqrt(s) + eps);
  }
}

// Lion step (reference csrc/lion/cpu_lion_impl.cpp).
void ds_lion_step(float* params, const float* grads, float* exp_avg, int64_t n, float lr, float beta1, float beta2,
                  float weight_decay, int nthreads) {
#pragma omp parallel for schedule(static) num_threads(clamp_threads(nthreads))
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float c = beta1 * exp_avg[i] + (1.0f - beta1) * g;
    float update = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
    if (weight_decay != 0.0f) update += weight_decay * params[i];
    params[i] -= lr * update;
    exp_avg[i] = beta2 * exp_avg[i] + (1.0f - beta2) * g;
  }
}

// grads *= scale in fp32 (skipped when scale is 1), then the sum over i of
// grads[i] * grads[i] (squared in fp32, summed in double): partial sums of
// kNormBlock elements, added in block order.
double ds_scale_sq_norm(float* grads, int64_t n, float scale, int nthreads) {
  const int64_t nblocks = (n + kNormBlock - 1) / kNormBlock;
  std::vector<double> partial(nblocks > 0 ? nblocks : 1, 0.0);
  const bool scaled = scale != 1.0f;
#pragma omp parallel for schedule(static) num_threads(clamp_threads(nthreads))
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t end = (b + 1) * kNormBlock < n ? (b + 1) * kNormBlock : n;
    double s = 0.0;
    for (int64_t i = b * kNormBlock; i < end; ++i) {
      float g = grads[i];
      if (scaled) {
        g = g * scale;
        grads[i] = g;
      }
      s += (double)(g * g);
    }
    partial[b] = s;
  }
  double total = 0.0;
  for (int64_t b = 0; b < nblocks; ++b) total += partial[b];
  return total;
}

// grads *= scale in fp32 (the clip coefficient).
void ds_scale(float* grads, int64_t n, float scale, int nthreads) {
#pragma omp parallel for schedule(static) num_threads(clamp_threads(nthreads))
  for (int64_t i = 0; i < n; ++i) grads[i] = grads[i] * scale;
}

int ds_omp_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
