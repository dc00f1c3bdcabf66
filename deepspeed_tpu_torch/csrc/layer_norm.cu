// LayerNorm forward for Hopper: y = (x - mean) * rsqrt(var + eps) * w + b, fp32 statistics.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/norms.py::_ln_kernel
// (reached through layer_norm -> _ln_fwd_pallas). On the card the op is bound
// by memory: it reads x once and writes y once (2 * rows * d * itemsize bytes,
// plus the weight and the bias), with a handful of flops per element. The
// design keeps the traffic at that floor, as csrc/rms_norm.cu does: one block
// per row, each thread loads its share of the row with 16-byte vector loads
// into registers, and both statistics reduce from those registers, so x is
// read from memory exactly once. The variance is the mean of squared
// deviations from the mean (a second pass over the registers), as in the
// reference, not E[x^2] - mean^2, which cancels badly for rows with a large
// mean. Rows too wide for the register cache, or pointers that are not
// 16-byte aligned, take a plain three-pass kernel.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecPerThread = 8;

// Sum over the block. Each call site passes its own `red` buffer, so two
// reductions in a row need no barrier between them.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float t = 0.f;
  for (int i = 0; i < nwarps; ++i) t += red[i];
  return t;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
layer_norm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b, T* __restrict__ out,
                      int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red_mean[32], red_var[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / VEC;
  float v[kMaxVecPerThread][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load_vec<VEC>(xr + i * VEC, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[k][j];
    }
  }
  const float mean = block_sum(s, red_mean) / static_cast<float>(d);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] -= mean;
        ss += v[k][j] * v[k][j];
      }
    }
  }
  const float r = rsqrtf(block_sum(ss, red_var) / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      float wv[VEC], bv[VEC], o[VEC];
      load_vec<VEC>(w + i * VEC, wv);
      load_vec<VEC>(b + i * VEC, bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = (v[k][j] * r) * wv[j] + bv[j];
      store_vec<VEC>(orow + i * VEC, o);
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
layer_norm_plain_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                        T* __restrict__ out, int d, float eps) {
  __shared__ float red_mean[32], red_var[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += to_float(xr[i]);
  const float mean = block_sum(s, red_mean) / static_cast<float>(d);
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = to_float(xr[i]) - mean;
    ss += c * c;
  }
  const float r = rsqrtf(block_sum(ss, red_var) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_float<T>(((to_float(xr[i]) - mean) * r) * to_float(w[i]) + to_float(b[i]));
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* out, long long rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
  const int nvec = d / VEC;
  const bool vec_ok = d % VEC == 0 && nvec <= kMaxVecPerThread * kThreads && aligned16(x) && aligned16(w) &&
                      aligned16(b) && aligned16(out);
  // one row per block; a narrow row gets as many threads as it has vectors (whole warps)
  const int per_row = vec_ok ? nvec : d;
  int threads = per_row >= kThreads ? kThreads : ((per_row + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (vec_ok) {
    layer_norm_vec_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, bp, op, d, eps);
  } else {
    layer_norm_plain_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, bp, op, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch

// x, out: (rows, d) contiguous of x_dtype; w, b: (d,) of w_dtype. Returns 0 or an error code.
extern "C" int ds_layer_norm(const void* x, const void* w, const void* b, void* out, long long rows, int d,
                             float eps, int x_dtype, int w_dtype, void* stream) {
  using namespace dstorch;
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16) return launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32) return launch<__nv_bfloat16, float>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kFloat32) return launch<float, float>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16) return launch<float, __nv_bfloat16>(x, w, b, out, rows, d, eps, s);
  return kUnsupported;
}
