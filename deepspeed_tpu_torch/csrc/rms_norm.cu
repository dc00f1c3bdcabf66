// RMSNorm forward for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, fp32 statistics.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/norms.py::_rms_kernel
// (reached through rms_norm -> _rms_fwd_pallas). On the card the op is bound
// by memory: it reads x once and writes y once (2 * rows * d * itemsize bytes,
// plus the weight), with d flops per element at most. The design keeps the
// traffic at that floor: one block per row, each thread loads its share of the
// row with 16-byte vector loads into registers, the sum of squares reduces by
// warp shuffles and then across warps through shared memory, and the scaling
// pass reuses the registers, so x is read from memory exactly once. Rows too
// wide for the register cache, or pointers that are not 16-byte aligned, take a
// plain two-pass kernel.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecPerThread = 8;

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
rms_norm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / VEC;
  float v[kMaxVecPerThread][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load_vec<VEC>(xr + i * VEC, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss += v[k][j] * v[k][j];
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      float wv[VEC], o[VEC];
      load_vec<VEC>(w + i * VEC, wv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = (v[k][j] * r) * wv[j];
      store_vec<VEC>(orow + i * VEC, o);
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_norm_plain_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int d, float eps) {
  __shared__ float red[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_float(xr[i]);
    ss += f * f;
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) orow[i] = from_float<T>((to_float(xr[i]) * r) * to_float(w[i]));
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  const int nvec = d / VEC;
  const bool vec_ok = d % VEC == 0 && nvec <= kMaxVecPerThread * kThreads && aligned16(x) && aligned16(w) &&
                      aligned16(out);
  // one row per block; a narrow row gets as many threads as it has vectors (whole warps)
  const int per_row = vec_ok ? nvec : d;
  int threads = per_row >= kThreads ? kThreads : ((per_row + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (vec_ok) {
    rms_norm_vec_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rms_norm_plain_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, op, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch

// x, out: (rows, d) contiguous of x_dtype; w: (d,) of w_dtype. Returns 0 or an error code.
extern "C" int ds_rms_norm(const void* x, const void* w, void* out, long long rows, int d, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  using namespace dstorch;
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16) return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32) return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kFloat32) return launch<float, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16) return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return kUnsupported;
}
