// RMSNorm forward for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, fp32 statistics.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/norms.py::_rms_kernel (reached through rms_norm ->
// _rms_fwd_pallas). The body is csrc/norm_rows.cuh's, with one reduction (the sum of squares); see its notes
// for the design. This file holds the C entry point and the instantiations.
#include "norm_rows.cuh"

// x, out: (rows, d) contiguous of x_dtype; w: (d,) of w_dtype. Returns 0 or an error code.
extern "C" int ds_rms_norm(const void* x, const void* w, void* out, long long rows, int d, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  using namespace dstorch;
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_norm<false, bf16, bf16>(x, w, nullptr, out, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_norm<false, bf16, float>(x, w, nullptr, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch_norm<false, float, float>(x, w, nullptr, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch_norm<false, float, bf16>(x, w, nullptr, out, rows, d, eps, s);
  return kUnsupported;
}
