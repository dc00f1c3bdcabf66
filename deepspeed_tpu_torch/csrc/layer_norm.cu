// LayerNorm forward for Hopper: y = (x - mean) * rsqrt(var + eps) * w + b, fp32 statistics.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/norms.py::_ln_kernel (reached through layer_norm ->
// _ln_fwd_pallas). The body is csrc/norm_rows.cuh's, with two reductions from the registers: the mean, then
// the mean of squared deviations from it, as in the reference (not E[x^2] - mean^2, which cancels badly for
// rows with a large mean); see its notes for the design. This file holds the C entry point and the
// instantiations.
#include "norm_rows.cuh"

// x, out: (rows, d) contiguous of x_dtype; w, b: (d,) of w_dtype. Returns 0 or an error code.
extern "C" int ds_layer_norm(const void* x, const void* w, const void* b, void* out, long long rows, int d,
                             float eps, int x_dtype, int w_dtype, void* stream) {
  using namespace dstorch;
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_norm<true, bf16, bf16>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_norm<true, bf16, float>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch_norm<true, float, float>(x, w, b, out, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch_norm<true, float, bf16>(x, w, b, out, rows, d, eps, s);
  return kUnsupported;
}
