// The float32 flash attention bodies (flash_fp32.cuh) at the head dims of the
// Hugging Face families: D 80 (phi-2), 96 (phi-3-mini, gpt-neox-20b) and 256
// (gemma, gpt-j), without a bias (the bias bodies and the collapsed dq are
// built at D 32, 64 and 128 only, for evoformer). A translation unit of its
// own, so that nvcc builds it beside flash_attention.cu in parallel.
//
// Replaces, in fp32 at these head dims, the TPU kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py: _fwd_kernel (pallas_call at
// :185), _dq_kernel (:417) and _dkv_kernel_gqa (:518). As at D 32-128 they are
// bound by their products at 67 TFLOP/s without the tensor cores; the parity
// route on the card and the fp32 engines need them, not speed.
#include "flash_fp32.cuh"

namespace dstorch {
namespace {

constexpr Bias kNoBiasArg{nullptr, 1, 1, 1, 1};

template <int D>
int fwd_f32(const float* q, const float* k, const float* v, const float* slopes, float* o, float* lse, int B, int H,
            int KVH, Mask mk, cudaStream_t stream) {
  using G = Geo<float, D>;
  auto kernel = flash_fwd_kernel<float, D, false>;
  const cudaError_t err = allow_smem(kernel, G::fwd);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((mk.sq + G::BM - 1) / G::BM, H, B), G::NT, G::fwd, stream>>>(q, k, v, slopes, kNoBiasArg, o, lse, H,
                                                                              KVH, mk);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_f32(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           const float* slopes, float* dq, int B, int H, int KVH, Mask mk, cudaStream_t stream) {
  using G = Geo<float, D>;
  auto kernel = flash_dq_kernel<float, D, kNoDbias>;
  const cudaError_t err = allow_smem(kernel, G::dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((mk.sq + G::BM - 1) / G::BM, H, B), G::NT, G::dq, stream>>>(q, k, v, dout, lse, delta, slopes,
                                                                             kNoBiasArg, dq, nullptr, H, KVH, mk);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_f32(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
            const float* slopes, float* dk, float* dv, int B, int H, int KVH, Mask mk, cudaStream_t stream) {
  using G = Geo<float, D>;
  auto kernel = flash_dkv_kernel<float, D, false>;
  const cudaError_t err = allow_smem(kernel, G::dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((mk.sk + G::BM - 1) / G::BM, KVH, B), G::NT, G::dkv, stream>>>(q, k, v, dout, lse, delta, slopes,
                                                                                kNoBiasArg, dk, dv, H, KVH, mk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_fwd_f32_wide(const float* q, const float* k, const float* v, const float* slopes, float* o, float* lse,
                       int B, int H, int KVH, int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 80: return fwd_f32<80>(q, k, v, slopes, o, lse, B, H, KVH, mk, stream);
    case 96: return fwd_f32<96>(q, k, v, slopes, o, lse, B, H, KVH, mk, stream);
    case 256: return fwd_f32<256>(q, k, v, slopes, o, lse, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

int flash_dq_f32_wide(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                      const float* delta, const float* slopes, float* dq, int B, int H, int KVH, int D, Mask mk,
                      cudaStream_t stream) {
  switch (D) {
    case 80: return dq_f32<80>(q, k, v, dout, lse, delta, slopes, dq, B, H, KVH, mk, stream);
    case 96: return dq_f32<96>(q, k, v, dout, lse, delta, slopes, dq, B, H, KVH, mk, stream);
    case 256: return dq_f32<256>(q, k, v, dout, lse, delta, slopes, dq, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

int flash_dkv_f32_wide(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                       const float* delta, const float* slopes, float* dk, float* dv, int B, int H, int KVH, int D,
                       Mask mk, cudaStream_t stream) {
  switch (D) {
    case 80: return dkv_f32<80>(q, k, v, dout, lse, delta, slopes, dk, dv, B, H, KVH, mk, stream);
    case 96: return dkv_f32<96>(q, k, v, dout, lse, delta, slopes, dk, dv, B, H, KVH, mk, stream);
    case 256: return dkv_f32<256>(q, k, v, dout, lse, delta, slopes, dk, dv, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
