// The bfloat16 flash attention forward at D 32, 64 and 128, with or without
// an additive bias: the body and its design note are flash_fwd.cuh. D 80, 96
// and 256 are flash_fwd_wide.cu, a translation unit of its own so that nvcc
// builds both in parallel.
//
// Replaces, for bf16, the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (pallas_call at :185, via _flash_fwd).
#include "flash_fwd.cuh"

namespace dstorch {

int flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* slopes, Bias bias, bf16* o, float* lse,
                   int B, int H, int KVH, int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<32, true>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    case 64: return launch_fwd<64, true>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    case 128: return launch_fwd<128, true>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    case 80:
    case 96:
    case 256: return flash_fwd_bf16_wide(q, k, v, slopes, bias, o, lse, B, H, KVH, D, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
