// The bfloat16 flash attention dq (flash_bwd.cuh) at the head dims of the Hugging
// Face families: D 80 (phi-2), 96 (phi-3-mini, gpt-neox-20b) and 256 (gemma,
// gpt-j), without a bias (the bias bodies are built at D 32, 64 and 128 only,
// for evoformer). A translation unit of its own, so that nvcc builds it beside
// flash_bwd.cu in parallel.
//
// Replaces, for bf16 at these head dims, the TPU kernel
// deepspeed_tpu/ops/pallas/flash_attention.py _dq_kernel (pallas_call at :417).
// What bounds it at phi-2's training shape (B 4, S 2048, 32 heads of 80,
// causal): 3 products (S, dP, dQ), 129 GFLOP, against 210 MB of operands: the
// tensor cores (0.130 ms) over the bytes (0.063 ms).
#include "flash_bwd.cuh"

namespace dstorch {

int flash_dq_bf16_wide(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                       const float* delta, const float* slopes, Bias bias, bf16* dq, float* dbias, int B, int H,
                       int KVH, int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 80: return launch_dq<80, false>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 96: return launch_dq<96, false>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 256: return launch_dq<256, false>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
