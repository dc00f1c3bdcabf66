// The bfloat16 flash attention dk/dv (flash_bwd.cuh) at the head dims of the Hugging
// Face families: D 80 (phi-2), 96 (phi-3-mini, gpt-neox-20b) and 256 (gemma,
// gpt-j), without a bias (the bias bodies are built at D 32, 64 and 128 only,
// for evoformer). A translation unit of its own, so that nvcc builds it beside
// flash_bwd.cu in parallel.
//
// Replaces, for bf16 at these head dims, the TPU kernel
// deepspeed_tpu/ops/pallas/flash_attention.py _dkv_kernel_gqa (pallas_call at :518).
// What bounds it at phi-2's training shape (B 4, S 2048, 32 heads of 80,
// causal): 4 products (S^T, dP^T, dV, dK), 172 GFLOP, against 252 MB of
// operands: the tensor cores (0.174 ms) over the bytes (0.075 ms). At D 256
// the two halves of the grid (flash_bwd.cuh, DkvGeo::SPLIT) do 5 products.
// Gemma-2B's 8 query heads on one KV head sum into one dK and dV in the
// block, in order, as at D 128.
#include "flash_bwd.cuh"

namespace dstorch {

int flash_dkv_bf16_wide(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                        const float* delta, const float* slopes, Bias bias, bf16* dk, bf16* dv, int B, int H,
                        int KVH, int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 80: return launch_dkv<80, false>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 96: return launch_dkv<96, false>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 256: return launch_dkv<256, false>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
