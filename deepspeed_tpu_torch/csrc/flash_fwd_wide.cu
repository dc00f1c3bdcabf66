// The bfloat16 flash attention forward (flash_fwd.cuh) at the head dims of the
// Hugging Face families: D 80 (phi-2), 96 (phi-3-mini, gpt-neox-20b) and 256
// (gemma, gpt-j), without a bias (the bias bodies are built at D 32, 64 and
// 128 only, for evoformer). A translation unit of its own, so that nvcc builds
// it beside flash_fwd.cu in parallel.
//
// Replaces, for bf16 at these head dims, the TPU kernel
// deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel (pallas_call at
// :185, whose BlockSpecs (1, bq, D) take any D). What bounds it at phi-2's
// training shape (B 4, S 2048, 32 heads of 80, causal): 2 products of 2 D
// flops a visible (query, key) pair, 86 GFLOP, against 168 MB of q, k, v and
// o: the tensor cores (0.087 ms at 989 TFLOP/s) over the bytes (0.050 ms at
// 3.35 TB/s), so as at D 64 the products have to stay on the tensor cores.
#include "flash_fwd.cuh"

namespace dstorch {

int flash_fwd_bf16_wide(const bf16* q, const bf16* k, const bf16* v, const float* slopes, Bias bias, bf16* o,
                        float* lse, int B, int H, int KVH, int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 80: return launch_fwd<80, false>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    case 96: return launch_fwd<96, false>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    case 256: return launch_fwd<256, false>(q, k, v, slopes, bias, o, lse, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
