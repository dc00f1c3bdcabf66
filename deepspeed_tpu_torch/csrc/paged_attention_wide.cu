// The float32 paged bodies (paged_fp32.cuh) at the head dims of the Hugging
// Face families beside the llama family's: D 80 (phi-2), 96 (phi-3-mini,
// gpt-neox-20b) and 256 (gemma, gpt-j). A translation unit of their own, so
// that nvcc builds them beside paged_attention.cu (D 64 and 128) in parallel.
#include "paged_fp32.cuh"

namespace dstorch {

int paged_decode_fp32_wide(const PagedArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 80: return decode_by_pool<80>(a, s);
    case 96: return decode_by_pool<96>(a, s);
    case 256: return decode_by_pool<256>(a, s);
    default: return kUnsupported;
  }
}

int paged_prefill_fp32_wide(const PagedArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 80: return prefill_by_pool<80>(a, s);
    case 96: return prefill_by_pool<96>(a, s);
    case 256: return prefill_by_pool<256>(a, s);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
