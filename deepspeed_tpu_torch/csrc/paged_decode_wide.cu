// The bfloat16 paged decode (paged_decode.cuh) at D 80 (phi-2), 96 (phi-3-mini,
// gpt-neox-20b) and 256 (gemma, gpt-j): a translation unit of its own, so that
// nvcc builds it beside paged_decode.cu (D 64 and 128) in parallel.
#include "paged_decode.cuh"

namespace dstorch {

int paged_decode_bf16_wide(const PagedArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 80: return decode_by_pool<80>(a, s);
    case 96: return decode_by_pool<96>(a, s);
    case 256: return decode_by_pool<256>(a, s);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
