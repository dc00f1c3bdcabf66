// Paged (block-table) KV attention for Hopper: the C entry points of decode
// and chunked prefill, and their float32 bodies (paged_fp32.cuh; built here at
// D 64 and 128, in paged_attention_wide.cu at D 80, 96 and 256).
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/paged_attention.py::
// _decode_kernel (paged_attention_decode, pallas_call at :386) and
// ::_prefill_kernel (paged_attention_prefill, :531), each with its
// quantized=True body. The entry points send a bf16 q, on bf16 or int8
// pools, to the redesigned bodies of paged_decode.cu (flash-decoding: splits
// of the context in registers, then a fixed-order combine) and
// paged_prefill.cu (mma.sync tiles); a float32 q stays here. The pool
// layout, the masks and ALiBi are paged.cuh's.
//
// The float32 bodies: on the TPU the grid walked (row, page) in order and
// carried the online softmax state in VMEM scratch between grid steps. Here
// each block owns its rows outright and walks the pages itself in a loop,
// reading block_tables on its own (no scalar prefetch). Key tiles are staged
// in shared memory with a padded row stride (D + one 16-byte vector) so that
// 16-byte vector writes stay aligned and the row-strided reads of the score
// loop hit distinct banks. Softmax state and accumulators stay in fp32
// registers; plain FMA loops, no tensor cores. ALiBi (the score gains
// slope * key position before the mask) and the sliding window (tiles wholly
// before the band are skipped) are compile-time copies of each body.
//
// int8 pools (the reference's quantized=True bodies): pages hold int8 codes
// (N, bs, KVH, D) with one fp32 scale per slot and KV head in planes
// (N, bs, KVH). The kernels are templated on the pool's element type: codes are
// staged as they are, and the scales go next to the products: a key's score is
// its K scale times the dot product of q with the integer codes, and its V
// scale folds into its softmax weight before the PV product (the normaliser
// keeps the unscaled weight). That is exact in fp32. A slot that was never
// written has scale 0 and codes 0 and contributes nothing.
#include "paged_fp32.cuh"

// Common checks of both entry points; false for what no body takes.
static bool pools_ok(const void* k_pages, const void* v_pages, const void* k_scales, const void* v_scales, int B,
                     int H, int KVH, int window) {
  return KVH > 0 && H % KVH == 0 && B <= 65535 && KVH <= 65535 && window >= 0 && dstorch::aligned16(k_pages) &&
         dstorch::aligned16(v_pages) && (k_scales == nullptr) == (v_scales == nullptr);
}

// q (B, H, D); pools (N, bs, KVH, D), 16-byte aligned: of q's dtype with k_scales = v_scales = null, or
// int8 codes with fp32 scale planes (N, bs, KVH); block_tables (B, P) and ctx_lens (B,) int32; slopes (H,)
// fp32 ALiBi slopes or null; window 0 (none) or the sliding window; out (B, H, D). D in {64, 80, 96, 128,
// 256}; any H / KVH (more than 8: chunks of 8 heads). bf16: `splits` ranges of `split_keys` keys
// (splits * split_keys >= P * bs) and, for splits > 1, a workspace of B H splits (D + 2) floats; float32
// ignores both.
extern "C" int ds_paged_attention_decode(const void* q, const void* k_pages, const void* v_pages,
                                         const void* k_scales, const void* v_scales, const void* block_tables,
                                         const void* ctx_lens, const void* slopes, void* out, void* workspace, int B,
                                         int H, int KVH, int D, int bs, int P, int window, int splits,
                                         int split_keys, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0) return 0;
  if (!pools_ok(k_pages, v_pages, k_scales, v_scales, B, H, KVH, window)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a{q, k_pages, v_pages, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                    static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens), nullptr,
                    static_cast<const float*>(slopes), out, static_cast<float*>(workspace), B, 1, H, KVH, D, bs, P,
                    window, splits, split_keys, scale};
  if (dtype == kBFloat16) return paged_decode_bf16(a, s);
  if (dtype != kFloat32) return kUnsupported;
  if (D == 64) return decode_by_pool<64>(a, s);
  if (D == 128) return decode_by_pool<128>(a, s);
  return paged_decode_fp32_wide(a, s);
}

// q (B, S, H, D); pools, slopes and window as above; qpos0 (B,) int32 = absolute position of each row's
// query 0 (positions are consecutive); out (B, S, H, D). D in {64, 80, 96, 128, 256}; any H / KVH. bf16: the key
// tiles dealt round-robin to `splits` blocks and, for splits > 1, a workspace of B S H splits (D + 2)
// floats; float32 ignores both.
extern "C" int ds_paged_attention_prefill(const void* q, const void* k_pages, const void* v_pages,
                                          const void* k_scales, const void* v_scales, const void* block_tables,
                                          const void* ctx_lens, const void* qpos0, const void* slopes, void* out,
                                          void* workspace, int B, int S, int H, int KVH, int D, int bs, int P,
                                          int window, int splits, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0 || S <= 0) return 0;
  if (!pools_ok(k_pages, v_pages, k_scales, v_scales, B, H, KVH, window)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a{q, k_pages, v_pages, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                    static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens),
                    static_cast<const int*>(qpos0), static_cast<const float*>(slopes), out,
                    static_cast<float*>(workspace), B, S, H, KVH, D, bs, P, window, splits, 0, scale};
  if (dtype == kBFloat16) return paged_prefill_bf16(a, s);
  if (dtype != kFloat32) return kUnsupported;
  if (D == 64) return prefill_by_pool<64>(a, s);
  if (D == 128) return prefill_by_pool<128>(a, s);
  return paged_prefill_fp32_wide(a, s);
}
