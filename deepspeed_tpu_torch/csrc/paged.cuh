// Definitions shared by the paged attention kernels: paged_attention.cu (the C
// entry points and the float32 bodies), paged_decode.cu (the bfloat16 decode
// and the fixed-order combine of split partials) and paged_prefill.cu (the
// bfloat16 chunked prefill).
//
// The pool layout is the reference's: k/v pages (N, bs, KVH, D) of q's type,
// or int8 codes of that shape with one fp32 scale per slot and KV head in
// planes (N, bs, KVH); block_tables (B, P) int32; ctx_lens (B,) int32
// counting every visible key. Key position p of row b lives in pool block
// block_tables[b, p / bs] at slot p % bs. Query position qp sees key p when
// p < ctx, p <= qp and, with a window w > 0, p > qp - w; with ALiBi the score
// gains slopes[head] * p before the mask.
#pragma once

#include "flash_common.cuh"

namespace dstorch {

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kscale;  // int8 pools: the scale planes; null for pools of q's type
  const float* vscale;
  const int* bt;
  const int* ctx;
  const int* qpos0;     // prefill: absolute position of each row's query 0
  const float* slopes;  // (H,) ALiBi slopes, or null
  void* out;
  // Split partials, when splits > 1: acc (rows, splits, D) fp32, then (m, l)
  // (rows, splits, 2), rows = the output's rows of D (B H for decode, B S H for
  // prefill). m is in log2 units without ALiBi and in natural units with it.
  float* ws;
  int B, S, H, KVH, D, bs, P;
  int window;      // 0: none
  int splits;      // decode: key ranges of split_keys each; prefill: key tiles dealt round-robin
  int split_keys;  // decode only
  float scale;
};

// The (m, l) pairs of the split partials, after the accumulators.
__host__ __device__ __forceinline__ float* partial_ml(const PagedArgs& a, size_t rows) {
  return a.ws + rows * a.splits * a.D;
}

// The bfloat16 bodies; each returns 0, a cudaError_t or kUnsupported.
int paged_decode_bf16(const PagedArgs& a, cudaStream_t stream);
int paged_prefill_bf16(const PagedArgs& a, cudaStream_t stream);
// Merge the split partials of `rows` output rows, in split order, into a.out (bf16).
int paged_combine_bf16(const PagedArgs& a, int rows, cudaStream_t stream);

}  // namespace dstorch
