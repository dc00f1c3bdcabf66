// Definitions shared by the flash attention kernels (flash_attention.cu: the
// float32 forward, dq and dk/dv; flash_fwd.cu: the bfloat16 forward): the
// mask, the additive bias and THE masked score every kernel uses.
#pragma once

#include "common.cuh"

namespace dstorch {

struct Mask {
  int sq, sk, offset;  // offset = sk - sq: query row r sits at key position offset + r
  int causal, window;  // window > 0 only with causal: row r sees keys (r - window, r]
  float scale;
};

// The additive bias: fp32, flat (Bb*Hb, Sqb, Sk), null when there is none.
struct Bias {
  const float* p;
  int Bb, Hb, Sqb, repeat;  // query batch b reads bias batch b / repeat (Bb > 1)

  // The slice program (b, h) reads: the reference's _bias_bh_fn.
  __device__ __forceinline__ const float* slice(int b, int h, int sk) const {
    if (p == nullptr) return nullptr;
    const int idx = (Bb == 1 ? 0 : b / repeat) * Hb + (Hb == 1 ? 0 : h);
    return p + static_cast<size_t>(idx) * Sqb * sk;
  }
};

// Bias of query row `row`, key `col` in slice `bs` (0 without a bias, and
// outside the tensor, where the score is masked anyway).
__device__ __forceinline__ float bias_at(const float* bs, int sqb, int row, int col, const Mask& m) {
  if (bs == nullptr || row >= m.sq || col >= m.sk) return 0.f;
  return bs[static_cast<size_t>(sqb == 1 ? 0 : row) * m.sk + col];
}

// THE masked score (the reference's _scores): raw q.k of query row `row` and
// key `col` -> fp32 score, or kNegInf where the pair is masked or out of range.
// The bias enters before the mask, so masked entries are exactly kNegInf.
// HAS_BIAS is a template parameter so that the kernels without a bias carry
// no bias code at all (the score loop is what sets their time).
template <bool HAS_BIAS>
__device__ __forceinline__ float masked_score(float qk, int row, int col, float slope, float bias, const Mask& m) {
  if (row >= m.sq || col >= m.sk) return kNegInf;
  if (m.causal) {
    const int r = m.offset + row;
    if (col > r || (m.window > 0 && col <= r - m.window)) return kNegInf;
  }
  const float s = qk * m.scale + slope * static_cast<float>(col);
  return HAS_BIAS ? s + bias : s;
}

// The bfloat16 forward (flash_fwd.cu): o (B, Sq, H, D) bf16 and lse (B, H, Sq)
// fp32 from q (B, Sq, H, D), k, v (B, Sk, KVH, D); D in {32, 64, 128}. Returns
// 0, a cudaError_t, or kUnsupported.
int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* slopes,
                   Bias bias, __nv_bfloat16* o, float* lse, int B, int H, int KVH, int D, Mask mk,
                   cudaStream_t stream);

}  // namespace dstorch
