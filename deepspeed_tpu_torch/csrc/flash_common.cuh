// Definitions shared by the flash attention kernels (flash_attention.cu and
// flash_fp32.cuh: the float32 forward, dq and dk/dv, the float32 collapsed dq
// and the reduce of the collapsed dq's partials; flash_fwd.cuh: the bfloat16
// forward; flash_bwd.cuh: the bfloat16 dq and dk/dv, with or without a bias,
// and the bfloat16 collapsed dq; the *_wide.cu sources build them at D 80, 96
// and 256): the mask, the additive bias, the programs that share
// a bias slice and THE masked score every kernel uses.
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

// Program (as b * H + h) of sharing index `rep` over bias slice `s`: the
// reference's q_b (_flash_bwd, :447-454).
__device__ __forceinline__ int sharing_program(const Bias& bias, int s, int rep, int H) {
  if (bias.Bb == 1 && bias.Hb == 1) return rep;
  if (bias.Hb == 1) return (s * bias.repeat + rep / H) * H + rep % H;  // batch collapsed by repeat, heads share
  if (bias.Bb == 1) return rep * H + s;                                  // only heads distinct
  return ((s / H) * bias.repeat + rep) * H + s % H;
}

// How the collapsed dq splits its work: n_qt query tiles x n_bh slices x
// n_chunks chunks of `per` sharing programs (of n_rep); n_parts fp32 partials
// of dbias (1: the kernel writes dbias itself).
struct CollapsedPlan {
  int n_qt, n_bh, n_rep, per, n_chunks, n_parts;
};

// Bias of query row `row`, key `col` in slice `bs` (0 without a bias, and
// outside the tensor, where the score is masked anyway).
__device__ __forceinline__ float bias_at(const float* bs, int sqb, int row, int col, const Mask& m) {
  if (bs == nullptr || row >= m.sq || col >= m.sk) return 0.f;
  return bs[static_cast<size_t>(sqb == 1 ? 0 : row) * m.sk + col];
}

// THE mask: query row `row` sees key `col` (both in range, and inside the
// causal and window band; row r sits at key position offset + r).
__device__ __forceinline__ bool visible(int row, int col, const Mask& m) {
  bool vis = row < m.sq && col < m.sk;
  if (m.causal) {
    const int r = m.offset + row;
    vis = vis && col <= r && !(m.window > 0 && col <= r - m.window);
  }
  return vis;
}

// THE masked score (the reference's _scores): raw q.k of query row `row` and
// key `col` -> fp32 score, or kNegInf where the pair is masked or out of range.
// The bias enters before the mask, so masked entries are exactly kNegInf.
// HAS_BIAS is a template parameter so that the kernels without a bias carry
// no bias code at all (the score loop is what sets their time).
template <bool HAS_BIAS>
__device__ __forceinline__ float masked_score(float qk, int row, int col, float slope, float bias, const Mask& m) {
  if (!visible(row, col, m)) return kNegInf;
  const float s = qk * m.scale + slope * static_cast<float>(col);
  return HAS_BIAS ? s + bias : s;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (ex2.approx, relative error about 2^-22; 2^-huge = +0, 2^0 = 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max and the sum over the 4 lanes of a quad: the lanes that hold one row of an mma.sync C fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bfloat16 forward (flash_fwd.cu): o (B, Sq, H, D) bf16 and lse (B, H, Sq)
// fp32 from q (B, Sq, H, D), k, v (B, Sk, KVH, D); D in {32, 64, 128} (with or
// without a bias) or {80, 96, 256} (without one: flash_fwd_wide.cu). Returns 0,
// a cudaError_t, or kUnsupported.
int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* slopes,
                   Bias bias, __nv_bfloat16* o, float* lse, int B, int H, int KVH, int D, Mask mk,
                   cudaStream_t stream);

// The bfloat16 backward (flash_bwd.cu), from dout like q and lse, delta
// (B, H, Sq) fp32: dq like q; dk, dv like k, each summed over the H / KVH
// query heads of its KV head. With a bias (bias.p not null), dq's bias must be
// one that nothing collapses (Bb*Hb == B*H, Sqb == Sq: ds_flash_bwd_dq checks)
// and dbias (B*H, Sq, Sk) fp32 receives every program's dlogits; dk/dv take
// any bias layout. Same returns.
int flash_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  const __nv_bfloat16* dout, const float* lse, const float* delta, const float* slopes, Bias bias,
                  __nv_bfloat16* dq, float* dbias, int B, int H, int KVH, int D, Mask mk, cudaStream_t stream);
int flash_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta, const float* slopes, Bias bias,
                   __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int KVH, int D, Mask mk,
                   cudaStream_t stream);

// The same three at D 80, 96 and 256, the Hugging Face families' heads, without a bias (a bias returns
// kUnsupported): bf16 in flash_fwd_wide.cu, flash_dq_wide.cu and flash_dkv_wide.cu (flash_fwd_bf16,
// flash_dq_bf16 and flash_dkv_bf16 route there), fp32 in flash_fp32_wide.cu.
int flash_fwd_bf16_wide(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* slopes,
                        Bias bias, __nv_bfloat16* o, float* lse, int B, int H, int KVH, int D, Mask mk,
                        cudaStream_t stream);
int flash_dq_bf16_wide(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* dout, const float* lse, const float* delta, const float* slopes,
                       Bias bias, __nv_bfloat16* dq, float* dbias, int B, int H, int KVH, int D, Mask mk,
                       cudaStream_t stream);
int flash_dkv_bf16_wide(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const __nv_bfloat16* dout, const float* lse, const float* delta, const float* slopes,
                        Bias bias, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int KVH, int D, Mask mk,
                        cudaStream_t stream);
int flash_fwd_f32_wide(const float* q, const float* k, const float* v, const float* slopes, float* o, float* lse,
                       int B, int H, int KVH, int D, Mask mk, cudaStream_t stream);
int flash_dq_f32_wide(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                      const float* delta, const float* slopes, float* dq, int B, int H, int KVH, int D, Mask mk,
                      cudaStream_t stream);
int flash_dkv_f32_wide(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                       const float* delta, const float* slopes, float* dk, float* dv, int B, int H, int KVH, int D,
                       Mask mk, cudaStream_t stream);

// The bfloat16 collapsed dq (flash_bwd.cu): dq like q, and the plan's n_parts
// fp32 partials of dbias in `part` ((n_parts, Bb*Hb, Sqb, Sk); dbias itself when
// n_parts is 1), which flash_attention.cu sums in a fixed order. The bias is
// collapsed (ds_flash_bwd_dq_collapsed checks); Sqb is 1 or Sq. Same returns.
// flash_dq_collapsed_bf16_geometry gives the query rows and warps of a block,
// which the plan needs.
void flash_dq_collapsed_bf16_geometry(int* rows, int* warps);
int flash_dq_collapsed_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                            const __nv_bfloat16* dout, const float* lse, const float* delta, const float* slopes,
                            Bias bias, __nv_bfloat16* dq, float* part, int H, int KVH, int D, Mask mk,
                            const CollapsedPlan& pl, cudaStream_t stream);

}  // namespace dstorch
