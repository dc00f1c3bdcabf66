// The bfloat16 flash attention forward body for Hopper: o and lse from q, k, v,
// with optional ALiBi slopes and an additive fp32 bias.
//
// Replaces, for bf16, the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (pallas_call at :185, via _flash_fwd, with or without a bias
// tile); the float32 forward stays in flash_attention.cu, and the bf16 dq
// and dk/dv are flash_bwd.cu. The score is flash_common.cuh's masked_score:
// q.k * scale + slope * key_pos + bias, kNegInf outside the causal (and
// window) band, queries aligned to the end of the keys. lse is natural-log
// (the backward kernels read exp(s - lse)); a row that sees no key writes
// zeros and lse = kNegInf, as the plain version.
//
// What bounds it: at gpt2_1_3b's training shape (B 8, S 1024, H 32, D 64,
// causal) 34 GFLOP of products against 135 MB of q, k, v and o: both bounds
// about 0.035-0.04 ms, so the products have to stay on the tensor cores and
// nothing else may take their time. With an evoformer bias (D 32, S 256) the
// fp32 bias is the largest tensor (268 MB at msa_row) and sets the bound.
//
// The design (FlashAttention-2's, on mma.sync):
// - A block owns 128 query rows of one (batch, head): 8 warps of 16 rows.
//   Each warp keeps its scores S, its probabilities P and its O accumulator
//   in registers (Q's fragments are re-read from shared memory each tile). S = Q K^T and O += P V are mma.sync
//   m16n8k16 products (bf16 in, fp32 out), K read by ldmatrix and V by its
//   transposing form. The S accumulator's layout is P's A-operand layout, so
//   P goes from S to the next product as bf16 pairs, without shared memory.
// - The online softmax runs on the fragments: a row lives in the 4 lanes of
//   a quad, so its max and sum take two xor shuffles; l is summed per lane
//   and reduced once at the end. p = 2^x by one ex2.approx. Without ALiBi or
//   a bias, x = q.k scale log2(e) - m scale log2(e) is one FFMA and m is the
//   raw q.k maximum (the max commutes with the positive scale, so lse's m *
//   scale rounds as the plain version's m). With them, x = (s - m) log2(e):
//   folding log2(e) into scores in the hundreds (ALiBi's slope * key_pos)
//   would move lse by about 1e-4.
// - K and V tiles of 64 keys come through a ring of 2 stages in shared
//   memory, filled by cp.async (zero-filled past Sk) while the other tile
//   multiplies, with one block barrier a tile; Q comes in once the same way.
// - Mask arithmetic only where a mask can act: a warp takes the masked body
//   for a tile only if the tile crosses Sk or its causal or window edge for
//   the warp's 16 rows, skips a tile that no row of it sees, and otherwise
//   runs the unmasked body. The two bodies are separate compile-time copies:
//   a run-time flag inside one body was markedly slower.
// - Longest tiles first: the grid's x enumerates (query tile, head) with the
//   last query tile first, so a causal grid ends on its shortest blocks.
// - The bias (fp32, flat (Bb*Hb, Sqb, Sk)) is read straight into the S
//   fragment layout (a quad reads 8 consecutive floats of a row: whole
//   32-byte sectors), issued before the tile's Q K^T so that the loads fly
//   during the products. Indices are clamped into the slice, so the unmasked
//   body needs no guard; clamped values only ever meet masked scores.
// Not yet: wgmma (a warpgroup's 64 rows, K and V as shared-memory operands),
// TMA, warp specialisation, a persistent grid.
//
// Head dims: flash_fwd.cu instantiates it at D 32, 64 and 128 (with and
// without a bias), flash_fwd_wide.cu at D 80, 96 and 256 (without one: the
// Hugging Face families' heads). D is any multiple of 16: Q K^T takes D / 16
// k16 steps and P V D / 16 pairs of n8 tiles, so D 80's 5 steps need no
// pairing. At D 256 the block's shared memory is 198 KB (Q 66 KB, two stages
// of K and V) and each warp's O accumulator 128 fp32 registers a lane beside
// S (32) and P (16), within the 255 of one block of 8 warps an SM.
#pragma once

#include "flash_common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // query rows a block
constexpr int kBN = 64;   // keys a tile
constexpr int kNT = 256;  // eight warps of 16 rows

template <int D>
struct FwdGeo {
  static constexpr int LD = D + 8;  // +16 bytes: ldmatrix rows on distinct banks
  static constexpr size_t q_bytes = static_cast<size_t>(kBM) * LD * 2;
  static constexpr size_t kv_bytes = static_cast<size_t>(kBN) * LD * 2;
  static constexpr size_t smem = q_bytes + 4 * kv_bytes;  // Q, then K and V of 2 stages
};

// Grid (n_qt * H, B): x = (n_qt - 1 - query tile) * H + head. Eight warps of
// 16 rows: four warps of 32 rows (each K and V fragment serving two m16
// tiles) were slower on an H100 at gpt2_1_3b's shape, their registers
// leaving room for one block of 4 warps an SM.
template <int D, bool HAS_BIAS, bool ALIBI>
__global__ void __launch_bounds__(kNT, !HAS_BIAS && D <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const float* __restrict__ slopes, Bias bias, bf16* __restrict__ o, float* __restrict__ lse,
                      int H, int KVH, Mask mk, int n_qt, int bias_vec) {
  using G = FwdGeo<D>;
  constexpr int LD = G::LD, KD = D / 16, NS = kBN / 8, NO = D / 8, VPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + G::q_bytes + (2 * s) * G::kv_bytes); };
  auto sV = [&](int s) { return reinterpret_cast<bf16*>(smem + G::q_bytes + (2 * s + 1) * G::kv_bytes); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int h = blockIdx.x % H, qt = n_qt - 1 - static_cast<int>(blockIdx.x) / H, b = blockIdx.y;
  // without ALiBi or a bias the scale folds into the exponent, and m is kept in raw q.k units
  constexpr bool FOLD = !HAS_BIAS && !ALIBI;
  const float scale2 = mk.scale * kLog2e;
  const int hk = h / (H / KVH);
  const int q0 = qt * kBM, wr = q0 + 16 * warp;  // the block's and the warp's first rows
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const float* bs = bias.slice(b, h, mk.sk);

  int kt_begin = 0, kt_end = (mk.sk + kBN - 1) / kBN;
  if (mk.causal) {
    const int last = mk.offset + min(q0 + kBM, mk.sq) - 1;  // the last key any row of the tile sees
    kt_end = min(kt_end, last < 0 ? 0 : last / kBN + 1);
    if (mk.window > 0) kt_begin = max(mk.offset + q0 - mk.window + 1, 0) / kBN;
  }

  for (int i = tid; i < kBM * VPR; i += kNT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = q0 + r < mk.sq;
    cp_async16(sQ + r * LD + c, ok ? q + ((static_cast<size_t>(b) * mk.sq + q0 + r) * H + h) * D + c : q,
               ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_kv = [&](int s, int kt) {
    const int k0 = kt * kBN;
    bf16* dk = sK(s);
    bf16* dv = sV(s);
    for (int i = tid; i < kBN * VPR; i += kNT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool ok = k0 + r < mk.sk;
      const size_t off = ((static_cast<size_t>(b) * mk.sk + k0 + r) * KVH + hk) * D + c;
      cp_async16(dk + r * LD + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(dv + r * LD + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };
  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_async_commit();

  // this lane's rows: wr + g + 8 r for r in {0, 1}
  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin, s = it & 1, k0 = kt * kBN;
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q) landed for every thread; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) load_kv(s ^ 1, kt + 1);  // into tile kt - 1's stage, while tile kt multiplies
    cp_async_commit();
    // which keys of the tile the warp's rows see: all, some, or none
    bool masked = k0 + kBN > mk.sk;
    bool none = false;
    if (mk.causal) {
      const int diag_lo = mk.offset + wr, diag_hi = mk.offset + wr + 15;  // the first and last row's last key
      none = k0 > diag_hi || (mk.window > 0 && k0 + kBN - 1 <= diag_lo - mk.window);
      masked = masked || k0 + kBN - 1 > diag_lo || (mk.window > 0 && k0 <= diag_hi - mk.window);
    }
    if (none) continue;
    float bv[NS][4];
    if constexpr (HAS_BIAS) {
      const int ra = bias.Sqb == 1 ? 0 : min(wr + g, mk.sq - 1), rb = bias.Sqb == 1 ? 0 : min(wr + g + 8, mk.sq - 1);
      const float* pa = bs + static_cast<size_t>(ra) * mk.sk;
      const float* pb = bs + static_cast<size_t>(rb) * mk.sk;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = k0 + j * 8 + t2;
        if (bias_vec) {  // Sk even: pairs of columns, clamped to the last pair
          const int cc = min(c, mk.sk - 2);
          const float2 x0 = __ldg(reinterpret_cast<const float2*>(pa + cc));
          const float2 x1 = __ldg(reinterpret_cast<const float2*>(pb + cc));
          bv[j][0] = x0.x;
          bv[j][1] = x0.y;
          bv[j][2] = x1.x;
          bv[j][3] = x1.y;
        } else {
          const int c0 = min(c, mk.sk - 1), c1 = min(c + 1, mk.sk - 1);
          bv[j][0] = __ldg(pa + c0);
          bv[j][1] = __ldg(pa + c1);
          bv[j][2] = __ldg(pb + c0);
          bv[j][3] = __ldg(pb + c1);
        }
      }
    }
    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    const bf16* ks = sK(s);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      // Q's fragments come from shared memory each tile: held in registers they pushed D 64 past 128 a thread
      uint32_t qa[4];
      ldsm_x4(qa, sQ + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], qa, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qa, r[2], r[3]);
      }
    }
    // scores (masked_score's arithmetic), row maxima, P; MASKED is a compile-time copy, so the tiles no mask
    // cuts run without a compare or a select
    uint32_t pa[NS / 2][4];  // P as the A operand of P V: 16 keys per k-step
    auto softmax = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t2 + (e & 1);
          float sv = sacc[j][e];  // FOLD: the raw q.k (the max commutes with the positive scale)
          if constexpr (!FOLD) sv *= mk.scale;
          if constexpr (ALIBI) sv += slope * static_cast<float>(col);
          if constexpr (HAS_BIAS) sv += bv[j][e];
          if constexpr (MASKED) sv = visible(wr + g + (e < 2 ? 0 : 8), col, mk) ? sv : kNegInf;
          sacc[j][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      float mn[2], ms[2], al[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = fmaxf(m_r[r], quad_max(mx[r]));
        // FOLD: 2^(q.k scale log2(e) - m scale log2(e)) is one FFMA; else 2^((s - m) log2(e))
        // the old max is rounded as ms is (no FMA): equal maxima, kNegInf ones included, give 2^0 exactly
        ms[r] = __fmul_rn(mn[r], scale2);
        al[r] = FOLD ? fast_exp2(__fmul_rn(m_r[r], scale2) - ms[r]) : fast_exp2((m_r[r] - mn[r]) * kLog2e);
        m_r[r] = mn[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (FOLD) {
            p[e] = fast_exp2(fmaf(sacc[j][e], scale2, -ms[e >> 1]));
          } else {
            p[e] = fast_exp2((sacc[j][e] - mn[e >> 1]) * kLog2e);
          }
          if (MASKED && sacc[j][e] <= kNegInf) p[e] = 0.f;
        }
        ps[0] += p[0] + p[1];
        ps[1] += p[2] + p[3];
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * al[r] + ps[r];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        oacc[j][0] *= al[0];
        oacc[j][1] *= al[0];
        oacc[j][2] *= al[1];
        oacc[j][3] *= al[1];
      }
    };
    if (masked) {
      softmax(std::true_type{});
    } else {
      softmax(std::false_type{});
    }
    const bf16* vs = sV(s);
#pragma unroll
    for (int kb = 0; kb < NS / 2; ++kb)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + (kb * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(oacc[2 * dp], pa[kb], r[0], r[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kb], r[2], r[3]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    const float l = quad_sum(l_r[r]);
    if (row >= mk.sq) continue;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    bf16* orow = o + ((static_cast<size_t>(b) * mk.sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t2) = pack_bf16(oacc[j][2 * r] * inv, oacc[j][2 * r + 1] * inv);
    if ((lane & 3) == 0) {
      // natural-log lse; m * scale rounds as the plain version's max of q.k * scale; no key: kNegInf
      const float m = FOLD ? m_r[r] * mk.scale : m_r[r];
      lse[(static_cast<size_t>(b) * H + h) * mk.sq + row] = l == 0.f ? kNegInf : m + logf(l);
    }
  }
}

// WITH_BIAS: also the bodies with an additive bias (D 32, 64, 128). The wide head dims (flash_fwd_wide.cu) build
// only the bodies without one: a bias there is refused.
template <int D, bool WITH_BIAS>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const float* slopes, Bias bias, bf16* o, float* lse,
               int B, int H, int KVH, Mask mk, cudaStream_t stream) {
  const int n_qt = (mk.sq + kBM - 1) / kBM;
  if (static_cast<long long>(n_qt) * H > 0x7fffffffLL) return kUnsupported;
  dim3 grid(n_qt * H, B);
  const int bias_vec = mk.sk % 2 == 0 && (reinterpret_cast<uintptr_t>(bias.p) & 7u) == 0;
  auto kernel = slopes != nullptr ? flash_fwd_bf16_kernel<D, false, true> : flash_fwd_bf16_kernel<D, false, false>;
  if constexpr (WITH_BIAS) {
    if (bias.p != nullptr)
      kernel = slopes != nullptr ? flash_fwd_bf16_kernel<D, true, true> : flash_fwd_bf16_kernel<D, true, false>;
  } else if (bias.p != nullptr) {
    return kUnsupported;
  }
  const cudaError_t err = allow_smem(kernel, FwdGeo<D>::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kNT, FwdGeo<D>::smem, stream>>>(q, k, v, slopes, bias, o, lse, H, KVH, mk, n_qt, bias_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch
