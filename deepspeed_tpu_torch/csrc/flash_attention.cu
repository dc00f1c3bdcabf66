// Flash attention for Hopper: forward, dq and dk/dv over (B, S, H, D) tensors,
// with an optional additive bias and its gradient. The bfloat16 forward is
// flash_fwd.cu's register-resident kernel (ds_flash_fwd routes to it), and so
// are the bfloat16 dq and dk/dv, with or without a bias, and the bfloat16
// collapsed dq in flash_bwd.cu (ds_flash_bwd_dq, ds_flash_bwd_dkv and
// ds_flash_bwd_dq_collapsed route to them). This file holds the rest, whose
// design follows: the float32 forward, dq and dk/dv (with or without a bias)
// and collapsed dq, the collapsed dq's plan in both dtypes and the fixed-order
// reduce of its partials. The mask, the bias and masked_score live in
// flash_common.cuh.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (pallas_call at :185, via _flash_fwd; here in fp32, with or
// without a bias tile), _dq_kernel (:417, via _flash_bwd; here in fp32, where
// with a bias it writes dbias per program), _dq_kernel_collapsed (:456: dq
// plus dbias summed over the programs that share a bias slice; here in fp32,
// and the plan and reduce of both dtypes),
// _dkv_kernel (:485: dk/dv with the bias tile; here in fp32) and
// _dkv_kernel_gqa (:518; here in fp32). The masked score is the reference's _scores:
// s = (q.k) * scale + slope * key_pos + bias, masked to kNegInf outside the
// causal (and sliding-window) band, with queries aligned to the END of the keys
// (offset = Sk - Sq). The bias is added before masking, so a masked entry is
// exactly kNegInf whatever the bias (an evoformer mask bias of -1e9 is finite
// and stays a score). masked_score (flash_common.cuh) is the one definition
// every kernel uses.
//
// What bounds it: in fp32 the products, at 67 TFLOP/s without the tensor
// cores (the forward does 4*S^2/2*D flops per causal head against reading q,
// k, v and writing o once; dq and dk/dv do 3 and 4 products). The design
// keeps the S x S scores out of device memory, as the TPU kernel did:
// - The TPU grid walked key blocks in order and carried the softmax state in
//   VMEM. Here a block owns a tile of 16*NW query rows (forward, dq) or key
//   rows (dk/dv) and walks the other sequence in a loop inside the block.
// - Each warp owns 16 rows of the block's tile outright: it computes its
//   stripe of scores, its softmax, and its stripe of the output, so only the
//   staging of a shared tile needs a block barrier.
// - dk/dv works on the transposed problem (key rows against query columns:
//   S^T = K Q^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q), so the same two
//   warp products serve all three kernels. It loops over the n_rep query heads
//   of its KV head inside the block and accumulates dK/dV in fp32 in shared
//   memory: no atomics, and the result does not depend on scheduling.
// - The products are plain fp32 FMA loops (the same arithmetic as the
//   reference). Accumulators live in shared memory, which lets each lane
//   rescale its rows by the online-softmax correction.
// - Any Sq and Sk: rows past the end are zero-filled in shared memory and
//   masked, so a zero weight never meets NaN; no divisibility is required.
// - lse and delta are (B, H, Sq) fp32, without the TPU's 128-lane padding.
// - The bias is fp32, flat (Bb*Hb, Sqb, Sk) with Sqb 1 or Sq and any Sk; a
//   program (b, h) reads slice (Bb > 1 ? b / repeat : 0) * Hb + (Hb > 1 ? h : 0)
//   (the reference's _bias_bh_fn). Forward and dq read it straight from device
//   memory, lane by lane along a row (coalesced, no alignment needed); dk/dv,
//   whose lanes run along query rows, stages each (query x key) bias tile in
//   shared memory with coalesced loads first.
// - dbias without atomics and without expanding a collapsed bias: a dq block
//   owns its region of dbias outright. When programs share a slice, the
//   collapsed kernel's block walks a chunk of the sharing programs in a loop
//   (as dk/dv walks a group's heads) and adds each program's dlogits into its
//   own fp32 partial; a row shared by every query row (Sqb == 1) gets each
//   warp's column sum over its 16 rows. The chunks exist to fill the card
//   (few slices give a small grid); a second kernel sums the partials in a
//   fixed order, so dbias repeats bit for bit from run to run.
// Not yet, for the fp32 bodies here: scores in registers, a cp.async ring and
// compile-time mask bodies (as flash_fwd.cu and flash_bwd.cu), wgmma, TMA.
#include "flash_common.cuh"

#include <algorithm>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

// Block tiles per element type (the bodies here run fp32): NW warps of 16 rows
// each, BN columns per inner tile, small enough that dk/dv's fp32 operands fit
// shared memory.
template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int NW = 2, BN = 32;
};

// ---------------------------------------------------------------- warp products
// C[16 x N] = A[16 x K] . B[N x K]^T and C[16 x N] += A[16 x K] . B[K x N]; A, B
// row-major in shared memory, C fp32.
template <int N, int K>
__device__ __forceinline__ void warp_nt(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    const float* b = B + c * ldb;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[k], b[k], s);
    C[r * ldc + c] = s;
  }
}

template <int N, int K>
__device__ __forceinline__ void warp_nn_acc(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    float s = C[r * ldc + c];
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[k], B[k * ldb + c], s);
    C[r * ldc + c] = s;
  }
}

// ---------------------------------------------------------------- staging
// Rows [r0, r0 + ROWS) of head h of a (B, S, NH, D) tensor into shared memory
// (row stride LD elements) with 16-byte loads; rows at or past S are zeros.
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage(T* sX, const T* __restrict__ x, int b, int S, int NH, int h, int r0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(x + ((static_cast<size_t>(b) * S + r0 + r) * NH + h) * D + c);
    *reinterpret_cast<uint4*>(sX + r * LD + c) = val;
  }
}

template <typename T>
__device__ __forceinline__ void zero(T* p, int n, int nt) {
  for (int i = threadIdx.x; i < n; i += nt) p[i] = from_float<T>(0.f);
}

// Shared-memory layout sizes, each rounded up to 128 bytes (16-byte loads and
// stores stay aligned).
__host__ __device__ constexpr size_t round128(size_t b) { return (b + 127) / 128 * 128; }

template <typename T, int D>
struct Geo {
  static constexpr int NW = Tiles<T>::NW, NT = 32 * NW, BM = 16 * NW, BN = Tiles<T>::BN;
  static constexpr int LDT = D + 16 / static_cast<int>(sizeof(T));   // T tiles of width D
  static constexpr int LDS = BN + 4;                                  // fp32 tiles of width BN
  static constexpr int LDP = BN + 16 / static_cast<int>(sizeof(T));  // T tiles of width BN
  static constexpr int LDO = D + 4;                                   // fp32 tiles of width D
  static constexpr size_t tileT_M = round128(sizeof(T) * BM * LDT);   // BM rows of D (T)
  static constexpr size_t tileT_N = round128(sizeof(T) * BN * LDT);   // BN rows of D (T)
  static constexpr size_t tileS = round128(sizeof(float) * BM * LDS);
  static constexpr size_t tileP = round128(sizeof(T) * BM * LDP);
  static constexpr size_t tileO = round128(sizeof(float) * BM * LDO);
  static constexpr size_t vecN = round128(sizeof(float) * BN);
  static constexpr size_t fwd = tileT_M + 2 * tileT_N + tileS + tileP + tileO;
  static constexpr size_t dq = 2 * tileT_M + 2 * tileT_N + 2 * tileS + tileP + tileO;
  static constexpr size_t dkv = 2 * tileT_M + 2 * tileT_N + 2 * vecN + 2 * tileS + 2 * tileP + 2 * tileO;
  static constexpr int LDB = BM + 1;                                  // fp32 bias tile, BN query rows x BM keys
  static constexpr size_t tileB = round128(sizeof(float) * BN * LDB);  // dk/dv with a bias: after dkv
};

// ---------------------------------------------------------------- forward
// Grid (ceil(Sq / BM), H, B). o (B, Sq, H, D) in T; lse (B, H, Sq) fp32.
template <typename T, int D, bool HAS_BIAS>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ slopes, Bias bias, T* __restrict__ o, float* __restrict__ lse, int H,
                 int KVH, Mask mk) {
  using G = Geo<T, D>;
  constexpr int NT = G::NT, BM = G::BM, BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + G::tileT_M);
  T* sV = reinterpret_cast<T*>(smem + G::tileT_M + G::tileT_N);
  float* sS = reinterpret_cast<float*>(smem + G::tileT_M + 2 * G::tileT_N);
  T* sP = reinterpret_cast<T*>(smem + G::tileT_M + 2 * G::tileT_N + G::tileS);
  float* sO = reinterpret_cast<float*>(smem + G::tileT_M + 2 * G::tileT_N + G::tileS + G::tileP);

  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (H / KVH);
  const int q0 = blockIdx.x * BM;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const float* bs = bias.slice(b, h, mk.sk);
  stage<T, D, LDT, BM, NT>(sQ, q, b, mk.sq, H, h, q0);
  zero(sO, BM * LDO, NT);
  __syncthreads();  // a warp's rows of sO are zeroed by every warp: a tile whose rows see no key reads them at once

  int kt_begin = 0, kt_end = (mk.sk + BN - 1) / BN;
  if (mk.causal) {
    const int last = mk.offset + min(q0 + BM, mk.sq) - 1;  // the last key any row of the tile sees
    kt_end = min(kt_end, last < 0 ? 0 : last / BN + 1);
    if (mk.window > 0) kt_begin = max(mk.offset + q0 - mk.window + 1, 0) / BN;
  }

  const int wr = 16 * warp;  // the warp's first row in the tile
  float* sSw = sS + wr * LDS;
  T* sPw = sP + wr * LDP;
  float* sOw = sO + wr * LDO;
  float m_i[16], l_i[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done; sQ and sO are written
    stage<T, D, LDT, BN, NT>(sK, k, b, mk.sk, KVH, hk, k0);
    stage<T, D, LDT, BN, NT>(sV, v, b, mk.sk, KVH, hk, k0);
    __syncthreads();
    warp_nt<BN, D>(sSw, LDS, sQ + wr * LDT, LDT, sK, LDT);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + wr + i;
      float s[BN / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        const float bv = HAS_BIAS ? bias_at(bs, bias.Sqb, row, k0 + c, mk) : 0.f;
        s[j] = masked_score<HAS_BIAS>(sSw[i * LDS + c], row, k0 + c, slope, bv, mk);
        mx = fmaxf(mx, s[j]);
      }
      const float mnew = fmaxf(m_i[i], warp_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const float p = s[j] <= kNegInf ? 0.f : expf(s[j] - mnew);
        ps += p;
        sPw[i * LDP + lane + 32 * j] = from_float<T>(p);
      }
      const float alpha = expf(m_i[i] - mnew);
      l_i[i] = l_i[i] * alpha + warp_sum(ps);
      m_i[i] = mnew;
      for (int c = lane; c < D; c += 32) sOw[i * LDO + c] *= alpha;
    }
    __syncwarp();
    warp_nn_acc<D, BN>(sOw, LDO, sPw, LDP, sV, LDT);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + wr + i;
    if (row < mk.sq) {
      const float l = l_i[i] == 0.f ? 1.f : l_i[i];
      T* orow = o + ((static_cast<size_t>(b) * mk.sq + row) * H + h) * D;
      for (int c = lane; c < D; c += 32) orow[c] = from_float<T>(sOw[i * LDO + c] / l);
      if (lane == 0) lse[(static_cast<size_t>(b) * H + h) * mk.sq + row] = m_i[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------- dq
// What a dq tile does with its dlogits = p * (dp - delta) (dbias: the bias
// enters the logits unscaled, _dq_kernel :243).
enum DbiasMode {
  kNoDbias = 0,   // no bias, so no dbias
  kDbiasRows = 1, // into rows [q0, q0 + BM) of a (Sq, Sk) fp32 region: dst points at row q0
  kDbiasCols = 2  // each warp's column sum over its 16 rows into its own (Sk,) fp32 row: dst + warp * wstride
};

// dq for query rows [q0, q0 + BM) of program (b, h): dq = sum_j (p * (dp -
// delta) * scale) k_j, with p = exp(s - lse) recomputed through masked_score.
// `first`: the dbias region is stored (and the key tiles the walk skips are
// zeroed), else added to. Starts with a block barrier, so a block may call it
// for one program after another.
template <typename T, int D, int MODE>
__device__ __forceinline__ void dq_tile(unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        const float* __restrict__ lse, const float* __restrict__ delta, float slope,
                                        const float* bs, int sqb, T* __restrict__ dq, float* dst, size_t wstride,
                                        bool first, int b, int h, int q0, int H, int KVH, const Mask& mk) {
  using G = Geo<T, D>;
  constexpr int NT = G::NT, BM = G::BM, BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO;
  size_t off = 0;
  T* sQ = reinterpret_cast<T*>(smem + off);
  off += G::tileT_M;
  T* sdO = reinterpret_cast<T*>(smem + off);
  off += G::tileT_M;
  T* sK = reinterpret_cast<T*>(smem + off);
  off += G::tileT_N;
  T* sV = reinterpret_cast<T*>(smem + off);
  off += G::tileT_N;
  float* sS = reinterpret_cast<float*>(smem + off);
  off += G::tileS;
  float* sdP = reinterpret_cast<float*>(smem + off);
  off += G::tileS;
  T* sdS = reinterpret_cast<T*>(smem + off);
  off += G::tileP;
  float* sdQ = reinterpret_cast<float*>(smem + off);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (H / KVH);
  __syncthreads();  // the previous tile's readers of the shared buffers are done
  stage<T, D, LDT, BM, NT>(sQ, q, b, mk.sq, H, h, q0);
  stage<T, D, LDT, BM, NT>(sdO, dout, b, mk.sq, H, h, q0);
  zero(sdQ, BM * LDO, NT);
  __syncthreads();  // as the forward's sO: a tile whose rows see no key reads its zeros at once

  int kt_begin = 0, kt_end = (mk.sk + BN - 1) / BN;
  if (mk.causal) {
    const int last = mk.offset + min(q0 + BM, mk.sq) - 1;
    kt_end = min(kt_end, last < 0 ? 0 : last / BN + 1);
    if (mk.window > 0) kt_begin = max(mk.offset + q0 - mk.window + 1, 0) / BN;
  }

  const int wr = 16 * warp;
  float* sSw = sS + wr * LDS;
  float* sdPw = sdP + wr * LDS;
  T* sdSw = sdS + wr * LDP;
  float* sdQw = sdQ + wr * LDO;
  float* dcol = MODE == kDbiasCols ? dst + warp * wstride : nullptr;  // this warp's dbias row
  float lse_i[16], delta_i[16];
  const size_t rowbase = (static_cast<size_t>(b) * H + h) * mk.sq;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + wr + i;
    lse_i[i] = row < mk.sq ? lse[rowbase + row] : 0.f;
    delta_i[i] = row < mk.sq ? delta[rowbase + row] : 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    stage<T, D, LDT, BN, NT>(sK, k, b, mk.sk, KVH, hk, k0);
    stage<T, D, LDT, BN, NT>(sV, v, b, mk.sk, KVH, hk, k0);
    __syncthreads();
    warp_nt<BN, D>(sSw, LDS, sQ + wr * LDT, LDT, sK, LDT);
    warp_nt<BN, D>(sdPw, LDS, sdO + wr * LDT, LDT, sV, LDT);
    __syncwarp();
    float colsum[BN / 32];
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) colsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + wr + i;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        const float bv = MODE != kNoDbias ? bias_at(bs, sqb, row, col, mk) : 0.f;
        const float s = masked_score<MODE != kNoDbias>(sSw[i * LDS + c], row, col, slope, bv, mk);
        const float p = s <= kNegInf ? 0.f : expf(s - lse_i[i]);
        const float dl = p * (sdPw[i * LDS + c] - delta_i[i]);
        sdSw[i * LDP + c] = from_float<T>(dl * mk.scale);
        if constexpr (MODE == kDbiasRows) {
          if (row < mk.sq && col < mk.sk) {
            float* d = dst + static_cast<size_t>(wr + i) * mk.sk + col;
            *d = first ? dl : *d + dl;
          }
        }
        if constexpr (MODE == kDbiasCols) colsum[j] += dl;
      }
    }
    if constexpr (MODE == kDbiasCols) {
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int col = k0 + lane + 32 * j;
        if (col < mk.sk) dcol[col] = first ? colsum[j] : dcol[col] + colsum[j];
      }
    }
    __syncwarp();
    warp_nn_acc<D, BN>(sdQw, LDO, sdSw, LDP, sK, LDT);
  }
  if (MODE != kNoDbias && first) {  // the key tiles the walk skips have zero dlogits
    const int lo = kt_begin * BN, hi = max(kt_end * BN, lo);
    for (int i = 0; i < (MODE == kDbiasRows ? 16 : 1); ++i) {
      if (MODE == kDbiasRows && q0 + wr + i >= mk.sq) break;
      float* d = MODE == kDbiasRows ? dst + static_cast<size_t>(wr + i) * mk.sk : dcol;
      for (int c = lane; c < mk.sk; c += 32)
        if (c < lo || c >= hi) d[c] = 0.f;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + wr + i;
    if (row < mk.sq) {
      T* drow = dq + ((static_cast<size_t>(b) * mk.sq + row) * H + h) * D;
      for (int c = lane; c < D; c += 32) drow[c] = from_float<T>(sdQw[i * LDO + c]);
    }
  }
}

// Grid (ceil(Sq / BM), H, B). With a bias that nothing collapses (MODE
// kDbiasRows), dbias (B*H, Sq, Sk) fp32 receives every program's dlogits;
// kNoDbias runs without a bias.
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ slopes, Bias bias, T* __restrict__ dq, float* __restrict__ dbias, int H,
                int KVH, Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * Geo<T, D>::BM;
  float* dst = MODE == kDbiasRows ? dbias + ((static_cast<size_t>(b) * H + h) * mk.sq + q0) * mk.sk : nullptr;
  dq_tile<T, D, MODE>(smem, q, k, v, dout, lse, delta, slopes != nullptr ? slopes[h] : 0.f, bias.slice(b, h, mk.sk),
                      bias.Sqb, dq, dst, 0, true, b, h, q0, H, KVH, mk);
}

// Collapsed dq (fp32; bf16 in flash_bwd.cu). Grid (ceil(Sq / BM), n_bh
// slices, n_chunks); n_rep = B*H / n_bh programs share each slice, and chunk c
// walks programs [c * per, min(n_rep, (c + 1) * per)) of it. Its partial: MODE kDbiasRows (Sqb == Sq)
// rows [q0, q0 + BM) of part[c] (n_chunks, n_bh, Sq, Sk); MODE kDbiasCols
// (Sqb == 1) one row per warp, part[(c * n_qt + qt) * NW + warp] of
// (n_parts, n_bh, 1, Sk).
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dq_collapsed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ slopes, Bias bias,
                          T* __restrict__ dq, float* __restrict__ part, int H, int KVH, int n_rep, int per, Mask mk) {
  using G = Geo<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, s = blockIdx.y, c = blockIdx.z, q0 = qt * G::BM;
  const int n_bh = gridDim.y;
  const float* bs = bias.p + static_cast<size_t>(s) * bias.Sqb * mk.sk;
  float* dst;
  size_t wstride = 0;
  if (MODE == kDbiasRows) {
    dst = part + ((static_cast<size_t>(c) * n_bh + s) * mk.sq + q0) * mk.sk;
  } else {
    dst = part + ((static_cast<size_t>(c) * gridDim.x + qt) * G::NW * n_bh + s) * mk.sk;
    wstride = static_cast<size_t>(n_bh) * mk.sk;
  }
  const int r0 = c * per, r1 = min(n_rep, r0 + per);
  for (int rep = r0; rep < r1; ++rep) {
    const int prog = sharing_program(bias, s, rep, H);
    const int b = prog / H, h = prog % H;
    dq_tile<T, D, MODE>(smem, q, k, v, dout, lse, delta, slopes != nullptr ? slopes[h] : 0.f, bs, bias.Sqb, dq, dst,
                        wstride, rep == r0, b, h, q0, H, KVH, mk);
  }
}

// dbias[i] = sum over p of part[p][i], p in order: the fixed-order sum of the partials.
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias, size_t n,
                                    int n_parts) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < n_parts; ++p) acc += part[static_cast<size_t>(p) * n + i];
    dbias[i] = acc;
  }
}

// ---------------------------------------------------------------- dk / dv
// Grid (ceil(Sk / BM), KVH, B). Block rows are keys; each block sums over the
// n_rep query heads of its KV head and over the query tiles that see its keys.
template <typename T, int D, bool HAS_BIAS>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ slopes, Bias bias, T* __restrict__ dk, T* __restrict__ dv, int H,
                 int KVH, Mask mk) {
  using G = Geo<T, D>;
  constexpr int NT = G::NT, BM = G::BM, BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* sK = reinterpret_cast<T*>(smem + off);
  off += G::tileT_M;
  T* sV = reinterpret_cast<T*>(smem + off);
  off += G::tileT_M;
  T* sQ = reinterpret_cast<T*>(smem + off);
  off += G::tileT_N;
  T* sdO = reinterpret_cast<T*>(smem + off);
  off += G::tileT_N;
  float* sLse = reinterpret_cast<float*>(smem + off);
  off += G::vecN;
  float* sDelta = reinterpret_cast<float*>(smem + off);
  off += G::vecN;
  float* sS = reinterpret_cast<float*>(smem + off);
  off += G::tileS;
  float* sdP = reinterpret_cast<float*>(smem + off);
  off += G::tileS;
  T* sPt = reinterpret_cast<T*>(smem + off);
  off += G::tileP;
  T* sdS = reinterpret_cast<T*>(smem + off);
  off += G::tileP;
  float* sdK = reinterpret_cast<float*>(smem + off);
  off += G::tileO;
  float* sdV = reinterpret_cast<float*>(smem + off);
  off += G::tileO;
  float* sB = reinterpret_cast<float*>(smem + off);  // HAS_BIAS: the bias tile, query rows x keys

  const int hk = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = H / KVH;
  const int k0 = blockIdx.x * BM;
  stage<T, D, LDT, BM, NT>(sK, k, b, mk.sk, KVH, hk, k0);
  stage<T, D, LDT, BM, NT>(sV, v, b, mk.sk, KVH, hk, k0);
  zero(sdK, BM * LDO, NT);
  zero(sdV, BM * LDO, NT);
  __syncthreads();  // as the forward's sO: keys that no query row sees read their zeros at once

  // query tiles whose rows can see a key of this tile
  const int nq = (mk.sq + BN - 1) / BN;
  int qt_begin = 0, qt_end = nq;
  if (mk.causal) {
    qt_begin = max(k0 - mk.offset, 0) / BN;  // row offset + r sees key c iff c <= offset + r
    if (mk.window > 0) {
      const int last_key = min(k0 + BM, mk.sk) - 1;
      const int last_row = last_key + mk.window - 1 - mk.offset;  // row <= key + window - 1 - offset
      qt_end = last_row < 0 ? 0 : min(last_row / BN + 1, nq);
    }
  }

  const int wr = 16 * warp;  // the warp's first key row in the tile
  float* sSw = sS + wr * LDS;
  float* sdPw = sdP + wr * LDS;
  T* sPtw = sPt + wr * LDP;
  T* sdSw = sdS + wr * LDP;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const float slope = slopes != nullptr ? slopes[h] : 0.f;
    const float* bs = bias.slice(b, h, mk.sk);
    const size_t rowbase = (static_cast<size_t>(b) * H + h) * mk.sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();
      stage<T, D, LDT, BN, NT>(sQ, q, b, mk.sq, H, h, q0);
      stage<T, D, LDT, BN, NT>(sdO, dout, b, mk.sq, H, h, q0);
      for (int c = threadIdx.x; c < BN; c += NT) {
        const int row = q0 + c;
        sLse[c] = row < mk.sq ? lse[rowbase + row] : 0.f;
        sDelta[c] = row < mk.sq ? delta[rowbase + row] : 0.f;
      }
      if (HAS_BIAS) {  // coalesced along the keys; read back along the query rows
        for (int e = threadIdx.x; e < BN * BM; e += NT) {
          const int r = e / BM, kk = e % BM;
          sB[r * G::LDB + kk] = bias_at(bs, bias.Sqb, q0 + r, k0 + kk, mk);
        }
      }
      __syncthreads();
      warp_nt<BN, D>(sSw, LDS, sK + wr * LDT, LDT, sQ, LDT);    // S^T = K Q^T
      warp_nt<BN, D>(sdPw, LDS, sV + wr * LDT, LDT, sdO, LDT);  // dP^T = V dO^T
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = k0 + wr + i;
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          const int c = lane + 32 * j;
          const float bv = HAS_BIAS ? sB[c * G::LDB + wr + i] : 0.f;
          const float s = masked_score<HAS_BIAS>(sSw[i * LDS + c], q0 + c, key, slope, bv, mk);
          const float p = s <= kNegInf ? 0.f : expf(s - sLse[c]);
          sPtw[i * LDP + c] = from_float<T>(p);
          sdSw[i * LDP + c] = from_float<T>(p * (sdPw[i * LDS + c] - sDelta[c]) * mk.scale);
        }
      }
      __syncwarp();
      warp_nn_acc<D, BN>(sdV + wr * LDO, LDO, sPtw, LDP, sdO, LDT);  // dV += P^T dO
      warp_nn_acc<D, BN>(sdK + wr * LDO, LDO, sdSw, LDP, sQ, LDT);   // dK += dS^T Q
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = k0 + wr + i;
    if (key < mk.sk) {
      const size_t base = ((static_cast<size_t>(b) * mk.sk + key) * KVH + hk) * D;
      for (int c = lane; c < D; c += 32) {
        dk[base + c] = from_float<T>(sdK[(wr + i) * LDO + c]);
        dv[base + c] = from_float<T>(sdV[(wr + i) * LDO + c]);
      }
    }
  }
}

// ---------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *slopes;
  void *o, *out_lse, *dq, *dk, *dv;
  float *dbias, *parts;
  Bias bias;
  int B, Sq, Sk, H, KVH;
  Mask mk;
  cudaStream_t stream;
};

enum Pass { kFwd = 0, kDq = 1, kDkv = 2, kDqCollapsed = 3 };

template <typename T>
int plan_collapsed(const Args& a, CollapsedPlan* pl) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                  cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  int rows, warps;
  if constexpr (sizeof(T) == 2) {
    flash_dq_collapsed_bf16_geometry(&rows, &warps);
  } else {
    warps = Tiles<T>::NW;
    rows = 16 * warps;
  }
  pl->n_qt = (a.Sq + rows - 1) / rows;
  pl->n_bh = a.bias.Bb * a.bias.Hb;
  pl->n_rep = a.B * a.H / pl->n_bh;
  // at most half the sharing programs a chunk: the partials (n_chunks slices of Sqb rows each) then stay
  // below the expanded (B*H, Sq, Sk) size
  const long long base = static_cast<long long>(pl->n_qt) * pl->n_bh;
  const int cap = std::max(1, pl->n_rep / 2);
  int want = 1;
  if constexpr (sizeof(T) == 2) {
    // flash_bwd.cu's body runs one block an SM: the chunk count whose grid finishes first, counted in waves
    // of `per` programs each (the fewest chunks among equals, which keeps the partials few)
    long long best = -1;
    for (int c = 1; c <= std::min(cap, 8 * sms); ++c) {
      const int per = (pl->n_rep + c - 1) / c, chunks = (pl->n_rep + per - 1) / per;
      const long long cost = (base * chunks + sms - 1) / sms * per;
      if (best < 0 || cost < best) {
        best = cost;
        want = c;
      }
    }
  } else {  // chunks enough for about two blocks per SM
    want = static_cast<int>(std::min<long long>(cap, std::max(1LL, (2LL * sms + base - 1) / base)));
  }
  pl->per = (pl->n_rep + want - 1) / want;
  pl->n_chunks = (pl->n_rep + pl->per - 1) / pl->per;
  pl->n_parts = pl->n_chunks * (a.bias.Sqb == 1 ? pl->n_qt * warps : 1);
  if (pl->n_bh > 65535 || pl->n_chunks > 65535) return kUnsupported;
  return 0;
}

template <typename T, int D, bool HAS_BIAS>
int launch_dkv(const Args& a) {
  using G = Geo<T, D>;
  auto kernel = flash_dkv_kernel<T, D, HAS_BIAS>;
  const size_t smem = G::dkv + (HAS_BIAS ? G::tileB : 0);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sk + G::BM - 1) / G::BM, a.KVH, a.B);
  kernel<<<grid, G::NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.slopes), a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KVH, a.mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(Pass pass, const Args& a) {
  using G = Geo<T, D>;
  const float* sl = static_cast<const float*>(a.slopes);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (pass == kFwd) {
    if constexpr (sizeof(T) == 2) {  // bf16: the register-resident body of flash_fwd.cu
      return flash_fwd_bf16(q, k, v, sl, a.bias, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.B, a.H,
                            a.KVH, D, a.mk, a.stream);
    } else {
      auto kernel = a.bias.p != nullptr ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
      if ((err = allow_smem(kernel, G::fwd)) != cudaSuccess) return static_cast<int>(err);
      dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
      kernel<<<grid, G::NT, G::fwd, a.stream>>>(q, k, v, sl, a.bias, static_cast<T*>(a.o),
                                                static_cast<float*>(a.out_lse), a.H, a.KVH, a.mk);
    }
  } else if (pass == kDq) {
    if constexpr (sizeof(T) == 2) {  // bf16, with or without a bias: the register-resident bodies of flash_bwd.cu
      return flash_dq_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), a.dbias, a.B, a.H, a.KVH,
                           D, a.mk, a.stream);
    } else {
      dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
      auto kernel = a.dbias != nullptr ? flash_dq_kernel<T, D, kDbiasRows> : flash_dq_kernel<T, D, kNoDbias>;
      if ((err = allow_smem(kernel, G::dq)) != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, G::NT, G::dq, a.stream>>>(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), a.dbias,
                                               a.H, a.KVH, a.mk);
    }
  } else if (pass == kDqCollapsed) {
    CollapsedPlan pl;
    int rc = plan_collapsed<T>(a, &pl);
    if (rc != 0) return rc;
    if ((pl.n_parts > 1) != (a.parts != nullptr)) return kUnsupported;
    float* part = pl.n_parts > 1 ? a.parts : a.dbias;
    if constexpr (sizeof(T) == 2) {  // bf16: the register-resident body of flash_bwd.cu
      rc = flash_dq_collapsed_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, D,
                                   a.mk, pl, a.stream);
      if (rc != 0) return rc;
    } else {
      dim3 grid(pl.n_qt, pl.n_bh, pl.n_chunks);
      if (a.bias.Sqb == 1) {
        if ((err = allow_smem(flash_dq_collapsed_kernel<T, D, kDbiasCols>, G::dq)) != cudaSuccess)
          return static_cast<int>(err);
        flash_dq_collapsed_kernel<T, D, kDbiasCols><<<grid, G::NT, G::dq, a.stream>>>(
            q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, pl.n_rep, pl.per, a.mk);
      } else {
        if ((err = allow_smem(flash_dq_collapsed_kernel<T, D, kDbiasRows>, G::dq)) != cudaSuccess)
          return static_cast<int>(err);
        flash_dq_collapsed_kernel<T, D, kDbiasRows><<<grid, G::NT, G::dq, a.stream>>>(
            q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, pl.n_rep, pl.per, a.mk);
      }
    }
    if (pl.n_parts > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      const size_t n = static_cast<size_t>(pl.n_bh) * a.bias.Sqb * a.Sk;
      const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
      dbias_reduce_kernel<<<blocks, 256, 0, a.stream>>>(a.parts, a.dbias, n, pl.n_parts);
    }
  } else if constexpr (sizeof(T) == 2) {  // bf16, with or without a bias: the register-resident body of flash_bwd.cu
    return flash_dkv_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B,
                          a.H, a.KVH, D, a.mk, a.stream);
  } else {
    return a.bias.p != nullptr ? launch_dkv<T, D, true>(a) : launch_dkv<T, D, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(Pass pass, int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(pass, a);
    case 64: return launch<T, 64>(pass, a);
    case 128: return launch<T, 128>(pass, a);
    default: return kUnsupported;
  }
}

bool bias_fits(const Args& a) {
  const Bias& b = a.bias;
  if (b.p == nullptr) return a.dbias == nullptr;
  return (b.Sqb == 1 || b.Sqb == a.Sq) && (b.Hb == 1 || b.Hb == a.H) && b.repeat >= 1 &&
         (b.Bb == 1 ? b.repeat == 1 : b.Bb * b.repeat == a.B);
}

int run(Pass pass, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.B > 65535 || a.H > 65535 || !bias_fits(a)) return kUnsupported;
  if (pass == kDqCollapsed && (a.bias.p == nullptr || a.dbias == nullptr)) return kUnsupported;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.o, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return kUnsupported;
  if (dtype == kBFloat16) return dispatch_d<bf16>(pass, D, a);
  if (dtype == kFloat32) return dispatch_d<float>(pass, D, a);
  return kUnsupported;
}

Args make_args(const void* q, const void* k, const void* v, const void* slopes, const void* bias, int Bb, int Hb,
               int Sqb, int repeat, int B, int Sq, int Sk, int H, int KVH, float scale, int causal, int window,
               void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.slopes = slopes;
  a.bias = Bias{static_cast<const float*>(bias), Bb, Hb, Sqb, repeat};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KVH = KVH;
  a.mk = Mask{Sq, Sk, Sk - Sq, causal, causal ? window : 0, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace
}  // namespace dstorch

// q (B, Sq, H, D); k, v (B, Sk, KVH, D); all of `dtype`, contiguous. slopes: (H,)
// fp32 ALiBi slopes or null. bias: fp32 (Bb*Hb, Sqb, Sk) or null (then Bb, Hb,
// Sqb, repeat are 1). o like q; lse (B, H, Sq) fp32. window 0 = none.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* slopes, const void* bias,
                            int Bb, int Hb, int Sqb, int repeat, void* o, void* lse, int B, int Sq, int Sk, int H,
                            int KVH, int D, float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.o = o;
  a.out_lse = lse;
  return run(kFwd, D, dtype, a);
}

// dout like q; lse, delta (B, H, Sq) fp32 (delta = rowsum(o * dout)). dq like q.
// dbias: given exactly when a bias is, which nothing may collapse (Bb*Hb ==
// B*H, Sqb == Sq): the (B*H, Sq, Sk) fp32 dlogits of every program.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, const void* slopes, const void* bias, int Bb, int Hb, int Sqb,
                               int repeat, void* dq, void* dbias, int B, int Sq, int Sk, int H, int KVH, int D,
                               float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  if ((dbias != nullptr) != (bias != nullptr) || (dbias != nullptr && (Bb * Hb != B * H || Sqb != Sq)))
    return kUnsupported;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias);
  return run(kDq, D, dtype, a);
}

// The number of fp32 partials of dbias, each (Bb*Hb, Sqb, Sk), that
// ds_flash_bwd_dq_collapsed needs in `parts` on the current device (1: none,
// parts is null); negative for a configuration it does not take.
extern "C" int ds_flash_dq_collapsed_parts(int B, int Sq, int H, int Bb, int Hb, int Sqb, int dtype) {
  using namespace dstorch;
  if (B <= 0 || Sq <= 0 || H <= 0 || Bb <= 0 || Hb <= 0 || (B * H) % (Bb * Hb) != 0) return kUnsupported;
  Args a{};
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.bias = Bias{nullptr, Bb, Hb, Sqb, 1};
  CollapsedPlan pl;
  int rc = dtype == kBFloat16 ? plan_collapsed<bf16>(a, &pl) : dtype == kFloat32 ? plan_collapsed<float>(a, &pl)
                                                                                 : kUnsupported;
  return rc != 0 ? (rc > 0 ? -rc : rc) : pl.n_parts;
}

// dq like q, and dbias (Bb*Hb, Sqb, Sk) fp32 summed over the B*H / (Bb*Hb)
// programs that share each bias slice (and over the query rows when Sqb == 1).
// parts: the scratch ds_flash_dq_collapsed_parts asks for.
extern "C" int ds_flash_bwd_dq_collapsed(const void* q, const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, const void* slopes, const void* bias,
                                         void* dq, void* dbias, void* parts, int B, int Sq, int Sk, int H, int KVH,
                                         int D, float scale, int causal, int window, int Bb, int Hb, int Sqb,
                                         int repeat, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias);
  a.parts = static_cast<float*>(parts);
  return run(kDqCollapsed, D, dtype, a);
}

// dk, dv like k: each summed over the H / KVH query heads of its KV head.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* slopes, const void* bias, int Bb, int Hb, int Sqb,
                                int repeat, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
                                float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, D, dtype, a);
}
