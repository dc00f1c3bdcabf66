// The float32 flash attention bodies (forward, dq and dk/dv, with or without
// an additive bias) and the pieces they share: plain fp32 FMA loops over
// shared-memory tiles. flash_attention.cu, whose source note gives the
// design, instantiates them at D 32, 64 and 128 and holds the collapsed dq,
// its plan and the entry points; flash_fp32_wide.cu instantiates the bodies
// without a bias at D 80, 96 and 256 (the Hugging Face families' heads). At
// D 256 dk/dv's shared memory is 213 KB (K, V, Q, dO and the fp32 dK, dV of
// 32 rows), within the 227 KB of one block.
#pragma once

#include "flash_common.cuh"

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

}  // namespace
}  // namespace dstorch
