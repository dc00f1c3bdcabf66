// Flash attention for Hopper: forward, dq and dk/dv over (B, S, H, D) tensors.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (pallas_call at :185, via _flash_fwd), _dq_kernel (:417, via
// _flash_bwd) and _dkv_kernel_gqa (:518, via _flash_bwd). The masked score is
// the reference's _scores: s = (q.k) * scale + slope * key_pos, masked to
// kNegInf outside the causal (and sliding-window) band, with queries aligned
// to the END of the keys (offset = Sk - Sq). masked_score below is the one
// definition all three kernels use.
//
// What bounds it: at the training shapes (S 1024, D 64, causal) the forward
// does 2 products of S*S/2*D per head, 4*S^2/2*D flops, against reading q, k, v
// and writing o once, so it sits near the knee of the bf16 roofline (both
// bounds are about 0.04 ms at B 8, H 32); dq and dk/dv do 3 and 4 products.
// The design keeps the S x S scores out of device memory, as the TPU kernel
// did, and puts the products on the tensor cores:
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
// - bf16 products run on the tensor cores through warp-level WMMA 16x16x16
//   tiles with fp32 accumulation; fp32 inputs take plain FMA loops (the same
//   arithmetic in fp32 as the reference). Accumulators live in shared memory
//   in fp32, which lets each lane rescale its rows by the online-softmax
//   correction without knowing the fragment layout.
// - Any Sq and Sk: rows past the end are zero-filled in shared memory and
//   masked, so a zero weight never meets NaN; no divisibility is required.
// - lse and delta are (B, H, Sq) fp32, without the TPU's 128-lane padding.
// Not yet: wgmma, TMA, double-buffered tiles, or splitting the key walk.
#include "common.cuh"

#include <mma.h>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

// Block tiles per element type: NW warps of 16 rows each, BN columns per inner
// tile. fp32 tiles are smaller so that dk/dv's fp32 operands fit shared memory.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int NW = 4, BN = 64;
};
template <>
struct Tiles<float> {
  static constexpr int NW = 2, BN = 32;
};

struct Mask {
  int sq, sk, offset;  // offset = sk - sq: query row r sits at key position offset + r
  int causal, window;  // window > 0 only with causal: row r sees keys (r - window, r]
  float scale;
};

// THE masked score (the reference's _scores): raw q.k of query row `row` and
// key `col` -> fp32 score, or kNegInf where the pair is masked or out of range.
__device__ __forceinline__ float masked_score(float qk, int row, int col, float slope, const Mask& m) {
  if (row >= m.sq || col >= m.sk) return kNegInf;
  if (m.causal) {
    const int r = m.offset + row;
    if (col > r || (m.window > 0 && col <= r - m.window)) return kNegInf;
  }
  return qk * m.scale + slope * static_cast<float>(col);
}

// ---------------------------------------------------------------- warp products
// C[16 x N] = A[16 x K] . B[N x K]^T; A, B row-major in shared memory, C fp32.
template <int N, int K>
__device__ __forceinline__ void warp_nt(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
  for (int n = 0; n < N; n += 16) {
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::load_matrix_sync(a, A + k, lda);
      wmma::load_matrix_sync(b, B + n * ldb + k, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + n, c, ldc, wmma::mem_row_major);
  }
}

// C[16 x N] += A[16 x K] . B[K x N]; A, B row-major in shared memory, C fp32.
template <int N, int K>
__device__ __forceinline__ void warp_nn_acc(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
  for (int n = 0; n < N; n += 16) {
    wmma::load_matrix_sync(c, C + n, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::load_matrix_sync(a, A + k, lda);
      wmma::load_matrix_sync(b, B + k * ldb + n, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + n, c, ldc, wmma::mem_row_major);
  }
}

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

// Shared-memory layout sizes, each rounded up to 128 bytes so every buffer (and
// every 16-row tile in it) keeps the 32-byte alignment WMMA needs.
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
};

// ---------------------------------------------------------------- forward
// Grid (ceil(Sq / BM), H, B). o (B, Sq, H, D) in T; lse (B, H, Sq) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ slopes, T* __restrict__ o, float* __restrict__ lse, int H, int KVH,
                 Mask mk) {
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
  stage<T, D, LDT, BM, NT>(sQ, q, b, mk.sq, H, h, q0);
  zero(sO, BM * LDO, NT);

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
        s[j] = masked_score(sSw[i * LDS + c], row, k0 + c, slope, mk);
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
// Grid (ceil(Sq / BM), H, B). dq = sum_j (p * (dp - delta) * scale) k_j, with
// p = exp(s - lse) recomputed through masked_score.
template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ slopes, T* __restrict__ dq, int H, int KVH, Mask mk) {
  using G = Geo<T, D>;
  constexpr int NT = G::NT, BM = G::BM, BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
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

  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (H / KVH);
  const int q0 = blockIdx.x * BM;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  stage<T, D, LDT, BM, NT>(sQ, q, b, mk.sq, H, h, q0);
  stage<T, D, LDT, BM, NT>(sdO, dout, b, mk.sq, H, h, q0);
  zero(sdQ, BM * LDO, NT);

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
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + wr + i;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        const float s = masked_score(sSw[i * LDS + c], row, k0 + c, slope, mk);
        const float p = s <= kNegInf ? 0.f : expf(s - lse_i[i]);
        sdSw[i * LDP + c] = from_float<T>(p * (sdPw[i * LDS + c] - delta_i[i]) * mk.scale);
      }
    }
    __syncwarp();
    warp_nn_acc<D, BN>(sdQw, LDO, sdSw, LDP, sK, LDT);
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

// ---------------------------------------------------------------- dk / dv
// Grid (ceil(Sk / BM), KVH, B). Block rows are keys; each block sums over the
// n_rep query heads of its KV head and over the query tiles that see its keys.
template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ slopes, T* __restrict__ dk, T* __restrict__ dv, int H, int KVH,
                 Mask mk) {
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

  const int hk = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = H / KVH;
  const int k0 = blockIdx.x * BM;
  stage<T, D, LDT, BM, NT>(sK, k, b, mk.sk, KVH, hk, k0);
  stage<T, D, LDT, BM, NT>(sV, v, b, mk.sk, KVH, hk, k0);
  zero(sdK, BM * LDO, NT);
  zero(sdV, BM * LDO, NT);

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
          const float s = masked_score(sSw[i * LDS + c], q0 + c, key, slope, mk);
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
  int B, Sq, Sk, H, KVH;
  Mask mk;
  cudaStream_t stream;
};

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Pass pass, const Args& a) {
  using G = Geo<T, D>;
  const float* sl = static_cast<const float*>(a.slopes);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (pass == kFwd) {
    if ((err = allow_smem(flash_fwd_kernel<T, D>, G::fwd)) != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
    flash_fwd_kernel<T, D><<<grid, G::NT, G::fwd, a.stream>>>(q, k, v, sl, static_cast<T*>(a.o),
                                                               static_cast<float*>(a.out_lse), a.H, a.KVH, a.mk);
  } else if (pass == kDq) {
    if ((err = allow_smem(flash_dq_kernel<T, D>, G::dq)) != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
    flash_dq_kernel<T, D><<<grid, G::NT, G::dq, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), sl, static_cast<T*>(a.dq), a.H, a.KVH, a.mk);
  } else {
    if ((err = allow_smem(flash_dkv_kernel<T, D>, G::dkv)) != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.Sk + G::BM - 1) / G::BM, a.KVH, a.B);
    flash_dkv_kernel<T, D><<<grid, G::NT, G::dkv, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), sl, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KVH, a.mk);
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

int run(Pass pass, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.B > 65535 || a.H > 65535) return kUnsupported;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.o, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return kUnsupported;
  if (dtype == kBFloat16) return dispatch_d<bf16>(pass, D, a);
  if (dtype == kFloat32) return dispatch_d<float>(pass, D, a);
  return kUnsupported;
}

Args make_args(const void* q, const void* k, const void* v, const void* slopes, int B, int Sq, int Sk, int H,
               int KVH, float scale, int causal, int window, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.slopes = slopes;
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
// fp32 ALiBi slopes or null. o like q; lse (B, H, Sq) fp32. window 0 = none.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* slopes, void* o, void* lse,
                            int B, int Sq, int Sk, int H, int KVH, int D, float scale, int causal, int window,
                            int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.o = o;
  a.out_lse = lse;
  return run(kFwd, D, dtype, a);
}

// dout like q; lse, delta (B, H, Sq) fp32 (delta = rowsum(o * dout)). dq like q.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, const void* slopes, void* dq, int B, int Sq, int Sk, int H,
                               int KVH, int D, float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  return run(kDq, D, dtype, a);
}

// dk, dv like k: each summed over the H / KVH query heads of its KV head.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* slopes, void* dk, void* dv, int B, int Sq, int Sk,
                                int H, int KVH, int D, float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, D, dtype, a);
}
