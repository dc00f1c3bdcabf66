// Fused dequantize-matmul for Hopper: out (M, N) = x (M, K) @ dequant(codes), fp32 accumulation.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quantized_matmul.py::_qmm_kernel
// (reached through quantized_matmul_pallas). Codes are int8 (K, N), or packed
// int4 (K/2, N): within each K-group of g rows, byte row r holds code k = r in
// the low nibble and k = r + g/2 in the high nibble, and a nibble n decodes as
// (n ^ 8) - 8. Scales are fp32 (K/g, N), one per (K-group, output column). The
// weight never exists dequantised in device memory: a block streams its codes
// once and dequantises them on the way into shared memory.
//
// What bounds it: at the token counts of a decode step (M <= 64) the bytes of
// the codes; at a prefill chunk's M (hundreds to a thousand) the product. The
// design is one simple kernel for both ends. A block owns a 64 x 64 output
// tile and walks K in chunks; the next chunk's codes, scales and x values are
// fetched into registers with 16-byte loads while the current chunk multiplies
// (the TPU's BlockSpec pipeline, written out), then decoded into shared memory.
// One loaded byte of a packed weight feeds two rows of the tile (x columns g/2
// apart, under the same scale row). The TPU's limits do not apply here: the
// group loop runs at run time (any number of groups, any g), M is not padded,
// and odd shapes (N % 16, K % 8, unaligned pointers) take element-wise staging
// in the same kernel instead of another path.
//
// Arithmetic: bfloat16 x runs on the tensor cores (WMMA 16x16x16) and rounds
// codes * scale to bf16 on the way into shared memory, with fp32 accumulators;
// float32 x keeps fp32 throughout (FMA loops over an fp32 tile), as the TPU
// kernel does.
#include "common.cuh"

#include <mma.h>

namespace dstorch {
namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kVecN = BN / 16;  // 16-byte code vectors per tile row

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BK = 128;  // x columns per chunk
  static constexpr int PAD = 8;   // row padding (elements): 16-byte rows, staggered banks
};
template <>
struct Tile<float> {
  static constexpr int BK = 32;
  static constexpr int PAD = 4;
};

// Tile row t of the chunk whose first code row is r0: the code row it decodes
// from and the x column it multiplies. gq = code rows per group (g, or g/2 packed).
template <bool PACKED, int BK>
__device__ __forceinline__ void tile_row(int r0, int t, int gq, int& qrow, int& k) {
  if constexpr (PACKED) {
    const int hi = t / (BK / 2);
    qrow = r0 + t % (BK / 2);
    k = (qrow / gq) * (2 * gq) + qrow % gq + hi * gq;
  } else {
    qrow = r0 + t;
    k = qrow;
  }
}

__device__ __forceinline__ int decode(int byte, bool packed, bool hi) {
  if (!packed) return byte;
  const int n = hi ? (byte >> 4) & 15 : byte & 15;
  return (n ^ 8) - 8;
}

template <typename T, bool PACKED, bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scales,
           T* __restrict__ out, int M, int K, int N, int Kq, int gq) {
  constexpr int BK = Tile<T>::BK;
  constexpr int LDW = BN + Tile<T>::PAD;
  constexpr int LDX = BK + Tile<T>::PAD;
  constexpr int LDC = BN + 8;
  constexpr int QROWS = PACKED ? BK / 2 : BK;  // code rows per chunk
  constexpr int XE = 16 / sizeof(T);           // x elements per 16-byte vector
  constexpr int XVR = BK / XE;                 // x vectors per tile row
  constexpr int WV = QROWS * kVecN;            // code vectors per chunk
  constexpr int WVT = (WV + kThreads - 1) / kThreads;
  constexpr int XVT = BM * XVR / kThreads;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr size_t kTileBytes = (BK * LDW + BM * LDX) * sizeof(T);
  constexpr size_t kOutBytes = kBf16 ? BM * LDC * sizeof(float) : 0;
  __shared__ __align__(128) unsigned char smem[kTileBytes > kOutBytes ? kTileBytes : kOutBytes];
  T* sW = reinterpret_cast<T*>(smem);  // [BK][LDW] dequantised weights
  T* sX = sW + BK * LDW;               // [BM][LDX]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  uint4 wq[WVT], xr[XVT];
  float4 ws[WVT][4];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < WVT; ++i) {
      const int v = tid + i * kThreads;
      const int qrow = r0 + v / kVecN, n = n0 + (v % kVecN) * 16;
      const bool ok = v < WV && qrow < Kq && n < N;
      wq[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        wq[i] = __ldg(reinterpret_cast<const uint4*>(q + static_cast<size_t>(qrow) * N + n));
        const float4* sp = reinterpret_cast<const float4*>(scales + static_cast<size_t>(qrow / gq) * N + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[i][j] = __ldg(sp + j);
      }
    }
#pragma unroll
    for (int i = 0; i < XVT; ++i) {
      const int v = tid + i * kThreads;
      const int m = m0 + v / XVR;
      int qrow, k;
      tile_row<PACKED, BK>(r0, (v % XVR) * XE, gq, qrow, k);
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && qrow < Kq) xr[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < WVT; ++i) {
      const int v = tid + i * kThreads;
      if (v >= WV) continue;
      const int pr = v / kVecN, c = (v % kVecN) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&wq[i]);
      const float* s = reinterpret_cast<const float*>(&ws[i][0]);
      float lo[16], hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo[j] = static_cast<float>(decode(b[j], PACKED, false)) * s[j];
        if constexpr (PACKED) hi[j] = static_cast<float>(decode(b[j], true, true)) * s[j];
      }
      store_vec<16>(sW + pr * LDW + c, lo);
      if constexpr (PACKED) store_vec<16>(sW + (pr + QROWS) * LDW + c, hi);
    }
#pragma unroll
    for (int i = 0; i < XVT; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(sX + (v / XVR) * LDX + (v % XVR) * XE) = xr[i];
    }
  };
  // element-wise staging for shapes and pointers the 16-byte loads do not take
  auto stage_scalar = [&](int r0) {
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int t = i / BN, n = n0 + i % BN;
      int qrow, k;
      tile_row<PACKED, BK>(r0, t, gq, qrow, k);
      float w = 0.f;
      if (qrow < Kq && n < N) {
        const int code = decode(q[static_cast<size_t>(qrow) * N + n], PACKED, t >= BK / 2);
        w = static_cast<float>(code) * scales[static_cast<size_t>(qrow / gq) * N + n];
      }
      sW[t * LDW + i % BN] = from_float<T>(w);
    }
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = m0 + i / BK;
      int qrow, k;
      tile_row<PACKED, BK>(r0, i % BK, gq, qrow, k);
      sX[(i / BK) * LDX + i % BK] = (m < M && qrow < Kq) ? x[static_cast<size_t>(m) * K + k] : from_float<T>(0.f);
    }
  };

  // bf16: warp (wm, wn) owns rows 16 wm.., columns 32 wn.. of the tile (two fragments)
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag[2];
  // fp32: thread (ty, tx) owns rows 4 ty + i, columns tx + 16 j
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
  if constexpr (kBf16) {
    wmma::fill_fragment(frag[0], 0.f);
    wmma::fill_fragment(frag[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if constexpr (VEC) fetch(0);
  for (int r0 = 0; r0 < Kq; r0 += QROWS) {
    if constexpr (VEC) {
      store();
    } else {
      stage_scalar(r0);
    }
    __syncthreads();
    if constexpr (VEC) {
      if (r0 + QROWS < Kq) fetch(r0 + QROWS);
    }
    if constexpr (kBf16) {
      const __nv_bfloat16* sXb = reinterpret_cast<const __nv_bfloat16*>(sX);
      const __nv_bfloat16* sWb = reinterpret_cast<const __nv_bfloat16*>(sW);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sXb + wm * 16 * LDX + kk, LDX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(b, sWb + kk * LDW + wn * 32 + 16 * j, LDW);
          wmma::mma_sync(frag[j], a, b, frag[j]);
        }
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = to_float(sX[(ty * 4 + i) * LDX + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = to_float(sW[kk * LDW + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (kBf16) {
    // the tiles are done with (barrier above): the fragments leave through shared memory
    float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + wm * 16 * LDC + wn * 32 + 16 * j, frag[j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int m = m0 + i / BN, n = n0 + i % BN;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = from_float<T>(sC[(i / BN) * LDC + i % BN]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = from_float<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, bool PACKED>
int launch(const void* x, const void* q, const void* scales, void* out, int M, int K, int N, int n_groups,
           cudaStream_t stream) {
  constexpr int XE = 16 / sizeof(T);
  const int Kq = PACKED ? K / 2 : K;
  const int gq = Kq / n_groups;
  const bool vec = N % 16 == 0 && K % XE == 0 && (!PACKED || gq % XE == 0) && aligned16(x) && aligned16(q) &&
                   aligned16(scales);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  if (vec) {
    qmm_kernel<T, PACKED, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N, Kq, gq);
  } else {
    qmm_kernel<T, PACKED, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N, Kq, gq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch

// x (M, K) and out (M, N) contiguous of `dtype`; q int8 (K, N), or (K/2, N) when packed; scales fp32
// (n_groups, N) with n_groups dividing K (and K / n_groups even when packed). Returns 0 or an error code.
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scales, void* out, int M, int K, int N,
                                   int n_groups, int packed, int dtype, void* stream) {
  using namespace dstorch;
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || n_groups <= 0 || K % n_groups || (packed && (K / n_groups) % 2) || (M + BM - 1) / BM > 65535)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && packed) return launch<__nv_bfloat16, true>(x, q, scales, out, M, K, N, n_groups, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16, false>(x, q, scales, out, M, K, N, n_groups, s);
  if (dtype == kFloat32 && packed) return launch<float, true>(x, q, scales, out, M, K, N, n_groups, s);
  if (dtype == kFloat32) return launch<float, false>(x, q, scales, out, M, K, N, n_groups, s);
  return kUnsupported;
}
