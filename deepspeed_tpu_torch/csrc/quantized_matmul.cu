// Fused dequantize-matmul for Hopper: out (M, N) = x (M, K) @ dequant(codes), fp32 accumulation.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quantized_matmul.py::_qmm_kernel
// (reached through quantized_matmul_pallas). Codes are int8 (K, N), or packed
// int4 (K/2, N): within each K-group of g rows, byte row r holds code k = r in
// the low nibble and k = r + g/2 in the high nibble, and a nibble n decodes as
// (n ^ 8) - 8. Scales are fp32 (K/g, N), one per (K-group, output column). The
// weight never exists dequantised in device memory, nor in shared memory:
// each warp converts the codes of its own output columns once, in registers,
// straight into tensor-core operands.
//
// What bounds it. At a decode step's M (<= 64) the codes' bytes: the kernel
// reads half (int8) or a quarter (int4) of a bf16 weight's bytes, so it can
// beat a dense product only if it keeps the memory busy, and a launch of a few
// microseconds is mostly latency: the first bytes' round trip, the reduce of a
// split K. At a prefill chunk's M (512-1024) the product: 2 M K N operations.
//
// The bf16 bodies; the host's plan (ops/quantized_matmul.py::_qmm_plan) picks
// the tile and the split of K:
// - A ring of stages in shared memory, each 64 k-rows of x (BM x 64 bf16)
//   and the matching codes (64 int8 rows, or 32 packed rows, of the tile's
//   columns), filled by cp.async (zero-fill at the ragged edges) several
//   chunks ahead; one block barrier a chunk.
// - Codes to bf16 without a cvt or a multiply: an ldmatrix.trans of the byte
//   tile (16-bit units, so pairs of columns) hands a lane the codes of k rows
//   2t, 2t + 1 (and + 8) in columns 2g and 2g + 1 of a 16-column group: the
//   operand fragments of two n8 tiles whose column j is physical column 2j or
//   2j + 1. int8: __byte_perm of code + 128 into the float 2^23 + code + 128,
//   one subtract, the upper half is the exact bf16. int4: the nibble under
//   the bf16 exponent of 128 (0x43), one bf16x2 subtract of 136 for two codes.
// - M <= 64 (qmm_bf16_kernel): 16 x 128 or 64 x 128 tiles, 8 warps side by
//   side along N, mma.sync m16n8k16 with the codes as B. Split K: the grid's
//   third dimension cuts K into slices of whole groups until the grid is about
//   two blocks per SM (the tiles alone are 16-224 blocks for 132 SMs). Each
//   slice writes its fp32 partial tile to a workspace; the last slice of a
//   tile to finish (a per-tile counter, incremented after a fence, which that
//   block resets to 0 for the next launch) sums the partials in slice order
//   and writes the bf16 tile. No atomics touch the output: results repeat bit
//   for bit from run to run.
// - Larger M (qmm_wgmma_kernel): a 128 x 128 tile, two warpgroups each
//   computing out^T = W^T x^T for its 64 columns on wgmma m64n128k16, with
//   the converted codes as the register operand A (double-buffered, so one
//   chunk converts while the previous chunk's products run) and the x stage,
//   in wgmma's 128-byte swizzle, as the shared-memory operand B.
// - Arithmetic. Where a k16 step never crosses a group (g % 16 == 0; packed
//   g % 32 == 0), the tensor cores take the raw codes (exact in bf16) and each
//   group's fp32 partial is multiplied by its column's scale in registers
//   (RAW): closer to the fp32 reference than rounding code * scale to bf16.
//   Elsewhere (g = 75, g = 100, small packed groups) each code is multiplied
//   by its own scale and rounded to bf16 before the product, as the first
//   version did.
// - Packed int4: tile rows come in pairs of 16: the low nibbles of 16 code
//   rows, then their high nibbles; x's columns are gathered to match (8
//   consecutive columns per 16-byte copy, inside one group).
// - Odd shapes (N % 16, K % 8, packed groups of g/2 % 8, unaligned pointers)
//   take element-wise staging into the same ring (a run-time flag), not
//   another kernel.
// Not yet: TMA and warp specialisation (a producer warp for the ring, the
// conversion apart from the wgmma warpgroups), a persistent grid, tiles wide
// enough that x is not re-read from L2 by every column tile; a split K whose
// reduce is spread over the slices (a cluster's distributed shared memory).
//
// The float32 body (qmm_fp32_kernel) is the parity route and is on no
// serving path: a 64 x 64 tile, codes * scale in fp32, FMA loops over an fp32
// tile, as the TPU kernel does.
#include "common.cuh"
#include "mma.cuh"

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- float32 body
constexpr int kThreads = 256;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kVecN = BN / 16;  // 16-byte code vectors per tile row
constexpr int kBKf = 32;        // x columns per chunk
constexpr int kPADf = 4;        // row padding (elements)

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

template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_fp32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scales,
                float* __restrict__ out, int M, int K, int N, int Kq, int gq) {
  constexpr int BK = kBKf;
  constexpr int LDW = BN + kPADf;
  constexpr int LDX = BK + kPADf;
  constexpr int QROWS = PACKED ? BK / 2 : BK;  // code rows per chunk
  constexpr int XE = 4;                        // x elements per 16-byte vector
  constexpr int XVR = BK / XE;                 // x vectors per tile row
  constexpr int WV = QROWS * kVecN;            // code vectors per chunk
  constexpr int WVT = (WV + kThreads - 1) / kThreads;
  constexpr int XVT = BM * XVR / kThreads;
  __shared__ __align__(128) float sW[BK * LDW];  // dequantised weights
  __shared__ __align__(128) float sX[BM * LDX];

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
      sW[t * LDW + i % BN] = w;
    }
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = m0 + i / BK;
      int qrow, k;
      tile_row<PACKED, BK>(r0, i % BK, gq, qrow, k);
      sX[(i / BK) * LDX + i % BK] = (m < M && qrow < Kq) ? x[static_cast<size_t>(m) * K + k] : 0.f;
    }
  };

  // thread (ty, tx) owns rows 4 ty + i, columns tx + 16 j
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[(ty * 4 + i) * LDX + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sW[kk * LDW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <bool PACKED>
int launch_fp32(const void* x, const void* q, const void* scales, void* out, int M, int K, int N, int n_groups,
                cudaStream_t stream) {
  const int Kq = PACKED ? K / 2 : K;
  const int gq = Kq / n_groups;
  const bool vec = N % 16 == 0 && K % 4 == 0 && (!PACKED || gq % 4 == 0) && aligned16(x) && aligned16(q) &&
                   aligned16(scales);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (vec) {
    qmm_fp32_kernel<PACKED, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N, Kq, gq);
  } else {
    qmm_fp32_kernel<PACKED, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N, Kq, gq);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bfloat16 body
// The plan's tile configurations (ops/quantized_matmul.py QMM_TILES): block tile
// BM x BN, WN warps side by side along N. 0 and 1 run qmm_bf16_kernel
// (mma.sync), 2 runs qmm_wgmma_kernel (two warpgroups, one 64-column half of
// the tile each).
template <int CFG>
struct QCfg;
// STAGES: the cp.async ring's depth (deep at small M, where the codes stream and
// little else holds a block up; two blocks of configurations 0 and 1 fit an SM).
template <>
struct QCfg<0> {
  static constexpr int BM = 16, BN = 128, WN = 8, STAGES = 5;
};
template <>
struct QCfg<1> {
  static constexpr int BM = 64, BN = 128, WN = 8, STAGES = 4;
};
template <>
struct QCfg<2> {
  static constexpr int BM = 128, BN = 128, WN = 8, STAGES = 6;
};
constexpr int kBK = 64;  // tile k-rows (x columns) per stage

template <int CFG, bool PACKED>
struct QGeo {
  using C = QCfg<CFG>;
  static constexpr bool CORE = CFG == 2;  // x in wgmma's 128-byte swizzle, else padded rows for ldmatrix
  static constexpr int NTH = 32 * C::WN;
  static constexpr int QROWS = PACKED ? kBK / 2 : kBK;  // code rows per stage
  static constexpr int LDX = CORE ? kBK : kBK + 8;      // +16 bytes: ldmatrix rows on distinct banks
  static constexpr int LDQ = C::BN + 16;  // code rows: +16 bytes, ldmatrix rows on distinct banks
  static constexpr int X_BYTES = C::BM * LDX * 2, Q_BYTES = QROWS * LDQ;
  static constexpr int STAGE = CORE ? (X_BYTES + Q_BYTES + 1023) / 1024 * 1024 : X_BYTES + Q_BYTES;  // atoms aligned
  static constexpr int STAGES = C::STAGES;
  static constexpr size_t smem = static_cast<size_t>(STAGES) * STAGE + (CORE ? 1024 : 0);  // + alignment slack
};

// Tile row t (0..kBK) of the stage whose first code row is r0 -> its code row and x column.
template <bool PACKED>
__device__ __forceinline__ void tile_k(int r0, int t, int gq, int& qrow, int& k) {
  if constexpr (PACKED) {
    const int j = t >> 4;  // pairs of 16: low nibbles of 16 code rows, then their high nibbles
    qrow = r0 + (j >> 1) * 16 + (t & 15);
    k = (qrow / gq) * (2 * gq) + qrow % gq + (j & 1) * gq;
  } else {
    qrow = r0 + t;
    k = qrow;
  }
}

// Element (row mr, column t) of a stage's x tile: padded rows, or 128-byte
// rows whose 16-byte unit t / 8 sits at unit (t / 8) ^ (mr % 8) (wgmma's swizzle).
template <bool CORE, int LDX>
__device__ __forceinline__ int x_at(int mr, int t) {
  if constexpr (CORE) return mr * kBK + ((((t >> 3) ^ mr) & 7) << 3) + (t & 7);
  return mr * LDX + t;
}

// Chunk (first code row r0) -> a stage: QROWS x BN code bytes, BM x kBK x values.
template <bool PACKED, int BMq, int BNq, int QROWS, int NTH, bool CORE, int LDX, int LDQ>
__device__ __forceinline__ void stage_chunk(int8_t* dq, bf16* dx, const bf16* __restrict__ x,
                                            const int8_t* __restrict__ q, int r0, int qe, int m0, int n0, int M,
                                            int K, int N, int gq, int vec) {
  const int tid = threadIdx.x;
  for (int i = tid; i < QROWS * BNq / 16; i += NTH) {
    const int pr = i / (BNq / 16), c16 = (i % (BNq / 16)) * 16;
    const int qrow = r0 + pr, n = n0 + c16;
    int8_t* dst = dq + pr * LDQ + c16;
    if (vec) {
      const bool ok = qrow < qe && n < N;
      cp_async16(dst, ok ? q + static_cast<size_t>(qrow) * N + n : q, ok ? 16 : 0);
    } else {
#pragma unroll 4
      for (int j = 0; j < 16; ++j)
        dst[j] = (qrow < qe && n + j < N) ? q[static_cast<size_t>(qrow) * N + n + j] : static_cast<int8_t>(0);
    }
  }
  for (int i = tid; i < BMq * kBK / 8; i += NTH) {
    const int mr = i / (kBK / 8), t = (i % (kBK / 8)) * 8, m = m0 + mr;
    bf16* dst = dx + x_at<CORE, LDX>(mr, t);
    if (vec) {
      int qrow, k;
      tile_k<PACKED>(r0, t, gq, qrow, k);
      const bool ok = m < M && qrow < qe;
      cp_async16(dst, ok ? x + static_cast<size_t>(m) * K + k : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int qrow, k;
        tile_k<PACKED>(r0, t + j, gq, qrow, k);
        dst[j] = (m < M && qrow < qe) ? x[static_cast<size_t>(m) * K + k] : __float2bfloat16(0.f);
      }
    }
  }
}

// Split K: after this split's partial tile is in ws (and fenced), the last
// split of the tile to arrive sums all partials in split order into out and
// re-zeroes the tile's counter. Every thread of the block calls it.
template <int BMq, int BNq, int NTH>
__device__ __forceinline__ void split_finish(const float* ws, int* counters, bf16* __restrict__ out, int M, int N,
                                             int m0, int n0, int vec, int* is_last) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int prev = atomicAdd(counters + tile, 1);
    *is_last = prev == static_cast<int>(gridDim.z) - 1;
    if (*is_last) counters[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  const int splits = static_cast<int>(gridDim.z);
  const size_t plane = static_cast<size_t>(M) * N;
  if (vec) {
    // each thread's V vectors of the tile, VG at a time with U splits a round: 16 loads in flight, added in
    // split order
    constexpr int V = (BMq * BNq / 4 + NTH - 1) / NTH, VG = V < 4 ? V : 4, U = 16 / VG;
#pragma unroll 1
    for (int v0 = 0; v0 < V; v0 += VG) {
      float4 sum[VG];
      size_t off[VG];
      bool ok[VG];
#pragma unroll
      for (int v = 0; v < VG; ++v) {
        const int i = tid + (v0 + v) * NTH;
        const int m = m0 + i / (BNq / 4), n = n0 + (i % (BNq / 4)) * 4;
        ok[v] = i < BMq * BNq / 4 && m < M && n < N;
        off[v] = static_cast<size_t>(m) * N + n;
        sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int z = 0; z < splits; z += U) {
        float4 p[U][VG];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < VG; ++v)
            p[u][v] = ok[v] && z + u < splits
                          ? __ldcg(reinterpret_cast<const float4*>(ws + off[v] + (z + u) * plane))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < VG; ++v) {
            sum[v].x += p[u][v].x;
            sum[v].y += p[u][v].y;
            sum[v].z += p[u][v].z;
            sum[v].w += p[u][v].w;
          }
      }
#pragma unroll
      for (int v = 0; v < VG; ++v) {
        if (!ok[v]) continue;
        uint2 o;
        o.x = pack_bf16(sum[v].x, sum[v].y);
        o.y = pack_bf16(sum[v].z, sum[v].w);
        *reinterpret_cast<uint2*>(out + off[v]) = o;
      }
    }
  } else {
    for (int i = tid; i < BMq * BNq; i += NTH) {
      const int m = m0 + i / BNq, n = n0 + i % BNq;
      if (m >= M || n >= N) continue;
      const float* src = ws + static_cast<size_t>(m) * N + n;
      float sum = __ldcg(src);
      for (int z = 1; z < splits; ++z) sum += __ldcg(src + z * plane);
      out[static_cast<size_t>(m) * N + n] = __float2bfloat16(sum);
    }
  }
}

// Code bytes J0 and J1 of rx (int8 codes + 128, i.e. r ^ 0x80808080) -> bf16x2, exact, J0 in the low half:
// 0x4B0000xx is 2^23 + xx, one subtract, then the float's upper half is the bf16.
template <int J0, int J1>
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t rx) {
  const float f0 = __uint_as_float(__byte_perm(rx, 0x4B000000u, 0x7540 | J0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(rx, 0x4B000000u, 0x7540 | J1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The nibbles at bits SHIFT and SHIFT + 16 of rn (packed bytes ^ 0x88, so a nibble is code + 8) -> bf16x2,
// exact: 0x4300 | n is the bf16 128 + n, minus 136. SHIFT 0 / 4: bytes 0 and 2, low / high nibbles; 8 / 12:
// bytes 1 and 3.
template <int SHIFT>
__device__ __forceinline__ uint32_t i4x2_bf16(uint32_t rn) {
  const uint32_t v = ((rn >> SHIFT) & 0x000F000Fu) | 0x43004300u;
  const uint32_t magic = 0x43084308u;  // 136, 136
  const __nv_bfloat162 h =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The code in byte j (nibble `hi` when packed) of r, for the path that scales codes before the product.
template <bool PACKED>
__device__ __forceinline__ float code_of(uint32_t r, int j, int hi) {
  const int byte = static_cast<int8_t>((r >> (8 * j)) & 0xFF);
  if constexpr (PACKED) return static_cast<float>((((byte >> (4 * hi)) & 15) ^ 8) - 8);
  return static_cast<float>(byte);
}

// Grid (ceil(N / BN), ceil(M / BM), splits); split z owns code rows
// [z * rows_per_split, min(Kq, (z + 1) * rows_per_split)), whole groups.
// Small M: mma.sync warps side by side along N, each converting only its own
// columns' codes, straight from the stage's bytes into B fragments. An
// ldmatrix.trans of the int8 tile (16-bit units: pairs of columns) gives lane
// (g, t) the codes of k rows 2t, 2t + 1 (and + 8) in physical columns 2g and
// 2g + 1 of a 16-column group: the B fragments of two n8 tiles whose logical
// column j is physical column 2j (tile E) or 2j + 1 (tile O). So a lane's
// outputs are physical columns 4t .. 4t + 3 of each group.
template <int CFG, bool PACKED, bool RAW>
__global__ void __launch_bounds__(QGeo<CFG, PACKED>::NTH)
qmm_bf16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scales,
                bf16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N,
                int Kq, int gq, int rows_per_split, int vec) {
  using C = QCfg<CFG>;
  using G = QGeo<CFG, PACKED>;
  constexpr int BMq = C::BM, BNq = C::BN, NTH = G::NTH, QROWS = G::QROWS, LDX = G::LDX, LDQ = G::LDQ;
  constexpr int S = G::STAGES, MT = BMq / 16, WTN = BNq / C::WN, CG = WTN / 16, NT = 2 * CG;
  static_assert(CG == 1 || CG == 2, "warps side by side, 16 or 32 columns each");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BNq, m0 = blockIdx.y * BMq;
  const int qb = blockIdx.z * rows_per_split, qe = min(Kq, qb + rows_per_split);
  const int nchunks = (qe - qb + QROWS - 1) / QROWS;
  const int wn0 = warp * WTN;  // the warp's first column in the tile
  auto sX = [&](int s) { return reinterpret_cast<bf16*>(smem + s * G::STAGE); };
  auto sQ = [&](int s) { return reinterpret_cast<int8_t*>(smem + s * G::STAGE + G::X_BYTES); };
  auto load = [&](int s, int c) {
    stage_chunk<PACKED, BMq, BNq, QROWS, NTH, false, LDX, LDQ>(sQ(s), sX(s), x, q, qb + c * QROWS, qe, m0, n0, M, K,
                                                               N, gq, vec);
  };

  float acc[MT][NT][4];
  float part[RAW ? MT : 1][RAW ? NT : 1][4];  // RAW: the current group's sum of code products
  float sc[CG][4], scn[CG][4];  // RAW: scales of this lane's columns 4t .. 4t + 3 of each group: current, next
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if constexpr (RAW) part[i][j][e] = 0.f;
      }
  const int n_groups = (Kq + gq - 1) / gq;
  auto load_scales = [&](int grp, float (&dst)[CG][4]) {
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int n = n0 + wn0 + 16 * cg + 4 * t;
      const float* sp = scales + static_cast<size_t>(grp) * N + n;
      if (vec) {
        const float4 v = grp < n_groups && n < N ? __ldg(reinterpret_cast<const float4*>(sp))
                                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[cg][0] = v.x;
        dst[cg][1] = v.y;
        dst[cg][2] = v.z;
        dst[cg][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[cg][e] = grp < n_groups && n + e < N ? sp[e] : 0.f;
      }
    }
  };
  // tile E's C columns 2t, 2t + 1 are physical 4t, 4t + 2; tile O's 4t + 1, 4t + 3
  auto flush = [&]() {
    if constexpr (RAW) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int cg = 0; cg < CG; ++cg)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * cg][e] = fmaf(part[i][2 * cg][e], sc[cg][2 * (e & 1)], acc[i][2 * cg][e]);
            acc[i][2 * cg + 1][e] = fmaf(part[i][2 * cg + 1][e], sc[cg][2 * (e & 1) + 1], acc[i][2 * cg + 1][e]);
            part[i][2 * cg][e] = 0.f;
            part[i][2 * cg + 1][e] = 0.f;
          }
    }
  };
  int cur = -1, next_row = qb;  // RAW: the group `part` belongs to, and the code row where the next one starts

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  // RAW: entering the group of code row qrow0 (flush the last one; its successor's scales were loaded a group ago)
  auto enter_group = [&](int qrow0) {
    if constexpr (RAW) {
      const int grp = qrow0 / gq;
      if (cur >= 0) flush();
      if (cur >= 0 && grp == cur + 1) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[cg][e] = scn[cg][e];
      } else {
        load_scales(grp, sc);
      }
      load_scales(grp + 1, scn);  // a group ahead: not waited on until the group ends
      cur = grp;
      next_row = (grp + 1) * gq;
    }
  };
  // 16 code rows of the stage (row block rb, first code row qrow0): one k16 step, or two when packed (low, high)
  auto row_block = [&](const bf16* xs, const int8_t* qs, int rb, int qrow0) {
    uint32_t rc[CG][2];  // this lane's codes: [column group][k rows 0-7, 8-15]
    const int8_t* qrow = qs + (16 * rb + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + wn0;
    if constexpr (CG == 2) {
      uint32_t r4[4];
      ldsm_x4_t(r4, qrow + (lane >> 4) * 16);
      rc[0][0] = r4[0];
      rc[0][1] = r4[1];
      rc[1][0] = r4[2];
      rc[1][1] = r4[3];
    } else {
      ldsm_x2_t(rc[0], qrow);
    }
#pragma unroll
    for (int h = 0; h < (PACKED ? 2 : 1); ++h) {
      const int kk = PACKED ? 2 * rb + h : rb;
      uint32_t b[NT][2];
#pragma unroll
      for (int cg = 0; cg < CG; ++cg)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t r = rc[cg][half];
          if constexpr (RAW && PACKED) {
            const uint32_t rn = r ^ 0x88888888u;
            b[2 * cg][half] = h ? i4x2_bf16<4>(rn) : i4x2_bf16<0>(rn);
            b[2 * cg + 1][half] = h ? i4x2_bf16<12>(rn) : i4x2_bf16<8>(rn);
          } else if constexpr (RAW) {
            const uint32_t rx = r ^ 0x80808080u;
            b[2 * cg][half] = i8x2_bf16<0, 2>(rx);
            b[2 * cg + 1][half] = i8x2_bf16<1, 3>(rx);
          } else {  // code * scale, rounded to bf16 (groups that a k16 step may cross)
            const int qa = qrow0 + 8 * half + 2 * t, nE = n0 + wn0 + 16 * cg + 2 * g;
            float s4[4];  // (row qa, nE), (qa, nE + 1), (qa + 1, nE), (qa + 1, nE + 1)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = qa + (e >> 1), n = nE + (e & 1);
              s4[e] = qr < qe && n < N ? __ldg(scales + static_cast<size_t>(qr / gq) * N + n) : 0.f;
            }
            b[2 * cg][half] = pack_bf16(code_of<PACKED>(r, 0, h) * s4[0], code_of<PACKED>(r, 2, h) * s4[2]);
            b[2 * cg + 1][half] = pack_bf16(code_of<PACKED>(r, 1, h) * s4[1], code_of<PACKED>(r, 3, h) * s4[3]);
          }
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, xs + (16 * i + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (RAW) {
            mma_bf16(part[i][j], a, b[j][0], b[j][1]);
          } else {
            mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1, whose stage is refilled now
    if (c + S - 1 < nchunks) load((c + S - 1) % S, c + S - 1);
    cp_async_commit();
    const int r0 = qb + c * QROWS;
    const bf16* xs = sX(c % S);
    const int8_t* qs = sQ(c % S);
    if (RAW && r0 >= next_row) enter_group(r0);
    if (r0 + QROWS <= qe && (!RAW || r0 + QROWS <= next_row)) {
      // the common case: the chunk lies inside the slice and one group, so its steps take no branch
#pragma unroll
      for (int rb = 0; rb < QROWS / 16; ++rb) row_block(xs, qs, rb, r0 + 16 * rb);
    } else {
#pragma unroll
      for (int rb = 0; rb < QROWS / 16; ++rb) {
        const int qrow0 = r0 + 16 * rb;
        if (qrow0 >= qe) break;  // past the slice
        if (RAW && qrow0 >= next_row) enter_group(qrow0);
        row_block(xs, qs, rb, qrow0);
      }
    }
  }
  cp_async_wait<0>();
  if (cur >= 0) flush();

  // this lane's outputs: rows g and g + 8 of each m16 tile, physical columns 4t .. 4t + 3 of each group
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 16 * i + g + 8 * hr;
      if (m >= M) continue;
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const int n = n0 + wn0 + 16 * cg + 4 * t;
        const float v[4] = {acc[i][2 * cg][2 * hr], acc[i][2 * cg + 1][2 * hr], acc[i][2 * cg][2 * hr + 1],
                            acc[i][2 * cg + 1][2 * hr + 1]};
        if (split) {
          float* dst = ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n;
          if (vec) {
            if (n < N) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + e < N) dst[e] = v[e];
          }
        } else {
          bf16* dst = out + static_cast<size_t>(m) * N + n;
          if (vec) {
            if (n < N) *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + e < N) dst[e] = __float2bfloat16(v[e]);
          }
        }
      }
    }
  if (split) split_finish<BMq, BNq, NTH>(ws, counters, out, M, N, m0, n0, vec, &is_last);
}

// The 128 x 128 tile for prefill-sized M: two warpgroups, each the product
// out^T (its 64 columns x 128 rows) = W^T x^T on wgmma m64n128k16, with the
// weight as the register operand A and the x stage as the shared-memory
// operand B, kept in wgmma's 128-byte swizzle by the cp.async ring. Each
// warp converts its own 16 columns' codes, straight from the stage's bytes
// into A fragments (ldmatrix.trans as in qmm_bf16_kernel: A row j is
// physical column 2j, row j + 8 column 2j + 1, so a lane's D rows are the
// adjacent columns 2g, 2g + 1). A fragments alternate between two register
// sets, so a chunk converts while the previous chunk's products run; the ring
// is refilled two chunks behind, once every warpgroup has seen them done.
template <bool PACKED, bool RAW>
__global__ void __launch_bounds__(256, 1)
qmm_wgmma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scales,
                 bf16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N,
                 int Kq, int gq, int rows_per_split, int vec) {
  using G = QGeo<2, PACKED>;
  constexpr int BMq = 128, BNq = 128, NTH = 256, QROWS = G::QROWS, LDQ = G::LDQ, S = G::STAGES;
  static_assert(G::NTH == NTH && G::CORE && S >= 4, "two warpgroups, x in the 128-byte swizzle");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int is_last;
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1 KB aligned

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BNq, m0 = blockIdx.y * BMq;
  const int qb = blockIdx.z * rows_per_split, qe = min(Kq, qb + rows_per_split);
  const int nchunks = (qe - qb + QROWS - 1) / QROWS;
  const int wc = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 columns in the tile
  const int ncol = n0 + wc + 2 * g;                   // this lane's two columns: ncol, ncol + 1
  auto sX = [&](int s) { return reinterpret_cast<bf16*>(smem + s * G::STAGE); };
  auto sQ = [&](int s) { return reinterpret_cast<int8_t*>(smem + s * G::STAGE + G::X_BYTES); };
  auto load = [&](int s, int c) {
    stage_chunk<PACKED, BMq, BNq, QROWS, NTH, true, kBK, LDQ>(sQ(s), sX(s), x, q, qb + c * QROWS, qe, m0, n0, M, K,
                                                              N, gq, vec);
  };

  float acc[64], part[RAW ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a0[kBK / 16][4], a1[kBK / 16][4];  // A fragments of even and odd chunks
  float sc0 = 0.f, sc1 = 0.f;                 // RAW: the current group's scales of columns ncol, ncol + 1
  int cur = -1, next_row = qb;
  bool fresh = true;  // RAW: the next product starts the group's sum (scale-d 0)
  auto flush = [&]() {
    if constexpr (RAW) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] = fmaf(part[4 * j], sc0, acc[4 * j]);
        acc[4 * j + 1] = fmaf(part[4 * j + 1], sc0, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(part[4 * j + 2], sc1, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(part[4 * j + 3], sc1, acc[4 * j + 3]);
      }
    }
  };

  // chunk c's codes -> A fragments (k16 steps kk = 0..3)
  auto convert = [&](int c, uint32_t (&af)[kBK / 16][4]) {
    const int r0 = qb + c * QROWS;
    const int8_t* qs = sQ(c % S) + wc;
    if constexpr (PACKED) {  // 32 code rows: low nibbles of rows 16p.. are step 2p, high nibbles step 2p + 1
      uint32_t r[4];
      ldsm_x4_t(r, qs + ((lane & 7) + (lane >> 3) * 8) * LDQ);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t rr = r[2 * p + half];
            if constexpr (RAW) {
              const uint32_t rn = rr ^ 0x88888888u;
              af[2 * p + h][2 * half] = h ? i4x2_bf16<4>(rn) : i4x2_bf16<0>(rn);
              af[2 * p + h][2 * half + 1] = h ? i4x2_bf16<12>(rn) : i4x2_bf16<8>(rn);
            } else {
              const int qa = r0 + 16 * p + 8 * half + 2 * t;
              float s4[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qr = qa + (e >> 1), n = ncol + (e & 1);
                s4[e] = qr < qe && n < N ? __ldg(scales + static_cast<size_t>(qr / gq) * N + n) : 0.f;
              }
              af[2 * p + h][2 * half] = pack_bf16(code_of<true>(rr, 0, h) * s4[0], code_of<true>(rr, 2, h) * s4[2]);
              af[2 * p + h][2 * half + 1] =
                  pack_bf16(code_of<true>(rr, 1, h) * s4[1], code_of<true>(rr, 3, h) * s4[3]);
            }
          }
    } else {  // 64 code rows: step kk is rows 16 kk ..; each x4 covers two steps
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t r[4];
        ldsm_x4_t(r, qs + (32 * kp + (lane & 7) + (lane >> 3) * 8) * LDQ);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t rr = r[2 * u + half];
            uint32_t* dst = &af[2 * kp + u][2 * half];
            if constexpr (RAW) {
              const uint32_t rx = rr ^ 0x80808080u;
              dst[0] = i8x2_bf16<0, 2>(rx);
              dst[1] = i8x2_bf16<1, 3>(rx);
            } else {
              const int qa = r0 + 16 * (2 * kp + u) + 8 * half + 2 * t;
              float s4[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qr = qa + (e >> 1), n = ncol + (e & 1);
                s4[e] = qr < qe && n < N ? __ldg(scales + static_cast<size_t>(qr / gq) * N + n) : 0.f;
              }
              dst[0] = pack_bf16(code_of<false>(rr, 0, 0) * s4[0], code_of<false>(rr, 2, 0) * s4[2]);
              dst[1] = pack_bf16(code_of<false>(rr, 1, 0) * s4[1], code_of<false>(rr, 3, 0) * s4[3]);
            }
          }
      }
    }
  };

  auto issue = [&](int c, const uint32_t (&af)[kBK / 16][4]) {
    const int r0 = qb + c * QROWS;
    const bf16* xs = sX(c % S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      int qrow0, k_unused;
      tile_k<PACKED>(r0, kk * 16, gq, qrow0, k_unused);
      if (qrow0 >= qe) break;
      // B: columns 16 kk .. of the x stage, 32 bytes into each swizzled 128-byte row
      const uint64_t desc = wgmma_desc_sw128(xs + kk * 16);
      if constexpr (RAW) {
        if (qrow0 >= next_row) {
          const int grp = qrow0 / gq;
          if (cur >= 0) {
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(part);
            flush();
            fence_regs(acc);
            wgmma_fence();
          }
          const float* sp = scales + static_cast<size_t>(grp) * N + ncol;
          sc0 = ncol < N ? __ldg(sp) : 0.f;
          sc1 = ncol + 1 < N ? __ldg(sp + 1) : 0.f;
          cur = grp;
          next_row = (grp + 1) * gq;
          fresh = true;
        }
        wgmma_m64n128k16_rs(part, af[kk], desc, fresh ? 0 : 1);
        fresh = false;
      } else {
        wgmma_m64n128k16_rs(acc, af[kk], desc, 1);
      }
    }
    wgmma_commit();
  };

  // chunk c: its data is in; every warpgroup has seen chunk c - 2 done, so that stage refills now
  auto step = [&](int c, uint32_t (&af)[kBK / 16][4], uint32_t (&other)[kBK / 16][4]) {
    cp_async_wait<S - 3>();
    fence_proxy_async();  // this thread's x copies are visible to wgmma
    __syncthreads();
    if (c + S - 2 < nchunks) load((c + S - 2) % S, c + S - 2);
    cp_async_commit();
    convert(c, af);  // af's last products (chunk c - 2) are done
    issue(c, af);
    wgmma_wait<1>();  // chunk c - 1 is done: its A registers may be reused
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(other[kk][e])::"memory");
  };

#pragma unroll
  for (int s = 0; s < S - 2; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; c += 2) {
    step(c, a0, a1);
    if (c + 1 < nchunks) step(c + 1, a1, a0);
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  if constexpr (RAW) fence_regs(part);
  fence_regs(acc);
  if (cur >= 0) flush();

  // D rows are columns ncol (d[4j], d[4j + 1]) and ncol + 1 (d[4j + 2], d[4j + 3]); its columns are rows 8j + 2t, + 1
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + 8 * j + 2 * t + u;
      if (m >= M || ncol >= N) continue;
      const float v0 = acc[4 * j + u], v1 = acc[4 * j + 2 + u];
      if (split) {
        float* dst = ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + ncol;
        if (vec) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (ncol + 1 < N) dst[1] = v1;
        }
      } else {
        bf16* dst = out + static_cast<size_t>(m) * N + ncol;
        if (vec) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (ncol + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  if (split) split_finish<BMq, BNq, NTH>(ws, counters, out, M, N, m0, n0, vec, &is_last);
}

struct QArgs {
  const bf16* x;
  const int8_t* q;
  const float* scales;
  bf16* out;
  float* ws;
  int* counters;
  int M, K, N, Kq, gq, splits, rows_per_split, vec;
  cudaStream_t stream;
};

template <int CFG, bool PACKED, bool RAW>
int launch_bf16(const QArgs& a) {
  using G = QGeo<CFG, PACKED>;
  auto kernel = [] {
    if constexpr (CFG == 2) {
      return qmm_wgmma_kernel<PACKED, RAW>;
    } else {
      return qmm_bf16_kernel<CFG, PACKED, RAW>;
    }
  }();
  cudaError_t err = allow_smem(kernel, G::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.N + QCfg<CFG>::BN - 1) / QCfg<CFG>::BN, (a.M + QCfg<CFG>::BM - 1) / QCfg<CFG>::BM, a.splits);
  if (grid.y > 65535) return kUnsupported;
  kernel<<<grid, G::NTH, G::smem, a.stream>>>(a.x, a.q, a.scales, a.out, a.ws, a.counters, a.M, a.K, a.N, a.Kq,
                                               a.gq, a.rows_per_split, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int CFG>
int dispatch_bf16(const QArgs& a, bool packed, bool raw) {
  if (packed) return raw ? launch_bf16<CFG, true, true>(a) : launch_bf16<CFG, true, false>(a);
  return raw ? launch_bf16<CFG, false, true>(a) : launch_bf16<CFG, false, false>(a);
}

}  // namespace
}  // namespace dstorch

// x (M, K) and out (M, N) contiguous of `dtype`; q int8 (K, N), or (K/2, N) when packed; scales fp32
// (n_groups, N) with n_groups dividing K (and K / n_groups even when packed). bf16 takes the host's
// plan: tile configuration `cfg` (0, 1, 2), `splits` slices of K of `groups_per_split` groups each
// (the last may be shorter) and, when splits > 1, `ws` fp32 (splits, M, N) and `counters` int32, one
// per output tile, zero on entry (the kernel leaves them zero). float32 ignores the plan. Returns 0
// or an error code.
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scales, void* out, int M, int K, int N,
                                   int n_groups, int packed, int dtype, int cfg, int splits, int groups_per_split,
                                   void* ws, void* counters, void* stream) {
  using namespace dstorch;
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || n_groups <= 0 || K % n_groups || (packed && (K / n_groups) % 2) || (M + BM - 1) / BM > 65535)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return packed ? launch_fp32<true>(x, q, scales, out, M, K, N, n_groups, s)
                  : launch_fp32<false>(x, q, scales, out, M, K, N, n_groups, s);
  if (dtype != kBFloat16) return kUnsupported;
  if (cfg < 0 || cfg > 2 || splits < 1 || splits > 65535 || groups_per_split < 1 ||
      static_cast<long long>(splits - 1) * groups_per_split >= n_groups ||
      static_cast<long long>(splits) * groups_per_split < n_groups ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return kUnsupported;
  QArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.K = K;
  a.N = N;
  a.Kq = packed ? K / 2 : K;
  a.gq = a.Kq / n_groups;
  a.splits = splits;
  a.rows_per_split = groups_per_split * a.gq;
  // 16-byte copies: whole code vectors, 8-column x runs inside one group and one slice
  a.vec = N % 16 == 0 && K % 8 == 0 && (!packed || a.gq % 8 == 0) && (splits == 1 || a.gq % 8 == 0) &&
          aligned16(x) && aligned16(q) && aligned16(scales) && aligned16(out) && (ws == nullptr || aligned16(ws));
  a.stream = s;
  // raw codes on the tensor cores where no k16 step crosses a group
  const bool raw = a.gq % 16 == 0;
  switch (cfg) {
    case 0: return dispatch_bf16<0>(a, packed, raw);
    case 1: return dispatch_bf16<1>(a, packed, raw);
    default: return dispatch_bf16<2>(a, packed, raw);
  }
}
