// Row normalisation for Hopper: the forward body of RMSNorm (csrc/rms_norm.cu) and LayerNorm
// (csrc/layer_norm.cu), one template with a compile-time LN flag.
//
// RMSNorm:   y = x * rsqrt(mean(x^2) + eps) * w
// LayerNorm: y = (x - mean) * rsqrt(var + eps) * w + b, var the mean of squared deviations from the mean
// (not E[x^2] - mean^2, which cancels badly for rows with a large mean). Statistics in fp32, y in x's type.
//
// The op is bound by memory: x is read once and y written once, with a handful of flops an element. On the
// card that leaves latency as the enemy: the rows must keep enough bytes in flight on every SM. The design:
// - A row is owned by a team of lanes: 8 or 16 lanes for rows of 8-16 vectors of 16 bytes (head_dim rows of
//   the qk-norm), a warp up to 32 x kLaneVectors vectors, and 2-8 warps above (d 2048 in bf16 on two, 4096
//   on four). Each lane holds NV vectors of x in registers as loaded (bf16 stays as packed pairs and widens
//   at use), NV a compile-time constant of the width's bucket, so the register cache is sized to the row
//   and x is read from memory once.
// - The weight (and bias) vectors are loaded together with x, before any reduction: no dependent second
//   round trip a row (a CTA fence after the loads holds the assembler to that).
// - A team of a warp or less reduces by xor shuffles among its own lanes; a wider team adds its warps'
//   sums through shared memory under a named barrier of its own (bar.sync id, lanes). No block-wide barrier.
//   Every lane ends with the same bits (the butterflies add the same pairs; the warps' sums in warp order),
//   and nothing is atomic, so repeated calls are bit-equal.
// - The grid spreads the rows over the SMs: ceil(rows / SMs) teams a block, up to kBlockThreads threads,
//   so that a decode batch takes one row an SM and a large one keeps several rows a block in flight.
// Rows wider than kMaxWidth, widths that are not whole 16-byte vectors, and pointers that are not 16-byte
// aligned take the general kernel: one block a row, plain loads, three passes over x.
#pragma once

#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kBlockThreads = 256;  // threads a block of the row kernel holds at most
// 16-byte x vectors a lane holds once its team is a warp or wider. norm_probe.py: 4 beat 8 and 16 (one warp
// a row of d 2048 in bf16: more registers, fewer rows in flight) and 1 and 2 at T 2048 in bf16.
constexpr int kLaneVectors = 4;
constexpr int kMaxWidth = 8192;  // the widest row the row kernel takes

template <int BYTES>
struct Pack {
  uint32_t u[BYTES / 4];
};

// 16-byte (or 8-byte) read-only loads, volatile so that the compiler keeps them where they stand (see
// rows_body's fence for the assembler).
template <int BYTES>
__device__ __forceinline__ Pack<BYTES> load_pack(const void* p) {
  Pack<BYTES> o;
  if constexpr (BYTES == 8) {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(o.u[0]), "=r"(o.u[1]) : "l"(p));
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(o.u[4 * i]), "=r"(o.u[4 * i + 1]), "=r"(o.u[4 * i + 2]), "=r"(o.u[4 * i + 3])
                   : "l"(static_cast<const char*>(p) + 16 * i));
    }
  }
  return o;
}

// element j of a pack of T, in fp32 (bf16 to fp32 is exact: its bits move up 16)
template <typename T, int BYTES>
__device__ __forceinline__ float elem(const Pack<BYTES>& p, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(p.u[j]);
  } else {
    return __uint_as_float((j & 1) ? (p.u[j >> 1] & 0xffff0000u) : (p.u[j >> 1] << 16));
  }
}

// Sum over a team of LANES consecutive threads. Up to a warp: xor shuffles among the team's lanes (`mask`).
// Wider: each warp's sum into the team's shared slots, a named barrier for the team's threads alone, then
// every thread adds the slots in warp order. The two sets of slots alternate, so that a team's next sum
// cannot overwrite slots that a lane is still reading (the barrier between them orders the two).
template <int LANES>
__device__ __forceinline__ float team_sum(float v, unsigned mask, float* red, int& slot, int team) {
#pragma unroll
  for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  if constexpr (LANES > 32) {
    constexpr int WARPS = LANES / 32;
    float* r = red + slot * WARPS;
    if ((threadIdx.x & 31) == 0) r[(threadIdx.x % LANES) >> 5] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(LANES) : "memory");
    v = r[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) v += r[i];
    slot ^= 1;
  }
  return v;
}

// The statistics of one row held in registers, and its 16-byte stores of y.
template <bool LN, typename T, typename W, int LANES, int NV, int WB>
__device__ __forceinline__ void norm_row(const Pack<16> (&xv)[NV], const Pack<WB> (&wv)[NV],
                                         const Pack<WB> (&bv)[LN ? NV : 1], T* __restrict__ orow, int lane,
                                         int nvec, int d, float eps, unsigned mask, float* tred, int& slot,
                                         int team) {
  constexpr int VEC = 16 / sizeof(T);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + k * LANES < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = elem<T>(xv[k], j);
        s += LN ? v : v * v;
      }
    }
  }
  s = team_sum<LANES>(s, mask, tred, slot, team);
  float mean = 0.f, r;
  if constexpr (LN) {
    mean = s / static_cast<float>(d);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + k * LANES < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = elem<T>(xv[k], j) - mean;
          ss += c * c;
        }
      }
    }
    r = rsqrtf(team_sum<LANES>(ss, mask, tred, slot, team) / static_cast<float>(d) + eps);
  } else {
    r = rsqrtf(s / static_cast<float>(d) + eps);
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * LANES;
    if (i < nvec) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = (elem<T>(xv[k], j) - mean) * r * elem<W>(wv[k], j);
        if constexpr (LN) {
          o[j] = y + elem<W>(bv[k], j);
        } else {
          o[j] = y;
        }
      }
      store_vec<VEC>(orow + i * VEC, o);
    }
  }
}

// One row per team: the team's NV vectors a lane of x, w and b loaded together, one reduction (RMSNorm) or
// two (LayerNorm: the mean, then the squared deviations from the registers), then 16-byte stores of y.
template <bool LN, typename T, typename W, int LANES, int NV>
__device__ __forceinline__ void rows_body(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                                          T* __restrict__ out, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector of x
  constexpr int WB = VEC * sizeof(W);  // bytes of w (and of b) beside it: 8, 16 or 32
  constexpr int WARPS = LANES > 32 ? LANES / 32 : 1;
  constexpr int SUB = LANES < 32 ? LANES : 32;
  __shared__ float red[LANES > 32 ? kBlockThreads / LANES : 1][2 * WARPS];
  const int teams = blockDim.x / LANES, team = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int row = blockIdx.x * teams + team;
  if (row >= rows) return;  // a sub-warp team shuffles among its own lanes only, so it may leave
  const unsigned mask = (0xffffffffu >> (32 - SUB)) << ((threadIdx.x & 31) & ~(SUB - 1));
  const int nvec = d / VEC;
  const T* xr = x + static_cast<size_t>(row) * d;
  Pack<16> xv[NV];
  Pack<WB> wv[NV];
  Pack<WB> bv[LN ? NV : 1];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * LANES;
    if (i < nvec) {
      xv[k] = load_pack<16>(xr + i * VEC);
      wv[k] = load_pack<WB>(w + i * VEC);
      if constexpr (LN) bv[k] = load_pack<WB>(b + i * VEC);
    }
  }
  // ptxas may not move a load across a CTA fence, so w and b are issued with x. Without it ptxas sinks them
  // below the first reduction in some instantiations (LayerNorm in fp32 at 64 and 128 lanes: a second round
  // trip a row).
  __threadfence_block();
  int slot = 0;
  norm_row<LN, T, W, LANES, NV>(xv, wv, bv, out + static_cast<size_t>(row) * d, lane, nvec, d, eps, mask,
                                red[LANES > 32 ? team : 0], slot, team);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float t = 0.f;
  for (int i = 0; i < nwarps; ++i) t += red[i];
  return t;
}

// The general kernel: one block a row, element loads, the statistics in block-wide sums (each its own
// shared buffer, so the two sums of LayerNorm need no barrier between them).
template <bool LN, typename T, typename W>
__device__ __forceinline__ void general_body(const T* __restrict__ x, const W* __restrict__ w,
                                             const W* __restrict__ b, T* __restrict__ out, int d, float eps) {
  __shared__ float red[2][32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float mean = 0.f;
  if constexpr (LN) {
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) s += to_float(xr[i]);
    mean = block_sum(s, red[0]) / static_cast<float>(d);
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = to_float(xr[i]) - mean;
    ss += c * c;
  }
  const float r = rsqrtf(block_sum(ss, red[1]) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float y = (to_float(xr[i]) - mean) * r * to_float(w[i]);
    if constexpr (LN) {
      orow[i] = from_float<T>(y + to_float(b[i]));
    } else {
      orow[i] = from_float<T>(y);
    }
  }
}

// Own names for the two norms' kernels, so that a profile files them apart.
template <typename T, typename W, int LANES, int NV>
__global__ void __launch_bounds__(kBlockThreads)
rms_norm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b, T* __restrict__ out,
                     int rows, int d, float eps) {
  rows_body<false, T, W, LANES, NV>(x, w, b, out, rows, d, eps);
}

template <typename T, typename W, int LANES, int NV>
__global__ void __launch_bounds__(kBlockThreads)
layer_norm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                       T* __restrict__ out, int rows, int d, float eps) {
  rows_body<true, T, W, LANES, NV>(x, w, b, out, rows, d, eps);
}

template <typename T, typename W>
__global__ void __launch_bounds__(256)
rms_norm_general_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                        T* __restrict__ out, int d, float eps) {
  general_body<false, T, W>(x, w, b, out, d, eps);
}

template <typename T, typename W>
__global__ void __launch_bounds__(256)
layer_norm_general_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                          T* __restrict__ out, int d, float eps) {
  general_body<true, T, W>(x, w, b, out, d, eps);
}

// The team of the bucket of CAP vectors a row: CAP lanes up to a warp, then as many warps as give each lane
// kLaneVectors vectors (half as many when x's vector brings more than 32 bytes of parameters: LayerNorm with
// bf16 x and fp32 w and b), at most a block.
template <bool LN, typename T, typename W, int CAP>
constexpr int team_lanes() {
  constexpr int wide = (16 / sizeof(T)) * sizeof(W) * (LN ? 2 : 1) > 32;
  constexpr int nv = wide && kLaneVectors > 1 ? kLaneVectors / 2 : kLaneVectors;
  constexpr int lanes = CAP / nv < 32 ? 32 : CAP / nv;
  return CAP <= 32 ? CAP : (lanes < kBlockThreads ? lanes : kBlockThreads);
}

template <bool LN, typename T, typename W, int CAP>
int launch_rows(const T* x, const W* w, const W* b, T* out, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int LANES = team_lanes<LN, T, W, CAP>();
  constexpr int NV = CAP / LANES;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                  cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (sms <= 0) return kUnsupported;
  // ceil(rows / SMs) teams a block, at least a warp's worth, at most kBlockThreads threads
  const int lo = LANES < 32 ? 32 / LANES : 1, hi = kBlockThreads / LANES;
  int teams = (rows + sms - 1) / sms;
  teams = teams < lo ? lo : (teams > hi ? hi : teams);
  const unsigned blocks = static_cast<unsigned>((rows + teams - 1) / teams);
  if constexpr (LN) {
    layer_norm_rows_kernel<T, W, LANES, NV><<<blocks, teams * LANES, 0, stream>>>(x, w, b, out, rows, d, eps);
  } else {
    rms_norm_rows_kernel<T, W, LANES, NV><<<blocks, teams * LANES, 0, stream>>>(x, w, b, out, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The smallest bucket of CAP vectors (a power of two from 8) that holds a row of nvec vectors.
template <bool LN, typename T, typename W, int CAP>
int launch_bucket(int nvec, const T* x, const W* w, const W* b, T* out, int rows, int d, float eps,
                  cudaStream_t stream) {
  if constexpr (CAP * (16 / static_cast<int>(sizeof(T))) < kMaxWidth) {
    if (nvec > CAP) return launch_bucket<LN, T, W, 2 * CAP>(nvec, x, w, b, out, rows, d, eps, stream);
  }
  return launch_rows<LN, T, W, CAP>(x, w, b, out, rows, d, eps, stream);
}

// x, out: (rows, d) contiguous; w (and b for LayerNorm): (d,). b is unused for RMSNorm.
template <bool LN, typename T, typename W>
int launch_norm(const void* x, const void* w, const void* b, void* out, long long rows, int d, float eps,
                cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
  const bool vec = d % VEC == 0 && d <= kMaxWidth && aligned16(x) && aligned16(w) && (!LN || aligned16(b)) &&
                   aligned16(out);
  if (vec) return launch_bucket<LN, T, W, 8>(d / VEC, xp, wp, bp, op, static_cast<int>(rows), d, eps, stream);
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  if constexpr (LN) {
    layer_norm_general_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, bp, op, d, eps);
  } else {
    rms_norm_general_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xp, wp, bp, op, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch
