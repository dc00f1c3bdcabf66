// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point (extern "C") that the
// Python side loads with ctypes: pointers and the stream arrive as void*,
// the function launches on that stream and returns cudaGetLastError() (or a
// negative code for a configuration it does not take). No PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {

// dtype codes shared with deepspeed_tpu_torch/ops/_build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// returned for a shape/dtype combination a kernel does not take
constexpr int kUnsupported = -2;

constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF mask value

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// N consecutive elements (16-byte aligned for N*sizeof(T) >= 16, 8-byte for
// 4 bf16) -> N floats, with vector loads. Works on global and shared memory.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  static_assert(N % 4 == 0, "float vectors come in 4s");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 f = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = f.x;
    o[4 * i + 1] = f.y;
    o[4 * i + 2] = f.z;
    o[4 * i + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  static_assert(N % 4 == 0, "bf16 vectors come in 4s");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        o[8 * i + 2 * j] = f.x;
        o[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(N % 4 == 0, "float vectors come in 4s");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(N % 8 == 0, "bf16 stores come in 8s");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
    reinterpret_cast<uint4*>(p)[i] = u;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Raise a kernel's dynamic shared-memory cap once per instantiation.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace dstorch
