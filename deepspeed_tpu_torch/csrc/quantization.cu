// Group-wise symmetric quantisation for Hopper: flat groups of g consecutive
// elements, int8 codes (int8 or int4 range) and one fp32 scale per group.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/quantization.py
// ::_quant_kernel (pallas_call at :49, quantize_groupwise) and
// ::_dequant_kernel (pallas_call at :64, dequantize_groupwise):
//   scale = absmax(group) / qmax            (1.0 for an all-zero group)
//   q     = clip(round_half_even(x / scale), -qmax - 1, qmax)   as int8
//   out   = (float)q * scale                 cast to the output dtype
// with qmax = 2^(bits-1) - 1 (int4 keeps one code per int8 byte, unpacked).
//
// Exactness: the oracle is quantize_groupwise_xla, which divides. The scale
// is __fdiv_rn(absmax, qmax) and each code rintf(__fdiv_rn(x, scale)): IEEE
// divisions rounded to nearest, never a multiply by 1/qmax (the Pallas body's
// reciprocal form differs from the oracle by 1 ulp in some groups). The
// dequantised value is one fp32 product, rounded once to bf16 with
// __float2bfloat16_rn. So codes, scales and outputs equal the plain PyTorch
// version bit for bit. ops/_build.py's NVCC_FLAGS must never gain
// --use_fast_math or -prec-div=false: either would break that.
//
// What bounds them: bytes. Quantising bf16 reads 2 B and writes 1 + 4/g B per
// element (8.03e9 elements of llama3_8b at g = 64: 24.6 GB, 7.34 ms at
// 3.35 TB/s); dequantising to bf16 moves the same bytes the other way. The
// design: quantise gives each group a team of 1-32 lanes of one warp (several
// groups per warp when a group is shorter than 32 vectors), each lane loading
// 16-byte vectors; the team's absmax is a shuffle reduction, then each lane
// re-reads its vectors (L1 hits) to write its codes. Dequantise is a
// grid-stride loop over 8-code vectors that share one scale. Partial blocks
// and ragged tails are masked; there is no padding copy.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void load_n(const T* p, float* o) {
  if constexpr (VEC == 1) {
    o[0] = to_float(p[0]);
  } else {
    load_vec<VEC>(p, o);
  }
}

template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* q, const int8_t* c) {
  if constexpr (VEC == 1) {
    q[0] = c[0];
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(q) = make_char4(c[0], c[1], c[2], c[3]);
  } else {
    static_assert(VEC == 8, "code vectors come in 1, 4 or 8");
    uint2 u;
    int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = c[i];
    *reinterpret_cast<uint2*>(q) = u;
  }
}

// One team of 2^team_log2 lanes per group; VEC elements per load.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s, long long rows, int g,
             int team_log2, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int team = 1 << team_log2;
  const int sub = lane & (team - 1);
  const long long row = (warp << (5 - team_log2)) + (lane >> team_log2);
  const bool active = row < rows;
  const int chunks = g / VEC;
  const T* xr = x + row * g;
  float amax = 0.f;
  if (active) {
    for (int c = sub; c < chunks; c += team) {
      float v[VEC];
      load_n<T, VEC>(xr + c * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  // xor offsets below the team size stay inside the team's aligned lanes
  for (int o = team >> 1; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!active) return;
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, qmax);
  if (sub == 0) s[row] = scale;
  const float lo = -qmax - 1.f;
  int8_t* qr = q + row * g;
  for (int c = sub; c < chunks; c += team) {
    float v[VEC];
    load_n<T, VEC>(xr + c * VEC, v);
    int8_t codes[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float r = rintf(__fdiv_rn(v[i], scale));
      codes[i] = static_cast<int8_t>(fminf(fmaxf(r, lo), qmax));
    }
    store_codes<VEC>(qr + c * VEC, codes);
  }
}

// out[i] = (float)q[i] * s[i / g], VEC codes at a time (VEC divides g).
template <typename O, int VEC>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s, O* __restrict__ out, long long n, int g) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long nv = n / VEC;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < nv; i += stride) {
    const long long e = i * VEC;
    const float sc = s[e / g];
    float v[VEC];
    if constexpr (VEC == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(q + e);
      const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = static_cast<float>(b[j]) * sc;
      store_vec<8>(out + e, v);
    } else {
      out[e] = from_float<O>(static_cast<float>(q[e]) * sc);
    }
  }
}

inline int ceil_log2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T, int VEC>
int launch_quant(const void* x, void* q, void* s, long long rows, int g, float qmax, cudaStream_t st) {
  const int team_log2 = ceil_log2(g / VEC) > 5 ? 5 : ceil_log2(g / VEC);
  const long long warps = (rows + (32 >> team_log2) - 1) >> (5 - team_log2);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  quant_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), rows, g, team_log2, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename O, int VEC>
int launch_dequant(const void* q, const void* s, void* out, long long n, int g, cudaStream_t st) {
  long long blocks = (n / VEC + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  dequant_kernel<O, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<O*>(out), n, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch

// x: rows * g contiguous elements (dtype code 0 fp32, 1 bf16); q: rows * g
// int8; s: rows fp32. bits 8 or 4. Returns 0, kUnsupported or a cudaError_t.
extern "C" int ds_quantize_groupwise(const void* x, void* q, void* s, long long rows, int g, int bits, int dtype,
                                     void* stream) {
  using namespace dstorch;
  if (rows <= 0) return 0;
  if (g <= 0 || (bits != 8 && bits != 4)) return kUnsupported;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool qal = (reinterpret_cast<uintptr_t>(q) & 7u) == 0;
  if (dtype == kFloat32) {
    if (g % 4 == 0 && aligned16(x) && qal) return launch_quant<float, 4>(x, q, s, rows, g, qmax, st);
    return launch_quant<float, 1>(x, q, s, rows, g, qmax, st);
  }
  if (dtype == kBFloat16) {
    if (g % 8 == 0 && aligned16(x) && qal) return launch_quant<__nv_bfloat16, 8>(x, q, s, rows, g, qmax, st);
    return launch_quant<__nv_bfloat16, 1>(x, q, s, rows, g, qmax, st);
  }
  return kUnsupported;
}

// q: n = rows * g int8 codes; s: rows fp32; out: n elements (dtype code 0
// fp32, 1 bf16). Returns 0, kUnsupported or a cudaError_t.
extern "C" int ds_dequantize_groupwise(const void* q, const void* s, void* out, long long n, int g, int dtype,
                                       void* stream) {
  using namespace dstorch;
  if (n <= 0) return 0;
  if (g <= 0) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = g % 8 == 0 && (reinterpret_cast<uintptr_t>(q) & 7u) == 0 && aligned16(out);
  if (dtype == kFloat32) {
    return vec ? launch_dequant<float, 8>(q, s, out, n, g, st) : launch_dequant<float, 1>(q, s, out, n, g, st);
  }
  if (dtype == kBFloat16) {
    return vec ? launch_dequant<__nv_bfloat16, 8>(q, s, out, n, g, st)
               : launch_dequant<__nv_bfloat16, 1>(q, s, out, n, g, st);
  }
  return kUnsupported;
}
