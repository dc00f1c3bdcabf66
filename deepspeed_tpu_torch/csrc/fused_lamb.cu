// The LAMB direction for Hopper: one pass over flat fp32 param / grad / m / v.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_lamb.py
// ::_lamb_dir_kernel (pallas_call at :45, _lamb_direction), phase one of LAMB:
//   g' = g * grad_mult
//   m' = b1 m + (1 - b1) g'        v' = b2 v + (1 - b2) g'^2
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd p
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t. u is written to its own fp32
// buffer; m and v are updated in place, and only where the finite flag is
// set (a step whose gradients overflowed leaves them as they were). The
// per-tensor norms, the trust ratio and the apply stay in PyTorch, as the
// reference keeps them in XLA.
//
// What bounds it: 28 bytes per element (read p, g, m, v; write u, m, v) and
// about 15 flops, so memory: gpt2_1_3b's 1.31e9 elements move 36.8 GB,
// 11 ms at 3.35 TB/s, the same as fused_adam's. The design is fused_adam.cu's
// with the apply taken out: 16-byte vector loads in a grid-stride loop that
// covers every element (the TPU kernel padded each leaf to a 65,536 block;
// here a scalar tail loop takes what the vectors leave), and the step's
// scalars read from a small device tensor, so a step needs no host sync.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once from double on the host
};

__device__ __forceinline__ float lamb_one(float p, float g, float& m, float& v, float bc1, float bc2, float mult,
                                          const Hyper& hp) {
  g *= mult;
  m = hp.b1 * m + hp.omb1 * g;
  v = hp.b2 * v + hp.omb2 * g * g;
  return (m / bc1) / (sqrtf(v / bc2) + hp.eps) + hp.wd * p;
}

// scal: [lr, bc1, bc2, grad_mult, finite] (lr is read by the apply, not here)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
lamb_dir_kernel(const float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                float* __restrict__ v, float* __restrict__ u, long long n, const float* __restrict__ scal, Hyper hp) {
  const float bc1 = scal[1], bc2 = scal[2], mult = scal[3];
  const bool keep = scal[4] != 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (VEC) {
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      const float4 pp = reinterpret_cast<const float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      float4 uu;
      uu.x = lamb_one(pp.x, gg.x, mm.x, vv.x, bc1, bc2, mult, hp);
      uu.y = lamb_one(pp.y, gg.y, mm.y, vv.y, bc1, bc2, mult, hp);
      uu.z = lamb_one(pp.z, gg.z, mm.z, vv.z, bc1, bc2, mult, hp);
      uu.w = lamb_one(pp.w, gg.w, mm.w, vv.w, bc1, bc2, mult, hp);
      reinterpret_cast<float4*>(u)[i] = uu;
      if (keep) {
        reinterpret_cast<float4*>(m)[i] = mm;
        reinterpret_cast<float4*>(v)[i] = vv;
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    u[i] = lamb_one(p[i], g[i], mm, vv, bc1, bc2, mult, hp);
    if (keep) {
      m[i] = mm;
      v[i] = vv;
    }
  }
}

}  // namespace
}  // namespace dstorch

// p, g, m, v, u: n contiguous fp32; scal: 5 fp32 on the device (lr, 1 - b1^t,
// 1 - b2^t, gradient multiplier, finite flag). Returns 0 or a cudaError_t.
extern "C" int ds_lamb_direction(const void* p, const void* g, void* m, void* v, void* u, long long n,
                                 const void* scal, float b1, float omb1, float b2, float omb2, float eps, float wd,
                                 void* stream) {
  using namespace dstorch;
  if (n <= 0) return 0;
  const Hyper hp{b1, omb1, b2, omb2, eps, wd};
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) && aligned16(u);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks per SM
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  float* up = static_cast<float*>(u);
  const float* sp = static_cast<const float*>(scal);
  if (vec) {
    lamb_dir_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(pp, gp, mp, vp, up, n, sp, hp);
  } else {
    lamb_dir_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(pp, gp, mp, vp, up, n, sp, hp);
  }
  return static_cast<int>(cudaGetLastError());
}
