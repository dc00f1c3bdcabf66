// Fused AdamW for Hopper: one launch updates every leaf of a param group.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py::_adam_kernel
// (pallas_call at :51, via fused_adam_flat), which the JAX engine calls on each
// leaf inside one jit-compiled step:
//   g' = g * grad_mult
//   m' = b1 m + (1 - b1) g'        v' = b2 v + (1 - b2) g'^2
//   p' = p - lr (m' / bc1 / (sqrt(v' / bc2) + eps) + wd p)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t. p, m and v are updated in place.
// lr, bc1, bc2, the gradient multiplier (inverse loss scale times the clip
// coefficient) and the finite flag come from a small device tensor, as the TPU
// kernel read its scalars from SMEM: a step needs no host sync, and a step
// whose gradients overflowed writes nothing.
//
// What bounds it: 28 bytes per element (read p, g, m, v; write p, m, v) and
// about 15 flops, so memory: gpt2_1_3b's 1.31e9 elements in 388 leaves move
// 36.8 GB, 11 ms at 3.35 TB/s. A launch per leaf pays a launch and a tail wave
// for each of them, 242 of which hold at most 16,384 elements. The design:
// - One launch for up to kMaxLeaves leaves. Their pointers, sizes and first
//   tiles form a table passed by value as a __grid_constant__ kernel
//   parameter (CUDA 12.1 and later take 32,764 bytes of parameters), so a
//   launch copies nothing to the device first and can be captured in a CUDA
//   graph. The table is built at every launch: the gradients move each step.
// - One block a tile of kTile elements (a leaf's last tile may be short), in
//   the leaves' order; a block finds its leaf by a binary search over the
//   tiles' prefix. The blocks in flight sweep the leaves together, as a
//   plain elementwise kernel sweeps one array. A persistent grid that split
//   the tiles into equal ranges, one a block, keeps a range open in every
//   array for each block: on an H100 SXM (80 GB HBM3, 700 W) it moved 2.84
//   TB/s against this design's 3.02 (adam_probe.py, variant "persistent").
// - kUnroll independent 16-byte vectors of each array a thread, all loaded
//   before any is stored. Cache hints (g on the no-allocate read-only path, p,
//   m and v evict-first) and L2 prefetch sizes change nothing measurable.
// - A leaf whose four pointers are not all 16-byte aligned takes a scalar path
//   in the same launch, as do the n % 4 elements after a leaf's last vector.
#include <limits.h>

#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors of each array a thread holds in flight
constexpr int kTile = kThreads * kUnroll * 4;  // elements a block updates
constexpr int kMaxLeaves = 512;  // leaves one launch takes (TABLE_LEAVES in ops/fused_adam.py)

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once from double on the host
};

// The leaves of one launch: 512 x 44 bytes + 8, within the 32,764 bytes of kernel parameters.
struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int tile0[kMaxLeaves + 1];  // first tile of each leaf; tile0[leaves] = the tiles of all
  int leaves;
};

struct Step {
  float lr, bc1, bc2, mult;
};

__device__ __forceinline__ float4 load4(const float* a) { return *reinterpret_cast<const float4*>(a); }
__device__ __forceinline__ void store4(float* a, float4 x) { *reinterpret_cast<float4*>(a) = x; }

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Step& s, const Hyper& hp) {
  g *= s.mult;
  m = hp.b1 * m + hp.omb1 * g;
  v = hp.b2 * v + hp.omb2 * g * g;
  const float u = (m / s.bc1) / (sqrtf(v / s.bc2) + hp.eps) + hp.wd * p;
  p = p - s.lr * u;
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g, float4& m, float4& v, const Step& s,
                                          const Hyper& hp) {
  adam_one(p.x, g.x, m.x, v.x, s, hp);
  adam_one(p.y, g.y, m.y, v.y, s, hp);
  adam_one(p.z, g.z, m.z, v.z, s, hp);
  adam_one(p.w, g.w, m.w, v.w, s, hp);
}

// kUnroll vectors of each array from element e0 (this thread's first), kThreads * 4 elements apart; FULL: all
// of them lie below n4 * 4.
template <bool FULL>
__device__ __forceinline__ void tile_vectors(float* p, const float* g, float* m, float* v, long long e0, long long n4,
                                             const Step& s, const Hyper& hp) {
  float4 pp[kUnroll], gg[kUnroll], mm[kUnroll], vv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = e0 + 4LL * u * kThreads;
    if (FULL || e < 4 * n4) {
      pp[u] = load4(p + e);
      gg[u] = load4(g + e);
      mm[u] = load4(m + e);
      vv[u] = load4(v + e);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = e0 + 4LL * u * kThreads;
    if (FULL || e < 4 * n4) {
      adam_four(pp[u], gg[u], mm[u], vv[u], s, hp);
      store4(p + e, pp[u]);
      store4(m + e, mm[u]);
      store4(v + e, vv[u]);
    }
  }
}

__device__ __forceinline__ void adam_element(float* p, const float* g, float* m, float* v, long long e,
                                             const Step& s, const Hyper& hp) {
  float pp = p[e], mm = m[e], vv = v[e];
  adam_one(pp, g[e], mm, vv, s, hp);
  p[e] = pp;
  m[e] = mm;
  v[e] = vv;
}

// The leaf that holds tile `tile`: the last one whose first tile is at most `tile` (an empty leaf shares its
// first tile with the next one, so the search passes over it).
__device__ __forceinline__ int leaf_of(const Table& t, int tile) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.tile0[mid] <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Tile `tile` of leaf `leaf`.
__device__ __forceinline__ void adam_tile(const Table& t, int leaf, int tile, const Step& s, const Hyper& hp) {
  float* p = t.p[leaf];
  const float* g = t.g[leaf];
  float* m = t.m[leaf];
  float* v = t.v[leaf];
  const long long n = t.n[leaf];
  const long long base = static_cast<long long>(tile - t.tile0[leaf]) * kTile;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if ((bits & 15u) == 0) {
    const long long n4 = n / 4;
    const long long e0 = base + 4LL * threadIdx.x;
    if (base + kTile <= n) {
      tile_vectors<true>(p, g, m, v, e0, n4, s, hp);
    } else {  // the leaf's last tile: vectors below n4 * 4, then single elements
      tile_vectors<false>(p, g, m, v, e0, n4, s, hp);
      if (threadIdx.x < n - 4 * n4) adam_element(p, g, m, v, 4 * n4 + threadIdx.x, s, hp);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 4 * kUnroll; ++u) {
      const long long e = base + static_cast<long long>(u) * kThreads + threadIdx.x;
      if (e < n) adam_element(p, g, m, v, e, s, hp);
    }
  }
}

// scal: [lr, bc1, bc2, grad_mult, finite]. Block b updates tile b.
__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Table t, const float* __restrict__ scal, const Hyper hp) {
  if (scal[4] == 0.f) return;  // overflow: skip the step
  const Step s{scal[0], scal[1], scal[2], scal[3]};
  const int tile = blockIdx.x;
  adam_tile(t, leaf_of(t, tile), tile, s, hp);
}

}  // namespace
}  // namespace dstorch

// ptrs: 4 x leaves addresses (p, g, m, v of leaf 0, then of leaf 1, ...), each leaf sizes[i] contiguous fp32
// elements; scal: 5 fp32 on the device (lr, 1 - b1^t, 1 - b2^t, gradient multiplier, finite flag). One launch
// for at most 512 leaves. Returns 0, kUnsupported, or the launch's cudaError_t.
extern "C" int ds_fused_adam_multi(const void* const* ptrs, const long long* sizes, int leaves, const void* scal,
                                   float b1, float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  using namespace dstorch;
  if (leaves < 0 || leaves > kMaxLeaves) return kUnsupported;
  Table t;
  long long tiles = 0;
  for (int i = 0; i < leaves; ++i) {
    if (sizes[i] < 0) return kUnsupported;
    t.p[i] = static_cast<float*>(const_cast<void*>(ptrs[4 * i]));
    t.g[i] = static_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = static_cast<float*>(const_cast<void*>(ptrs[4 * i + 2]));
    t.v[i] = static_cast<float*>(const_cast<void*>(ptrs[4 * i + 3]));
    t.n[i] = sizes[i];
    t.tile0[i] = static_cast<int>(tiles);
    tiles += (sizes[i] + kTile - 1) / kTile;
    if (tiles > INT_MAX) return kUnsupported;
  }
  t.tile0[leaves] = static_cast<int>(tiles);
  t.leaves = leaves;
  if (tiles == 0) return 0;
  adam_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(scal), Hyper{b1, omb1, b2, omb2, eps, wd});
  return static_cast<int>(cudaGetLastError());
}
