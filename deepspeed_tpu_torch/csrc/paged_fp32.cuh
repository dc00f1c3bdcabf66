// The float32 bodies of the paged attention kernels (decode and chunked
// prefill of an fp32 q on fp32 or int8 pools), as templates over the pool's
// element type, the head dim and the features. paged_attention.cu instantiates
// them at D 64 and 128 beside the C entry points, paged_attention_wide.cu at D
// 80, 96 and 256, so that nvcc builds the two halves in parallel. The design
// notes are paged_attention.cu's.
#pragma once

#include "paged.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 128;

// Stage `rows` keys starting at position t0 of one KV head into shared memory
// (row stride KS elements); positions at or past ctx are zero-filled so that
// a masked key's zero weight never meets a NaN.
template <typename T, int D, int KS>
__device__ __forceinline__ void stage_kv(T* sK, T* sV, const T* __restrict__ kpool, const T* __restrict__ vpool,
                                         const int* __restrict__ bt, int t0, int rows, int ctx, int bs, int KVH,
                                         int h) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int kpos = t0 + r;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (kpos < ctx) {
      const int blk = bt[kpos / bs];
      const size_t off = ((static_cast<size_t>(blk) * bs + kpos % bs) * KVH + h) * D + c;
      kv = *reinterpret_cast<const uint4*>(kpool + off);
      vv = *reinterpret_cast<const uint4*>(vpool + off);
    }
    *reinterpret_cast<uint4*>(sK + r * KS + c) = kv;
    *reinterpret_cast<uint4*>(sV + r * KS + c) = vv;
  }
}

// The same tile's per-key scales of an int8 pool; 0 at or past ctx.
__device__ __forceinline__ void stage_scales(float* sKs, float* sVs, const float* __restrict__ kscale,
                                             const float* __restrict__ vscale, const int* __restrict__ bt, int t0,
                                             int rows, int ctx, int bs, int KVH, int h) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int kpos = t0 + r;
    float ks = 0.f, vs = 0.f;
    if (kpos < ctx) {
      const size_t off = (static_cast<size_t>(bt[kpos / bs]) * bs + kpos % bs) * KVH + h;
      ks = kscale[off];
      vs = vscale[off];
    }
    sKs[r] = ks;
    sVs[r] = vs;
  }
}

template <typename KT>
constexpr bool kIsInt8 = sizeof(KT) == 1;

// The fp32 decode's keys a tile: 128, or 64 where two tiles of 128 rows of D
// elements would not fit the shared memory (fp32 pools at D 256).
template <typename KT, int D>
__host__ __device__ constexpr int decode_tile_keys() {
  return D * static_cast<int>(sizeof(KT)) > 512 ? 64 : kThreads;
}

// ---------------------------------------------------------------- decode
// Grid (KVH x chunks of MAXG query heads, B), 128 threads. One block serves
// up to MAXG of the query heads that share KV head h of row b (a group of
// more than 8, falcon-7b's 71 on one KV head, takes ceil(G / 8) blocks, each
// reading the pages again), so each K/V page is read from memory once per
// chunk. Per key tile of NK positions (128; 64 for fp32 pools at D 256, whose
// two tiles of 128 would not fit the shared memory): thread t < NK scores key
// t against the chunk's queries, the block reduces max and sum per query, and
// thread t accumulates output columns t, t + 128, ... for them. The query sits
// at ctx - 1; with a window it sees keys > ctx - 1 - window, and the walk
// starts at the tile of the first of them.
template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const KT* __restrict__ kpool, const KT* __restrict__ vpool,
              const float* __restrict__ kscale, const float* __restrict__ vscale,
              const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
              const float* __restrict__ slopes, float* __restrict__ out, int H, int KVH, int GA, int bs, int P,
              int window, float scale) {
  constexpr int NT = kThreads;
  constexpr bool Q8 = kIsInt8<KT>;
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int KS = D + VEC;
  constexpr int NK = decode_tile_keys<KT, D>();  // keys a tile
  constexpr int CPT = (D + NT - 1) / NT;  // output columns per thread
  constexpr int NWARP = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* sK = reinterpret_cast<KT*>(smem);
  KT* sV = sK + NK * KS;
  float* sQ = reinterpret_cast<float*>(sV + NK * KS);  // [MAXG][D], pre-scaled
  float* sP = sQ + MAXG * D;                           // [MAXG][NT]
  float* sRed = sP + MAXG * NT;                        // [NWARP][MAXG]
  float* sKs = sRed + NWARP * MAXG;                    // [NT] K scales of the tile (int8 pools only)
  float* sVs = sKs + NT;                               // [NT] V scales

  const int nch = (GA + MAXG - 1) / MAXG;  // chunks of the group's GA query heads
  const int h = blockIdx.x / nch, g0 = (blockIdx.x % nch) * MAXG, b = blockIdx.y, tid = threadIdx.x;
  const int G = min(MAXG, GA - g0);        // this block's heads: g0 .. g0 + G - 1 of the group
  const int lane = tid & 31, warp = tid >> 5;
  const int ctx = min(max(ctx_lens[b], 0), P * bs);
  const int* bt = block_tables + static_cast<size_t>(b) * P;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(h) * GA + g0;  // (b, head g0) row

  for (int i = tid; i < MAXG * D; i += NT) {
    const int g = i / D;
    sQ[i] = g < G ? to_float(q[(head0 + g) * D + i % D]) * scale : 0.f;
  }
  float m[MAXG], l[MAXG], acc[MAXG][CPT], sl[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    sl[g] = ALIBI && g < G ? slopes[h * GA + g0 + g] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
  }

  const int k_lo = WINDOW ? max(ctx - window, 0) : 0;  // the first visible key
  for (int t0 = k_lo / NK * NK; t0 < ctx; t0 += NK) {
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    stage_kv<KT, D, KS>(sK, sV, kpool, vpool, bt, t0, NK, ctx, bs, KVH, h);
    if constexpr (Q8) stage_scales(sKs, sVs, kscale, vscale, bt, t0, NK, ctx, bs, KVH, h);
    __syncthreads();

    const bool live = tid < NK && t0 + tid < ctx && t0 + tid >= k_lo;
    const int key = min(tid, NK - 1);  // a thread past the tile scores its last key, masked
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += VEC) {
      float kf[VEC];
      load_vec<VEC>(sK + key * KS + c, kf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[g] = fmaf(sQ[g * D + c + j], kf[j], s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if constexpr (Q8) s[g] *= sKs[key];
      if constexpr (ALIBI) s[g] += sl[g] * static_cast<float>(t0 + tid);
      if (!live) s[g] = kNegInf;
      const float v = warp_max(s[g]);
      if (lane == 0) sRed[warp * MAXG + g] = v;
    }
    __syncthreads();
    float mnew[MAXG], alpha[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mt = sRed[g];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) mt = fmaxf(mt, sRed[w * MAXG + g]);
      mnew[g] = fmaxf(m[g], mt);
      alpha[g] = expf(m[g] - mnew[g]);
    }
    __syncthreads();  // sRed is reused for the sums below
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float p = live ? expf(s[g] - mnew[g]) : 0.f;
      sP[g * NT + tid] = Q8 ? p * sVs[key] : p;  // the V scale rides on the weight; l sums the bare weight
      const float ps = warp_sum(p);
      if (lane == 0) sRed[warp * MAXG + g] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) lt += sRed[w * MAXG + g];
      l[g] = l[g] * alpha[g] + lt;
      m[g] = mnew[g];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[g][c] *= alpha[g];
    }
    const int nk = min(NK, ctx - t0);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * NT;
      if (col < D) {
        for (int k = 0; k < nk; ++k) {
          const float vf = to_float(sV[k * KS + col]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) acc[g][c] = fmaf(sP[g * NT + k], vf, acc[g][c]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float lg = l[g] == 0.f ? 1.f : l[g];  // ctx == 0: the row writes zeros
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * NT;
      if (col < D) out[(head0 + g) * D + col] = acc[g][c] / lg;
    }
  }
}

template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
int launch_decode(const PagedArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr size_t smem = 2 * decode_tile_keys<KT, D>() * (D + VEC) * sizeof(KT) +
                          (MAXG * D + MAXG * kThreads + (kThreads / 32) * MAXG + 2 * kThreads) * sizeof(float);
  auto kernel = decode_kernel<KT, D, MAXG, ALIBI, WINDOW>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long xs = static_cast<long long>(a.KVH) * ((a.H / a.KVH + MAXG - 1) / MAXG);
  if (xs > 0x7fffffffLL) return kUnsupported;
  dim3 grid(static_cast<unsigned>(xs), a.B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(a.q), static_cast<const KT*>(a.k),
                                           static_cast<const KT*>(a.v), a.kscale, a.vscale, a.bt, a.ctx, a.slopes,
                                           static_cast<float*>(a.out), a.H, a.KVH, a.H / a.KVH, a.bs, a.P, a.window,
                                           a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int D, int MAXG>
int decode_by_features(const PagedArgs& a, cudaStream_t s) {
  const bool alibi = a.slopes != nullptr, window = a.window > 0;
  if (alibi && window) return launch_decode<KT, D, MAXG, true, true>(a, s);
  if (alibi) return launch_decode<KT, D, MAXG, true, false>(a, s);
  if (window) return launch_decode<KT, D, MAXG, false, true>(a, s);
  return launch_decode<KT, D, MAXG, false, false>(a, s);
}

// A body per group size of 1, 2, 4 and 8 at the llama family's D 64 and 128; at D 80, 96 and 256 (MHA
// phi, gpt-neox, gemma-7b and gpt-j, or gemma's groups) one for a group of 1 and one for up to 8, which halves
// what nvcc builds for them.
template <typename KT, int D>
int decode_by_group(const PagedArgs& a, cudaStream_t s) {
  const int G = a.H / a.KVH;
  if (G <= 1) return decode_by_features<KT, D, 1>(a, s);
  if constexpr (D == 64 || D == 128) {
    if (G <= 2) return decode_by_features<KT, D, 2>(a, s);
    if (G <= 4) return decode_by_features<KT, D, 4>(a, s);
  }
  return decode_by_features<KT, D, 8>(a, s);  // G > 8: chunks of 8 heads (a block)
}

template <int D>
int decode_by_pool(const PagedArgs& a, cudaStream_t s) {
  if (a.kscale != nullptr) return decode_by_group<int8_t, D>(a, s);
  return decode_by_group<float, D>(a, s);
}

// ---------------------------------------------------------------- prefill
// Grid (ceil(S G / 64), KVH, B), 128 threads. The S G score rows of KV head h
// (query position s and head h G + g at flat row f = s G + g) go 64 to a
// block: block x owns f in [64 x, 64 x + 64), any G. A block walks key tiles
// of 64 up to the last key its rows can see, min(ctx, qpos_last + 1).
// Thread (ty, tx) = (tid / 8, tid % 8) computes a 4 x 8 score tile (rows
// 4ty.., keys tx + 8j) and accumulates a 4 x D/8 output tile (rows 4ty..,
// columns tx + 8c). The causal mask is on absolute
// positions: query position = qpos0[b] + s, key visible when key < ctx,
// key <= query position and, with a window, key > query position - window
// (the walk starts at the tile of the first key the block's first query
// sees). A row that sees no key writes zeros.
constexpr int kRows = 64;
constexpr int kKeyTile = 64;

template <typename KT, int D, bool ALIBI, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const float* __restrict__ q, const KT* __restrict__ kpool, const KT* __restrict__ vpool,
               const float* __restrict__ kscale, const float* __restrict__ vscale,
               const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
               const int* __restrict__ qpos0, const float* __restrict__ slopes, float* __restrict__ out, int S, int H,
               int KVH, int G, int bs, int P, int window, float scale) {
  constexpr bool Q8 = kIsInt8<KT>;
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int KS = D + VEC;
  constexpr int QS = D + 1;
  constexpr int PS = kKeyTile + 1;
  constexpr int CPT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* sK = reinterpret_cast<KT*>(smem);
  KT* sV = sK + kKeyTile * KS;
  float* sQ = reinterpret_cast<float*>(sV + kKeyTile * KS);  // [kRows][QS], pre-scaled
  float* sP = sQ + kRows * QS;                               // [kRows][PS]
  float* sKs = sP + kRows * PS;                              // [kKeyTile] K scales of the tile (int8 pools only)
  float* sVs = sKs + kKeyTile;                               // [kKeyTile] V scales

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * kRows;                // the block's first flat row
  const int rows_valid = min(kRows, S * G - r0);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int ctx = min(max(ctx_lens[b], 0), P * bs);
  const int q0 = qpos0[b];
  const int* bt = block_tables + static_cast<size_t>(b) * P;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, col = i % D, f = r0 + r;
    float v = 0.f;
    if (r < rows_valid) v = to_float(q[((static_cast<size_t>(b) * S + f / G) * H + h * G + f % G) * D + col]) * scale;
    sQ[r * QS + col] = v;
  }

  float m[4], l[4], acc[4][CPT], sl[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q0 + (r0 + ty * 4 + i) / G;
    sl[i] = ALIBI ? slopes[h * G + (r0 + ty * 4 + i) % G] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(ctx, q0 + (r0 + rows_valid - 1) / G + 1);  // one past the last key any row of it sees
  const int kbegin = WINDOW ? max(q0 + r0 / G - window + 1, 0) : 0;  // the first key any row of it sees
  for (int t0 = kbegin / kKeyTile * kKeyTile; t0 < kend; t0 += kKeyTile) {
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    stage_kv<KT, D, KS>(sK, sV, kpool, vpool, bt, t0, kKeyTile, ctx, bs, KVH, h);
    if constexpr (Q8) stage_scales(sKs, sVs, kscale, vscale, bt, t0, kKeyTile, ctx, bs, KVH, h);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int col = 0; col < D; ++col) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + col];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_float(sK[(tx + 8 * j) * KS + col]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    float vs[8];  // V scales of this thread's keys: they ride on the weights below
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vs[j] = 1.f;
      if constexpr (Q8) {
        const float ks = sKs[tx + 8 * j];
        vs[j] = sVs[tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] *= ks;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = t0 + tx + 8 * j;
        if constexpr (ALIBI) s[i][j] += sl[i] * static_cast<float>(kpos);
        if (!(kpos < ctx && kpos <= qpos[i] && (!WINDOW || kpos > qpos[i] - window))) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      // the row's 64 keys live in the 8 lanes that share ty
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mnew = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mnew);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] <= kNegInf ? 0.f : expf(s[i][j] - mnew);  // no visible key yet: no weight
        sP[(ty * 4 + i) * PS + tx + 8 * j] = p * vs[j];
        ps += p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[i] = l[i] * alpha + ps;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int nk = min(kKeyTile, kend - t0);
    for (int k = 0; k < nk; ++k) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vf = to_float(sV[k * KS + tx + 8 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vf, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, f = r0 + r;
    if (r < rows_valid) {
      const float li = l[i] == 0.f ? 1.f : l[i];
      float* o = out + ((static_cast<size_t>(b) * S + f / G) * H + h * G + f % G) * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[tx + 8 * c] = acc[i][c] / li;
    }
  }
}

template <typename KT, int D, bool ALIBI, bool WINDOW>
int launch_prefill(const PagedArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr size_t smem = 2 * kKeyTile * (D + VEC) * sizeof(KT) +
                          (kRows * (D + 1) + kRows * (kKeyTile + 1) + 2 * kKeyTile) * sizeof(float);
  const long long rows = static_cast<long long>(a.S) * (a.H / a.KVH);
  if (rows > 0x7fffffffLL) return kUnsupported;
  auto kernel = prefill_kernel<KT, D, ALIBI, WINDOW>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), a.KVH, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(a.q), static_cast<const KT*>(a.k),
                                           static_cast<const KT*>(a.v), a.kscale, a.vscale, a.bt, a.ctx, a.qpos0,
                                           a.slopes, static_cast<float*>(a.out), a.S, a.H, a.KVH, a.H / a.KVH, a.bs,
                                           a.P, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int D>
int prefill_by_features(const PagedArgs& a, cudaStream_t s) {
  const bool alibi = a.slopes != nullptr, window = a.window > 0;
  if (alibi && window) return launch_prefill<KT, D, true, true>(a, s);
  if (alibi) return launch_prefill<KT, D, true, false>(a, s);
  if (window) return launch_prefill<KT, D, false, true>(a, s);
  return launch_prefill<KT, D, false, false>(a, s);
}

template <int D>
int prefill_by_pool(const PagedArgs& a, cudaStream_t s) {
  if (a.kscale != nullptr) return prefill_by_features<int8_t, D>(a, s);
  return prefill_by_features<float, D>(a, s);
}

}  // namespace
}  // namespace dstorch
