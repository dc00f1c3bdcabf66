// Paged (block-table) KV attention for Hopper: the C entry points of decode
// and chunked prefill, and their float32 bodies.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/paged_attention.py::
// _decode_kernel (paged_attention_decode, pallas_call at :386) and
// ::_prefill_kernel (paged_attention_prefill, :531), each with its
// quantized=True body. The entry points send a bf16 q, on bf16 or int8
// pools, to the redesigned bodies of paged_decode.cu (flash-decoding: splits
// of the context in registers, then a fixed-order combine) and
// paged_prefill.cu (mma.sync tiles); a float32 q stays here. The pool
// layout, the masks and ALiBi are paged.cuh's.
//
// The float32 bodies: on the TPU the grid walked (row, page) in order and
// carried the online softmax state in VMEM scratch between grid steps. Here
// each block owns its rows outright and walks the pages itself in a loop,
// reading block_tables on its own (no scalar prefetch). Key tiles are staged
// in shared memory with a padded row stride (D + one 16-byte vector) so that
// 16-byte vector writes stay aligned and the row-strided reads of the score
// loop hit distinct banks. Softmax state and accumulators stay in fp32
// registers; plain FMA loops, no tensor cores. ALiBi (the score gains
// slope * key position before the mask) and the sliding window (tiles wholly
// before the band are skipped) are compile-time copies of each body.
//
// int8 pools (the reference's quantized=True bodies): pages hold int8 codes
// (N, bs, KVH, D) with one fp32 scale per slot and KV head in planes
// (N, bs, KVH). The kernels are templated on the pool's element type: codes are
// staged as they are, and the scales go next to the products: a key's score is
// its K scale times the dot product of q with the integer codes, and its V
// scale folds into its softmax weight before the PV product (the normaliser
// keeps the unscaled weight). That is exact in fp32. A slot that was never
// written has scale 0 and codes 0 and contributes nothing.
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

// ---------------------------------------------------------------- decode
// Grid (KVH, B), 128 threads. One block serves the G query heads that share
// KV head h of row b, so each K/V page is read from memory once per group.
// Per key tile of 128 positions: thread t scores key t against all G queries,
// the block reduces max and sum per query, and thread t accumulates output
// column t (and t + 128) for all G queries. The query sits at ctx - 1; with a
// window it sees keys > ctx - 1 - window, and the walk starts at the tile of
// the first of them.
template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const KT* __restrict__ kpool, const KT* __restrict__ vpool,
              const float* __restrict__ kscale, const float* __restrict__ vscale,
              const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
              const float* __restrict__ slopes, float* __restrict__ out, int H, int KVH, int G, int bs, int P,
              int window, float scale) {
  constexpr int NT = kThreads;
  constexpr bool Q8 = kIsInt8<KT>;
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int KS = D + VEC;
  constexpr int CPT = (D + NT - 1) / NT;  // output columns per thread
  constexpr int NWARP = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* sK = reinterpret_cast<KT*>(smem);
  KT* sV = sK + NT * KS;
  float* sQ = reinterpret_cast<float*>(sV + NT * KS);  // [MAXG][D], pre-scaled
  float* sP = sQ + MAXG * D;                           // [MAXG][NT]
  float* sRed = sP + MAXG * NT;                        // [NWARP][MAXG]
  float* sKs = sRed + NWARP * MAXG;                    // [NT] K scales of the tile (int8 pools only)
  float* sVs = sKs + NT;                               // [NT] V scales

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ctx = min(max(ctx_lens[b], 0), P * bs);
  const int* bt = block_tables + static_cast<size_t>(b) * P;

  for (int i = tid; i < MAXG * D; i += NT) {
    const int g = i / D;
    sQ[i] = g < G ? to_float(q[(static_cast<size_t>(b) * H + h * G + g) * D + i % D]) * scale : 0.f;
  }
  float m[MAXG], l[MAXG], acc[MAXG][CPT], sl[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    sl[g] = ALIBI && g < G ? slopes[h * G + g] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
  }

  const int k_lo = WINDOW ? max(ctx - window, 0) : 0;  // the first visible key
  for (int t0 = k_lo / NT * NT; t0 < ctx; t0 += NT) {
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    stage_kv<KT, D, KS>(sK, sV, kpool, vpool, bt, t0, NT, ctx, bs, KVH, h);
    if constexpr (Q8) stage_scales(sKs, sVs, kscale, vscale, bt, t0, NT, ctx, bs, KVH, h);
    __syncthreads();

    const bool live = t0 + tid < ctx && t0 + tid >= k_lo;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += VEC) {
      float kf[VEC];
      load_vec<VEC>(sK + tid * KS + c, kf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[g] = fmaf(sQ[g * D + c + j], kf[j], s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if constexpr (Q8) s[g] *= sKs[tid];
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
      sP[g * NT + tid] = Q8 ? p * sVs[tid] : p;  // the V scale rides on the weight; l sums the bare weight
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
    const int nk = min(NT, ctx - t0);
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
      if (col < D) out[(static_cast<size_t>(b) * H + h * G + g) * D + col] = acc[g][c] / lg;
    }
  }
}

template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
int launch_decode(const PagedArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr size_t smem = 2 * kThreads * (D + VEC) * sizeof(KT) +
                          (MAXG * D + MAXG * kThreads + (kThreads / 32) * MAXG + 2 * kThreads) * sizeof(float);
  auto kernel = decode_kernel<KT, D, MAXG, ALIBI, WINDOW>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(a.KVH, a.B);
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

template <typename KT, int D>
int decode_by_group(const PagedArgs& a, cudaStream_t s) {
  const int G = a.H / a.KVH;
  if (G <= 1) return decode_by_features<KT, D, 1>(a, s);
  if (G <= 2) return decode_by_features<KT, D, 2>(a, s);
  if (G <= 4) return decode_by_features<KT, D, 4>(a, s);
  if (G <= 8) return decode_by_features<KT, D, 8>(a, s);
  return kUnsupported;
}

template <int D>
int decode_by_pool(const PagedArgs& a, cudaStream_t s) {
  if (a.kscale != nullptr) return decode_by_group<int8_t, D>(a, s);
  return decode_by_group<float, D>(a, s);
}

// ---------------------------------------------------------------- prefill
// Grid (ceil(S / QT), KVH, B), 128 threads. A block owns R = QT * G score rows
// (QT query positions x the G heads of KV head h; row r = position r / G,
// head r % G) and walks key tiles of 64 up to the last key its rows can see,
// min(ctx, qpos_last + 1). Thread (ty, tx) = (tid / 8, tid % 8) computes a
// 4 x 8 score tile (rows 4ty.., keys tx + 8j) and accumulates a 4 x D/8 output
// tile (rows 4ty.., columns tx + 8c). The causal mask is on absolute
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

  const int QT = kRows / G;  // query positions per block
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * QT;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int ctx = min(max(ctx_lens[b], 0), P * bs);
  const int q0 = qpos0[b];
  const int s_end = min(S, s0 + QT);
  const int* bt = block_tables + static_cast<size_t>(b) * P;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, col = i % D;
    const int s = s0 + r / G;
    float v = 0.f;
    if (r < QT * G && s < s_end) v = to_float(q[((static_cast<size_t>(b) * S + s) * H + h * G + r % G) * D + col]) * scale;
    sQ[r * QS + col] = v;
  }

  float m[4], l[4], acc[4][CPT], sl[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q0 + s0 + (ty * 4 + i) / G;
    sl[i] = ALIBI ? slopes[h * G + (ty * 4 + i) % G] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(ctx, q0 + s_end);  // one past the last key any row of this block sees
  const int kbegin = WINDOW ? max(q0 + s0 - window + 1, 0) : 0;  // the first key any row of it sees
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
    const int r = ty * 4 + i;
    const int s = s0 + r / G;
    if (r < QT * G && s < s_end) {
      const float li = l[i] == 0.f ? 1.f : l[i];
      float* o = out + ((static_cast<size_t>(b) * S + s) * H + h * G + r % G) * D;
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
  const int G = a.H / a.KVH;
  if (G > kRows) return kUnsupported;
  auto kernel = prefill_kernel<KT, D, ALIBI, WINDOW>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int QT = kRows / G;
  dim3 grid((a.S + QT - 1) / QT, a.KVH, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(a.q), static_cast<const KT*>(a.k),
                                           static_cast<const KT*>(a.v), a.kscale, a.vscale, a.bt, a.ctx, a.qpos0,
                                           a.slopes, static_cast<float*>(a.out), a.S, a.H, a.KVH, G, a.bs, a.P, a.window,
                                           a.scale);
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

// Common checks of both entry points; false for what no body takes.
static bool pools_ok(const void* k_pages, const void* v_pages, const void* k_scales, const void* v_scales, int B,
                     int H, int KVH, int window) {
  return KVH > 0 && H % KVH == 0 && B <= 65535 && KVH <= 65535 && window >= 0 && dstorch::aligned16(k_pages) &&
         dstorch::aligned16(v_pages) && (k_scales == nullptr) == (v_scales == nullptr);
}

// q (B, H, D); pools (N, bs, KVH, D), 16-byte aligned: of q's dtype with k_scales = v_scales = null, or
// int8 codes with fp32 scale planes (N, bs, KVH); block_tables (B, P) and ctx_lens (B,) int32; slopes (H,)
// fp32 ALiBi slopes or null; window 0 (none) or the sliding window; out (B, H, D). D in {64, 128};
// H / KVH <= 8. bf16: `splits` ranges of `split_keys` keys (splits * split_keys >= P * bs) and, for
// splits > 1, a workspace of B H splits (D + 2) floats; float32 ignores both.
extern "C" int ds_paged_attention_decode(const void* q, const void* k_pages, const void* v_pages,
                                         const void* k_scales, const void* v_scales, const void* block_tables,
                                         const void* ctx_lens, const void* slopes, void* out, void* workspace, int B,
                                         int H, int KVH, int D, int bs, int P, int window, int splits,
                                         int split_keys, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0) return 0;
  if (!pools_ok(k_pages, v_pages, k_scales, v_scales, B, H, KVH, window)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a{q, k_pages, v_pages, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                    static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens), nullptr,
                    static_cast<const float*>(slopes), out, static_cast<float*>(workspace), B, 1, H, KVH, D, bs, P,
                    window, splits, split_keys, scale};
  if (dtype == kBFloat16) return paged_decode_bf16(a, s);
  if (dtype == kFloat32 && D == 128) return decode_by_pool<128>(a, s);
  if (dtype == kFloat32 && D == 64) return decode_by_pool<64>(a, s);
  return kUnsupported;
}

// q (B, S, H, D); pools, slopes and window as above; qpos0 (B,) int32 = absolute position of each row's
// query 0 (positions are consecutive); out (B, S, H, D). D in {64, 128}; H / KVH <= 64. bf16: the key
// tiles dealt round-robin to `splits` blocks and, for splits > 1, a workspace of B S H splits (D + 2)
// floats; float32 ignores both.
extern "C" int ds_paged_attention_prefill(const void* q, const void* k_pages, const void* v_pages,
                                          const void* k_scales, const void* v_scales, const void* block_tables,
                                          const void* ctx_lens, const void* qpos0, const void* slopes, void* out,
                                          void* workspace, int B, int S, int H, int KVH, int D, int bs, int P,
                                          int window, int splits, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0 || S <= 0) return 0;
  if (!pools_ok(k_pages, v_pages, k_scales, v_scales, B, H, KVH, window)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedArgs a{q, k_pages, v_pages, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                    static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens),
                    static_cast<const int*>(qpos0), static_cast<const float*>(slopes), out,
                    static_cast<float*>(workspace), B, S, H, KVH, D, bs, P, window, splits, 0, scale};
  if (dtype == kBFloat16) return paged_prefill_bf16(a, s);
  if (dtype == kFloat32 && D == 128) return prefill_by_pool<128>(a, s);
  if (dtype == kFloat32 && D == 64) return prefill_by_pool<64>(a, s);
  return kUnsupported;
}
