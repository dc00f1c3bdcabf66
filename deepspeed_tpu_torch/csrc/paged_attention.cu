// Paged (block-table) KV attention for Hopper: decode and chunked prefill.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/paged_attention.py::
// _decode_kernel (paged_attention_decode) and ::_prefill_kernel
// (paged_attention_prefill). The pool layout is the reference's:
// k/v pages (N, bs, KVH, D), block_tables (B, P) int32, ctx_lens (B,) int32
// counting every visible key; key position p of row b lives in pool block
// block_tables[b, p / bs] at slot p % bs.
//
// On the TPU the grid walked (row, page) in order and carried the online
// softmax state in VMEM scratch between grid steps. Here blocks run in
// parallel in no order, so each block owns its rows outright and walks the
// pages itself in a loop, reading block_tables on its own (no scalar
// prefetch). Key tiles are staged in shared memory with a padded row stride
// (D + one 16-byte vector) so that 16-byte vector writes stay aligned and the
// row-strided reads of the score loop hit distinct banks. Softmax state and
// accumulators stay in fp32 registers. Plain FMA loops; no tensor cores, TMA
// or warp specialisation yet.
#include "common.cuh"

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

// ---------------------------------------------------------------- decode
// Grid (KVH, B), 128 threads. One block serves the G query heads that share
// KV head h of row b, so each K/V page is read from memory once per group.
// Per key tile of 128 positions: thread t scores key t against all G queries,
// the block reduces max and sum per query, and thread t accumulates output
// column t (and t + 128) for all G queries.
template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
              const int* __restrict__ block_tables, const int* __restrict__ ctx_lens, T* __restrict__ out, int H,
              int KVH, int G, int bs, int P, float scale) {
  constexpr int NT = kThreads;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KS = D + VEC;
  constexpr int CPT = (D + NT - 1) / NT;  // output columns per thread
  constexpr int NWARP = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + NT * KS;
  float* sQ = reinterpret_cast<float*>(sV + NT * KS);  // [MAXG][D], pre-scaled
  float* sP = sQ + MAXG * D;                           // [MAXG][NT]
  float* sRed = sP + MAXG * NT;                        // [NWARP][MAXG]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ctx = min(max(ctx_lens[b], 0), P * bs);
  const int* bt = block_tables + static_cast<size_t>(b) * P;

  for (int i = tid; i < MAXG * D; i += NT) {
    const int g = i / D;
    sQ[i] = g < G ? to_float(q[(static_cast<size_t>(b) * H + h * G + g) * D + i % D]) * scale : 0.f;
  }
  float m[MAXG], l[MAXG], acc[MAXG][CPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
  }

  for (int t0 = 0; t0 < ctx; t0 += NT) {
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    stage_kv<T, D, KS>(sK, sV, kpool, vpool, bt, t0, NT, ctx, bs, KVH, h);
    __syncthreads();

    const bool live = t0 + tid < ctx;
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
      sP[g * NT + tid] = p;
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
      if (col < D) out[(static_cast<size_t>(b) * H + h * G + g) * D + col] = from_float<T>(acc[g][c] / lg);
    }
  }
}

template <typename T, int D, int MAXG>
int launch_decode(const void* q, const void* kp, const void* vp, const int* bt, const int* ctx, void* out, int B,
                  int H, int KVH, int bs, int P, float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr size_t smem = 2 * kThreads * (D + VEC) * sizeof(T) +
                          (MAXG * D + MAXG * kThreads + (kThreads / 32) * MAXG) * sizeof(float);
  auto kernel = decode_kernel<T, D, MAXG>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                           static_cast<const T*>(vp), bt, ctx, static_cast<T*>(out), H, KVH,
                                           H / KVH, bs, P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int decode_by_group(const void* q, const void* kp, const void* vp, const int* bt, const int* ctx, void* out, int B,
                    int H, int KVH, int bs, int P, float scale, cudaStream_t s) {
  const int G = H / KVH;
  if (G <= 1) return launch_decode<T, D, 1>(q, kp, vp, bt, ctx, out, B, H, KVH, bs, P, scale, s);
  if (G <= 2) return launch_decode<T, D, 2>(q, kp, vp, bt, ctx, out, B, H, KVH, bs, P, scale, s);
  if (G <= 4) return launch_decode<T, D, 4>(q, kp, vp, bt, ctx, out, B, H, KVH, bs, P, scale, s);
  if (G <= 8) return launch_decode<T, D, 8>(q, kp, vp, bt, ctx, out, B, H, KVH, bs, P, scale, s);
  return kUnsupported;
}

// ---------------------------------------------------------------- prefill
// Grid (ceil(S / QT), KVH, B), 128 threads. A block owns R = QT * G score rows
// (QT query positions x the G heads of KV head h; row r = position r / G,
// head r % G) and walks key tiles of 64 up to the last key its rows can see,
// min(ctx, qpos_last + 1). Thread (ty, tx) = (tid / 8, tid % 8) computes a
// 4 x 8 score tile (rows 4ty.., keys tx + 8j) and accumulates a 4 x D/8 output
// tile (rows 4ty.., columns tx + 8c). The causal mask is on absolute
// positions: query position = qpos0[b] + s, key visible when key < ctx and
// key <= query position. A row that sees no key writes zeros.
constexpr int kRows = 64;
constexpr int kKeyTile = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
               const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
               const int* __restrict__ qpos0, T* __restrict__ out, int S, int H, int KVH, int G, int bs, int P,
               float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KS = D + VEC;
  constexpr int QS = D + 1;
  constexpr int PS = kKeyTile + 1;
  constexpr int CPT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kKeyTile * KS;
  float* sQ = reinterpret_cast<float*>(sV + kKeyTile * KS);  // [kRows][QS], pre-scaled
  float* sP = sQ + kRows * QS;                               // [kRows][PS]

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

  float m[4], l[4], acc[4][CPT];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q0 + s0 + (ty * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(ctx, q0 + s_end);  // one past the last key any row of this block sees
  for (int t0 = 0; t0 < kend; t0 += kKeyTile) {
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    stage_kv<T, D, KS>(sK, sV, kpool, vpool, bt, t0, kKeyTile, ctx, bs, KVH, h);
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = t0 + tx + 8 * j;
        if (!(kpos < ctx && kpos <= qpos[i])) s[i][j] = kNegInf;
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
        sP[(ty * 4 + i) * PS + tx + 8 * j] = p;
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
      T* o = out + ((static_cast<size_t>(b) * S + s) * H + h * G + r % G) * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[tx + 8 * c] = from_float<T>(acc[i][c] / li);
    }
  }
}

template <typename T, int D>
int launch_prefill(const void* q, const void* kp, const void* vp, const int* bt, const int* ctx, const int* qpos0,
                   void* out, int B, int S, int H, int KVH, int bs, int P, float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr size_t smem = 2 * kKeyTile * (D + VEC) * sizeof(T) +
                          (kRows * (D + 1) + kRows * (kKeyTile + 1)) * sizeof(float);
  const int G = H / KVH;
  if (G > kRows) return kUnsupported;
  auto kernel = prefill_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int QT = kRows / G;
  dim3 grid((S + QT - 1) / QT, KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                           static_cast<const T*>(vp), bt, ctx, qpos0, static_cast<T*>(out), S, H,
                                           KVH, G, bs, P, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dstorch

// q (B, H, D); pools (N, bs, KVH, D) of q's dtype, 16-byte aligned; block_tables (B, P) and
// ctx_lens (B,) int32; out (B, H, D). D in {64, 128}; H / KVH <= 8.
extern "C" int ds_paged_attention_decode(const void* q, const void* k_pages, const void* v_pages,
                                         const void* block_tables, const void* ctx_lens, void* out, int B, int H,
                                         int KVH, int D, int bs, int P, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH || B > 65535 || !aligned16(k_pages) || !aligned16(v_pages)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  if (dtype == kBFloat16 && D == 128) return decode_by_group<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, cl, out, B, H, KVH, bs, P, scale, s);
  if (dtype == kBFloat16 && D == 64) return decode_by_group<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, cl, out, B, H, KVH, bs, P, scale, s);
  if (dtype == kFloat32 && D == 128) return decode_by_group<float, 128>(q, k_pages, v_pages, bt, cl, out, B, H, KVH, bs, P, scale, s);
  if (dtype == kFloat32 && D == 64) return decode_by_group<float, 64>(q, k_pages, v_pages, bt, cl, out, B, H, KVH, bs, P, scale, s);
  return kUnsupported;
}

// q (B, S, H, D); pools as above; qpos0 (B,) int32 = absolute position of each row's query 0
// (positions are consecutive); out (B, S, H, D). D in {64, 128}; H / KVH <= 64.
extern "C" int ds_paged_attention_prefill(const void* q, const void* k_pages, const void* v_pages,
                                          const void* block_tables, const void* ctx_lens, const void* qpos0,
                                          void* out, int B, int S, int H, int KVH, int D, int bs, int P, float scale,
                                          int dtype, void* stream) {
  using namespace dstorch;
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH || B > 65535 || KVH > 65535 || !aligned16(k_pages) || !aligned16(v_pages)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* qp = static_cast<const int*>(qpos0);
  if (dtype == kBFloat16 && D == 128) return launch_prefill<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, cl, qp, out, B, S, H, KVH, bs, P, scale, s);
  if (dtype == kBFloat16 && D == 64) return launch_prefill<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, cl, qp, out, B, S, H, KVH, bs, P, scale, s);
  if (dtype == kFloat32 && D == 128) return launch_prefill<float, 128>(q, k_pages, v_pages, bt, cl, qp, out, B, S, H, KVH, bs, P, scale, s);
  if (dtype == kFloat32 && D == 64) return launch_prefill<float, 64>(q, k_pages, v_pages, bt, cl, qp, out, B, S, H, KVH, bs, P, scale, s);
  return kUnsupported;
}
