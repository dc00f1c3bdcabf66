// The bfloat16 paged decode and the fixed-order combine of split partials, as
// templates (the design notes are paged_decode.cu's). paged_decode.cu
// instantiates the decode at D 64 and 128 and the combine at every D,
// paged_decode_wide.cu the decode at D 80, 96 and 256, so that nvcc builds the
// two halves in parallel.
#pragma once

#include "mma.cuh"
#include "paged.cuh"

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// W 32-bit words from device memory (16-, 8- or 32-byte aligned), through the read-only path.
template <int W>
__device__ __forceinline__ void ldg_words(uint32_t (&w)[W], const void* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
    static_assert(W == 2, "8-byte or 16-byte multiples");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  }
}

// The elements held in W words -> floats: bf16 pairs (low half first) or int8 codes (their integer values).
template <typename KT, int W>
__device__ __forceinline__ void words_to_float(const uint32_t (&w)[W], float* f) {
  if constexpr (sizeof(KT) == 2) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) f[4 * i + k] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * k)) & 0xffu));
  }
}

// 2^(x - y) for two values in the partials' units: log2 without ALiBi, natural with it.
template <bool NATURAL>
__device__ __forceinline__ float exp_diff(float x, float y) {
  return NATURAL ? fast_exp2((x - y) * kLog2e) : fast_exp2(x - y);
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Grid (splits, KVH x chunks of MAXG query heads, B), 128 threads.
template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedArgs a) {
  constexpr bool Q8 = sizeof(KT) == 1;
  constexpr int E = (Q8 && MAXG <= 4) ? 16 : 8;  // elements of a key a lane holds
  constexpr int LPR = D / E;                      // lanes that hold a slice of a key
  constexpr int LPK = pow2_at_least(LPR);         // lanes of a key, the idle ones included
  constexpr int KPW = 32 / LPK;                   // keys a warp loads at once
  constexpr int W = E * static_cast<int>(sizeof(KT)) / 4;  // words a lane loads per key and tensor
  constexpr int U = MAXG >= 8 ? 2 : 4;            // loads in flight per lane and tensor
  constexpr int KPI = kWarps * KPW * U;           // keys a block takes per iteration
  static_assert(D % E == 0 && LPK <= 32, "a key's lanes fit the warp");
  __shared__ float sAcc[kWarps][MAXG][D];
  __shared__ float sM[kWarps][MAXG], sL[kWarps][MAXG];

  const int GA = a.H / a.KVH;                // query heads of a KV head
  const int nch = (GA + MAXG - 1) / MAXG;    // chunks of MAXG of them
  const int j = blockIdx.x, h = blockIdx.y / nch, g0 = (blockIdx.y % nch) * MAXG, b = blockIdx.z;
  const int G = min(MAXG, GA - g0);          // this block's heads: g0 .. g0 + G - 1 of the group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = lane / LPK, sub = lane % LPK;
  const bool on = sub < LPR;                 // a lane that holds a slice (LPK > LPR pads with idle lanes)
  const int ctx = min(max(a.ctx[b], 0), a.P * a.bs);
  int k_lo = j * a.split_keys;
  const int k_hi = min(k_lo + a.split_keys, ctx);
  if constexpr (WINDOW) k_lo = max(k_lo, ctx - a.window);  // the query at ctx - 1 sees keys > ctx - 1 - window
  const size_t row0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(h) * GA + g0;  // output row of head g = 0
  bf16* out = static_cast<bf16*>(a.out);
  const size_t rows = static_cast<size_t>(a.B) * a.H;
  if (k_lo >= k_hi) {  // no visible key in this split
    if (a.splits == 1) {
      for (int i = tid; i < G * D; i += kThreads) out[row0 * D + i] = __float2bfloat16(0.f);
    } else if (tid < G) {
      float* ml = partial_ml(a, rows) + ((row0 + tid) * a.splits + j) * 2;
      ml[0] = kNegInf;
      ml[1] = 0.f;
    }
    return;
  }

  // q's slice of each query head, scaled (and by log2(e) without ALiBi: scores in log2 units)
  const float qs = ALIBI ? a.scale : a.scale * kLog2e;
  float qf[MAXG][E];
  float sl[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    sl[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    if (g < G) {
      if (on) {
        uint32_t w[E / 2];
        ldg_words<E / 2>(w, static_cast<const bf16*>(a.q) + (row0 + g) * D + sub * E);
        words_to_float<bf16, E / 2>(w, qf[g]);
#pragma unroll
        for (int e = 0; e < E; ++e) qf[g][e] *= qs;
      }
      if constexpr (ALIBI) sl[g] = a.slopes[h * GA + g0 + g];
    }
  }

  const int* bt = a.bt + static_cast<size_t>(b) * a.P;
  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = k_lo; base < k_hi; base += KPI) {
    uint32_t kw[U][W], vw[U][W];
    float ksc[U], vsc[U];
    int kpos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // issue every load first
      kpos[u] = base + (u * kWarps + warp) * KPW + grp;
      ksc[u] = vsc[u] = 0.f;
      if (kpos[u] < k_hi) {
        const int p = kpos[u];
        const size_t slot = (static_cast<size_t>(bt[p / a.bs]) * a.bs + p % a.bs) * a.KVH + h;
        if (on) {
          ldg_words<W>(kw[u], kp + slot * D + sub * E);
          ldg_words<W>(vw[u], vp + slot * D + sub * E);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) kw[u][i] = vw[u][i] = 0u;
        }
        if constexpr (Q8) {
          ksc[u] = __ldg(a.kscale + slot);
          vsc[u] = __ldg(a.vscale + slot);
        }
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) kw[u][i] = vw[u][i] = 0u;
      }
    }
    float s[U][MAXG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      words_to_float<KT, W>(kw[u], kf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int o = LPK / 2; o >= 1; o >>= 1) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        if constexpr (Q8) s[u][g] *= ksc[u];
        if constexpr (ALIBI) s[u][g] += sl[g] * static_cast<float>(kpos[u]);
        if (kpos[u] >= k_hi) s[u][g] = kNegInf;
      }
    float pw[U][MAXG];  // the weights, V scale included
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float al = exp_diff<ALIBI>(m[g], mx);
      m[g] = mx;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = kpos[u] < k_hi ? exp_diff<ALIBI>(s[u][g], mx) : 0.f;
        ps += p;
        pw[u][g] = Q8 ? p * vsc[u] : p;
      }
      l[g] = l[g] * al + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      words_to_float<KT, W>(vw[u], vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pw[u][g], vf[e], acc[g][e]);
    }
  }

  // merge the lane groups of the warp (the lanes with the same slice), then the warps, in a fixed order
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float w1 = exp_diff<ALIBI>(m[g], mx), w2 = exp_diff<ALIBI>(m2, mx);
      l[g] = l[g] * w1 + l2 * w2;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * w1 + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * w2;
    }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (on) {
#pragma unroll
        for (int e = 0; e < E; ++e) sAcc[warp][g][sub * E + e] = acc[g][e];
      }
      if (sub == 0) {
        sM[warp][g] = m[g];
        sL[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float mx = sM[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp_diff<ALIBI>(sM[w][g], mx);
      lt += wt * sL[w][g];
      o += wt * sAcc[w][g][c];
    }
    if (a.splits == 1) {
      out[(row0 + g) * D + c] = __float2bfloat16(lt > 0.f ? o / lt : 0.f);
    } else {
      a.ws[((row0 + g) * a.splits + j) * D + c] = o;
      if (c == 0) {
        float* ml = partial_ml(a, rows) + ((row0 + g) * a.splits + j) * 2;
        ml[0] = mx;
        ml[1] = lt;
      }
    }
  }
}

// One warp per output row: the splits' partials merged in split order. A lane
// owns D / 32 adjacent columns when D is a multiple of 64 (vector loads), else
// the columns lane + 32 c (D 80, 96).
template <int D, bool NATURAL>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(const PagedArgs a, int rows) {
  constexpr bool VEC = D % 64 == 0;
  constexpr int C = VEC ? D / 32 : (D + 31) / 32;  // columns a lane
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  auto col = [&](int c) { return VEC ? lane * C + c : lane + 32 * c; };
  const int n = a.splits;
  const float* ml = partial_ml(a, rows) + static_cast<size_t>(row) * n * 2;
  const float* acc = a.ws + static_cast<size_t>(row) * n * D;
  float mx = kNegInf;
  for (int j = 0; j < n; ++j)
    if (ml[2 * j + 1] > 0.f) mx = fmaxf(mx, ml[2 * j]);
  float lt = 0.f, o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float l = ml[2 * j + 1];
    if (!(l > 0.f)) continue;  // a split that saw no key contributes nothing
    const float w = exp_diff<NATURAL>(ml[2 * j], mx);
    lt += w * l;
    const float* src = acc + static_cast<size_t>(j) * D;
    float x[C];
    if constexpr (VEC && C == 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + lane * C);
      x[0] = v.x;
      x[1] = v.y;
    } else if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(src + lane * C + 4 * i);
        x[4 * i] = v.x;
        x[4 * i + 1] = v.y;
        x[4 * i + 2] = v.z;
        x[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = col(c) < D ? src[col(c)] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = fmaf(w, x[c], o[c]);
  }
  const float inv = lt > 0.f ? 1.f / lt : 0.f;  // a row no split saw writes zeros
  bf16* dst = static_cast<bf16*>(a.out) + static_cast<size_t>(row) * D;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < C; c += 2)
      *reinterpret_cast<uint32_t*>(dst + lane * C + c) = pack_bf16(o[c] * inv, o[c + 1] * inv);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col(c) < D) dst[col(c)] = __float2bfloat16(o[c] * inv);
  }
}

template <typename KT, int D, int MAXG, bool ALIBI, bool WINDOW>
int launch_decode(const PagedArgs& a, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<KT, D, MAXG, ALIBI, WINDOW>;
  const long long ys = static_cast<long long>(a.KVH) * ((a.H / a.KVH + MAXG - 1) / MAXG);
  if (ys > 65535) return kUnsupported;
  kernel<<<dim3(a.splits, static_cast<unsigned>(ys), a.B), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  return paged_combine_bf16(a, a.B * a.H, stream);
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
  return decode_by_features<KT, D, 8>(a, s);  // G > 8: chunks of 8 heads (the grid's y)
}

template <int D>
int decode_by_pool(const PagedArgs& a, cudaStream_t s) {
  return a.kscale != nullptr ? decode_by_group<int8_t, D>(a, s) : decode_by_group<bf16, D>(a, s);
}

template <int D, bool NATURAL>
int launch_combine(const PagedArgs& a, int rows, cudaStream_t s) {
  paged_combine_kernel<D, NATURAL><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(a, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int combine_by_units(const PagedArgs& a, int rows, cudaStream_t s) {
  return a.slopes != nullptr ? launch_combine<D, true>(a, rows, s) : launch_combine<D, false>(a, rows, s);
}

}  // namespace
}  // namespace dstorch
