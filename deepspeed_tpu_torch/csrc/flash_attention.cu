// Flash attention for Hopper: forward, dq and dk/dv over (B, S, H, D) tensors,
// with an optional additive bias and its gradient. The bfloat16 forward is
// flash_fwd.cu's register-resident kernel (ds_flash_fwd routes to it), and so
// are the bfloat16 dq and dk/dv, with or without a bias, and the bfloat16
// collapsed dq in flash_bwd.cu (ds_flash_bwd_dq, ds_flash_bwd_dkv and
// ds_flash_bwd_dq_collapsed route to them). This file holds the rest, whose
// design follows: the float32 forward, dq and dk/dv (with or without a bias)
// and collapsed dq, the collapsed dq's plan in both dtypes and the fixed-order
// reduce of its partials (the fp32 bodies are flash_fp32.cuh, instantiated
// here at D 32, 64 and 128 and in flash_fp32_wide.cu at D 80, 96 and 256,
// without a bias). The mask, the bias and masked_score live in
// flash_common.cuh.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (pallas_call at :185, via _flash_fwd; here in fp32, with or
// without a bias tile), _dq_kernel (:417, via _flash_bwd; here in fp32, where
// with a bias it writes dbias per program), _dq_kernel_collapsed (:456: dq
// plus dbias summed over the programs that share a bias slice; here in fp32,
// and the plan and reduce of both dtypes),
// _dkv_kernel (:485: dk/dv with the bias tile; here in fp32) and
// _dkv_kernel_gqa (:518; here in fp32). The masked score is the reference's _scores:
// s = (q.k) * scale + slope * key_pos + bias, masked to kNegInf outside the
// causal (and sliding-window) band, with queries aligned to the END of the keys
// (offset = Sk - Sq). The bias is added before masking, so a masked entry is
// exactly kNegInf whatever the bias (an evoformer mask bias of -1e9 is finite
// and stays a score). masked_score (flash_common.cuh) is the one definition
// every kernel uses.
//
// What bounds it: in fp32 the products, at 67 TFLOP/s without the tensor
// cores (the forward does 4*S^2/2*D flops per causal head against reading q,
// k, v and writing o once; dq and dk/dv do 3 and 4 products). The design
// keeps the S x S scores out of device memory, as the TPU kernel did:
// - The TPU grid walked key blocks in order and carried the softmax state in
//   VMEM. Here a block owns a tile of 16*NW query rows (forward, dq) or key
//   rows (dk/dv) and walks the other sequence in a loop inside the block.
// - Each warp owns 16 rows of the block's tile outright: it computes its
//   stripe of scores, its softmax, and its stripe of the output, so only the
//   staging of a shared tile needs a block barrier.
// - dk/dv works on the transposed problem (key rows against query columns:
//   S^T = K Q^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q), so the same two
//   warp products serve all three kernels. It loops over the n_rep query heads
//   of its KV head inside the block and accumulates dK/dV in fp32 in shared
//   memory: no atomics, and the result does not depend on scheduling.
// - The products are plain fp32 FMA loops (the same arithmetic as the
//   reference). Accumulators live in shared memory, which lets each lane
//   rescale its rows by the online-softmax correction.
// - Any Sq and Sk: rows past the end are zero-filled in shared memory and
//   masked, so a zero weight never meets NaN; no divisibility is required.
// - lse and delta are (B, H, Sq) fp32, without the TPU's 128-lane padding.
// - The bias is fp32, flat (Bb*Hb, Sqb, Sk) with Sqb 1 or Sq and any Sk; a
//   program (b, h) reads slice (Bb > 1 ? b / repeat : 0) * Hb + (Hb > 1 ? h : 0)
//   (the reference's _bias_bh_fn). Forward and dq read it straight from device
//   memory, lane by lane along a row (coalesced, no alignment needed); dk/dv,
//   whose lanes run along query rows, stages each (query x key) bias tile in
//   shared memory with coalesced loads first.
// - dbias without atomics and without expanding a collapsed bias: a dq block
//   owns its region of dbias outright. When programs share a slice, the
//   collapsed kernel's block walks a chunk of the sharing programs in a loop
//   (as dk/dv walks a group's heads) and adds each program's dlogits into its
//   own fp32 partial; a row shared by every query row (Sqb == 1) gets each
//   warp's column sum over its 16 rows. The chunks exist to fill the card
//   (few slices give a small grid); a second kernel sums the partials in a
//   fixed order, so dbias repeats bit for bit from run to run.
// Not yet, for the fp32 bodies here: scores in registers, a cp.async ring and
// compile-time mask bodies (as flash_fwd.cu and flash_bwd.cu), wgmma, TMA.
#include "flash_fp32.cuh"

#include <algorithm>

namespace dstorch {
namespace {

// Collapsed dq (fp32; bf16 in flash_bwd.cu). Grid (ceil(Sq / BM), n_bh
// slices, n_chunks); n_rep = B*H / n_bh programs share each slice, and chunk c
// walks programs [c * per, min(n_rep, (c + 1) * per)) of it. Its partial: MODE kDbiasRows (Sqb == Sq)
// rows [q0, q0 + BM) of part[c] (n_chunks, n_bh, Sq, Sk); MODE kDbiasCols
// (Sqb == 1) one row per warp, part[(c * n_qt + qt) * NW + warp] of
// (n_parts, n_bh, 1, Sk).
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(Geo<T, D>::NT)
flash_dq_collapsed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ slopes, Bias bias,
                          T* __restrict__ dq, float* __restrict__ part, int H, int KVH, int n_rep, int per, Mask mk) {
  using G = Geo<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, s = blockIdx.y, c = blockIdx.z, q0 = qt * G::BM;
  const int n_bh = gridDim.y;
  const float* bs = bias.p + static_cast<size_t>(s) * bias.Sqb * mk.sk;
  float* dst;
  size_t wstride = 0;
  if (MODE == kDbiasRows) {
    dst = part + ((static_cast<size_t>(c) * n_bh + s) * mk.sq + q0) * mk.sk;
  } else {
    dst = part + ((static_cast<size_t>(c) * gridDim.x + qt) * G::NW * n_bh + s) * mk.sk;
    wstride = static_cast<size_t>(n_bh) * mk.sk;
  }
  const int r0 = c * per, r1 = min(n_rep, r0 + per);
  for (int rep = r0; rep < r1; ++rep) {
    const int prog = sharing_program(bias, s, rep, H);
    const int b = prog / H, h = prog % H;
    dq_tile<T, D, MODE>(smem, q, k, v, dout, lse, delta, slopes != nullptr ? slopes[h] : 0.f, bs, bias.Sqb, dq, dst,
                        wstride, rep == r0, b, h, q0, H, KVH, mk);
  }
}

// dbias[i] = sum over p of part[p][i], p in order: the fixed-order sum of the partials.
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias, size_t n,
                                    int n_parts) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < n_parts; ++p) acc += part[static_cast<size_t>(p) * n + i];
    dbias[i] = acc;
  }
}

// ---------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *slopes;
  void *o, *out_lse, *dq, *dk, *dv;
  float *dbias, *parts;
  Bias bias;
  int B, Sq, Sk, H, KVH;
  Mask mk;
  cudaStream_t stream;
};

enum Pass { kFwd = 0, kDq = 1, kDkv = 2, kDqCollapsed = 3 };

template <typename T>
int plan_collapsed(const Args& a, CollapsedPlan* pl) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                  cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  int rows, warps;
  if constexpr (sizeof(T) == 2) {
    flash_dq_collapsed_bf16_geometry(&rows, &warps);
  } else {
    warps = Tiles<T>::NW;
    rows = 16 * warps;
  }
  pl->n_qt = (a.Sq + rows - 1) / rows;
  pl->n_bh = a.bias.Bb * a.bias.Hb;
  pl->n_rep = a.B * a.H / pl->n_bh;
  // at most half the sharing programs a chunk: the partials (n_chunks slices of Sqb rows each) then stay
  // below the expanded (B*H, Sq, Sk) size
  const long long base = static_cast<long long>(pl->n_qt) * pl->n_bh;
  const int cap = std::max(1, pl->n_rep / 2);
  int want = 1;
  if constexpr (sizeof(T) == 2) {
    // flash_bwd.cu's body runs one block an SM: the chunk count whose grid finishes first, counted in waves
    // of `per` programs each (the fewest chunks among equals, which keeps the partials few)
    long long best = -1;
    for (int c = 1; c <= std::min(cap, 8 * sms); ++c) {
      const int per = (pl->n_rep + c - 1) / c, chunks = (pl->n_rep + per - 1) / per;
      const long long cost = (base * chunks + sms - 1) / sms * per;
      if (best < 0 || cost < best) {
        best = cost;
        want = c;
      }
    }
  } else {  // chunks enough for about two blocks per SM
    want = static_cast<int>(std::min<long long>(cap, std::max(1LL, (2LL * sms + base - 1) / base)));
  }
  pl->per = (pl->n_rep + want - 1) / want;
  pl->n_chunks = (pl->n_rep + pl->per - 1) / pl->per;
  pl->n_parts = pl->n_chunks * (a.bias.Sqb == 1 ? pl->n_qt * warps : 1);
  if (pl->n_bh > 65535 || pl->n_chunks > 65535) return kUnsupported;
  return 0;
}

template <typename T, int D, bool HAS_BIAS>
int launch_dkv(const Args& a) {
  using G = Geo<T, D>;
  auto kernel = flash_dkv_kernel<T, D, HAS_BIAS>;
  const size_t smem = G::dkv + (HAS_BIAS ? G::tileB : 0);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sk + G::BM - 1) / G::BM, a.KVH, a.B);
  kernel<<<grid, G::NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.slopes), a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KVH, a.mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(Pass pass, const Args& a) {
  using G = Geo<T, D>;
  const float* sl = static_cast<const float*>(a.slopes);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (pass == kFwd) {
    if constexpr (sizeof(T) == 2) {  // bf16: the register-resident body of flash_fwd.cu
      return flash_fwd_bf16(q, k, v, sl, a.bias, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.B, a.H,
                            a.KVH, D, a.mk, a.stream);
    } else {
      auto kernel = a.bias.p != nullptr ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
      if ((err = allow_smem(kernel, G::fwd)) != cudaSuccess) return static_cast<int>(err);
      dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
      kernel<<<grid, G::NT, G::fwd, a.stream>>>(q, k, v, sl, a.bias, static_cast<T*>(a.o),
                                                static_cast<float*>(a.out_lse), a.H, a.KVH, a.mk);
    }
  } else if (pass == kDq) {
    if constexpr (sizeof(T) == 2) {  // bf16, with or without a bias: the register-resident bodies of flash_bwd.cu
      return flash_dq_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), a.dbias, a.B, a.H, a.KVH,
                           D, a.mk, a.stream);
    } else {
      dim3 grid((a.Sq + G::BM - 1) / G::BM, a.H, a.B);
      auto kernel = a.dbias != nullptr ? flash_dq_kernel<T, D, kDbiasRows> : flash_dq_kernel<T, D, kNoDbias>;
      if ((err = allow_smem(kernel, G::dq)) != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, G::NT, G::dq, a.stream>>>(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), a.dbias,
                                               a.H, a.KVH, a.mk);
    }
  } else if (pass == kDqCollapsed) {
    CollapsedPlan pl;
    int rc = plan_collapsed<T>(a, &pl);
    if (rc != 0) return rc;
    if ((pl.n_parts > 1) != (a.parts != nullptr)) return kUnsupported;
    float* part = pl.n_parts > 1 ? a.parts : a.dbias;
    if constexpr (sizeof(T) == 2) {  // bf16: the register-resident body of flash_bwd.cu
      rc = flash_dq_collapsed_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, D,
                                   a.mk, pl, a.stream);
      if (rc != 0) return rc;
    } else {
      dim3 grid(pl.n_qt, pl.n_bh, pl.n_chunks);
      if (a.bias.Sqb == 1) {
        if ((err = allow_smem(flash_dq_collapsed_kernel<T, D, kDbiasCols>, G::dq)) != cudaSuccess)
          return static_cast<int>(err);
        flash_dq_collapsed_kernel<T, D, kDbiasCols><<<grid, G::NT, G::dq, a.stream>>>(
            q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, pl.n_rep, pl.per, a.mk);
      } else {
        if ((err = allow_smem(flash_dq_collapsed_kernel<T, D, kDbiasRows>, G::dq)) != cudaSuccess)
          return static_cast<int>(err);
        flash_dq_collapsed_kernel<T, D, kDbiasRows><<<grid, G::NT, G::dq, a.stream>>>(
            q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), part, a.H, a.KVH, pl.n_rep, pl.per, a.mk);
      }
    }
    if (pl.n_parts > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      const size_t n = static_cast<size_t>(pl.n_bh) * a.bias.Sqb * a.Sk;
      const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
      dbias_reduce_kernel<<<blocks, 256, 0, a.stream>>>(a.parts, a.dbias, n, pl.n_parts);
    }
  } else if constexpr (sizeof(T) == 2) {  // bf16, with or without a bias: the register-resident body of flash_bwd.cu
    return flash_dkv_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B,
                          a.H, a.KVH, D, a.mk, a.stream);
  } else {
    return a.bias.p != nullptr ? launch_dkv<T, D, true>(a) : launch_dkv<T, D, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// D 80, 96 and 256 (the Hugging Face families' heads): the bodies without a bias; bf16 in flash_fwd_wide.cu,
// flash_dq_wide.cu and flash_dkv_wide.cu (through flash_fwd_bf16, flash_dq_bf16, flash_dkv_bf16), fp32 in
// flash_fp32_wide.cu. A bias, and so the collapsed dq, is refused there.
template <typename T>
int launch_wide(Pass pass, int D, const Args& a) {
  if (a.bias.p != nullptr || pass == kDqCollapsed) return kUnsupported;
  const float* sl = static_cast<const float*>(a.slopes);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if constexpr (sizeof(T) == 2) {
    if (pass == kFwd)
      return flash_fwd_bf16(q, k, v, sl, a.bias, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.B, a.H,
                            a.KVH, D, a.mk, a.stream);
    if (pass == kDq)
      return flash_dq_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dq), nullptr, a.B, a.H, a.KVH,
                           D, a.mk, a.stream);
    return flash_dkv_bf16(q, k, v, dout, lse, delta, sl, a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B,
                          a.H, a.KVH, D, a.mk, a.stream);
  } else {
    if (pass == kFwd)
      return flash_fwd_f32_wide(q, k, v, sl, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.B, a.H, a.KVH,
                                D, a.mk, a.stream);
    if (pass == kDq)
      return flash_dq_f32_wide(q, k, v, dout, lse, delta, sl, static_cast<T*>(a.dq), a.B, a.H, a.KVH, D, a.mk,
                               a.stream);
    return flash_dkv_f32_wide(q, k, v, dout, lse, delta, sl, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.H,
                              a.KVH, D, a.mk, a.stream);
  }
}

template <typename T>
int dispatch_d(Pass pass, int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(pass, a);
    case 64: return launch<T, 64>(pass, a);
    case 128: return launch<T, 128>(pass, a);
    case 80:
    case 96:
    case 256: return launch_wide<T>(pass, D, a);
    default: return kUnsupported;
  }
}

bool bias_fits(const Args& a) {
  const Bias& b = a.bias;
  if (b.p == nullptr) return a.dbias == nullptr;
  return (b.Sqb == 1 || b.Sqb == a.Sq) && (b.Hb == 1 || b.Hb == a.H) && b.repeat >= 1 &&
         (b.Bb == 1 ? b.repeat == 1 : b.Bb * b.repeat == a.B);
}

int run(Pass pass, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.B > 65535 || a.H > 65535 || !bias_fits(a)) return kUnsupported;
  if (pass == kDqCollapsed && (a.bias.p == nullptr || a.dbias == nullptr)) return kUnsupported;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.o, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return kUnsupported;
  if (dtype == kBFloat16) return dispatch_d<bf16>(pass, D, a);
  if (dtype == kFloat32) return dispatch_d<float>(pass, D, a);
  return kUnsupported;
}

Args make_args(const void* q, const void* k, const void* v, const void* slopes, const void* bias, int Bb, int Hb,
               int Sqb, int repeat, int B, int Sq, int Sk, int H, int KVH, float scale, int causal, int window,
               void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.slopes = slopes;
  a.bias = Bias{static_cast<const float*>(bias), Bb, Hb, Sqb, repeat};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KVH = KVH;
  a.mk = Mask{Sq, Sk, Sk - Sq, causal, causal ? window : 0, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace
}  // namespace dstorch

// q (B, Sq, H, D); k, v (B, Sk, KVH, D); all of `dtype`, contiguous. slopes: (H,)
// fp32 ALiBi slopes or null. bias: fp32 (Bb*Hb, Sqb, Sk) or null (then Bb, Hb,
// Sqb, repeat are 1). o like q; lse (B, H, Sq) fp32. window 0 = none.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* slopes, const void* bias,
                            int Bb, int Hb, int Sqb, int repeat, void* o, void* lse, int B, int Sq, int Sk, int H,
                            int KVH, int D, float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.o = o;
  a.out_lse = lse;
  return run(kFwd, D, dtype, a);
}

// dout like q; lse, delta (B, H, Sq) fp32 (delta = rowsum(o * dout)). dq like q.
// dbias: given exactly when a bias is, which nothing may collapse (Bb*Hb ==
// B*H, Sqb == Sq): the (B*H, Sq, Sk) fp32 dlogits of every program.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, const void* slopes, const void* bias, int Bb, int Hb, int Sqb,
                               int repeat, void* dq, void* dbias, int B, int Sq, int Sk, int H, int KVH, int D,
                               float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  if ((dbias != nullptr) != (bias != nullptr) || (dbias != nullptr && (Bb * Hb != B * H || Sqb != Sq)))
    return kUnsupported;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias);
  return run(kDq, D, dtype, a);
}

// The number of fp32 partials of dbias, each (Bb*Hb, Sqb, Sk), that
// ds_flash_bwd_dq_collapsed needs in `parts` on the current device (1: none,
// parts is null); negative for a configuration it does not take.
extern "C" int ds_flash_dq_collapsed_parts(int B, int Sq, int H, int Bb, int Hb, int Sqb, int dtype) {
  using namespace dstorch;
  if (B <= 0 || Sq <= 0 || H <= 0 || Bb <= 0 || Hb <= 0 || (B * H) % (Bb * Hb) != 0) return kUnsupported;
  Args a{};
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.bias = Bias{nullptr, Bb, Hb, Sqb, 1};
  CollapsedPlan pl;
  int rc = dtype == kBFloat16 ? plan_collapsed<bf16>(a, &pl) : dtype == kFloat32 ? plan_collapsed<float>(a, &pl)
                                                                                 : kUnsupported;
  return rc != 0 ? (rc > 0 ? -rc : rc) : pl.n_parts;
}

// dq like q, and dbias (Bb*Hb, Sqb, Sk) fp32 summed over the B*H / (Bb*Hb)
// programs that share each bias slice (and over the query rows when Sqb == 1).
// parts: the scratch ds_flash_dq_collapsed_parts asks for.
extern "C" int ds_flash_bwd_dq_collapsed(const void* q, const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, const void* slopes, const void* bias,
                                         void* dq, void* dbias, void* parts, int B, int Sq, int Sk, int H, int KVH,
                                         int D, float scale, int causal, int window, int Bb, int Hb, int Sqb,
                                         int repeat, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias);
  a.parts = static_cast<float*>(parts);
  return run(kDqCollapsed, D, dtype, a);
}

// dk, dv like k: each summed over the H / KVH query heads of its KV head.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* slopes, const void* bias, int Bb, int Hb, int Sqb,
                                int repeat, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
                                float scale, int causal, int window, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, slopes, bias, Bb, Hb, Sqb, repeat, B, Sq, Sk, H, KVH, scale, causal, window, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, D, dtype, a);
}

