// The bfloat16 chunked prefill for Hopper: a chunk of consecutive query
// positions per row against the paged context, on bf16 or int8 pools, with
// optional ALiBi and a sliding window, on the tensor cores.
//
// Replaces, for a bf16 q, the TPU kernel deepspeed_tpu/ops/pallas/
// paged_attention.py::_prefill_kernel (:398, pallas_call at :531, via
// paged_attention_prefill), with its quantized=True body. The float32 body
// stays in paged_attention.cu.
//
// What bounds it: the products. At llama3_8b's heads (32 query heads on 8
// KV heads, D 128) a chunk of 2 x 512 queries, one row continuing a context
// of 1,000, has 24.8 M visible (query, key) pairs: 12.7 GFLOP, 0.0128 ms at
// 989 TFLOP/s, against 6 MB of K, V, q and out. The old kernel multiplied in
// fp32 FMA loops through shared memory (55x the bound).
//
// The design (flash_fwd.cu's, on mma.sync, over pages):
// - Rows. A block owns 64 score rows of one KV head, 4 warps of 16, packed
//   as row r = query position s0 + r / G and head h G + r % G, so each K/V
//   tile feeds all G heads of its KV head. S = Q K^T and O += P V are mma.sync
//   m16n8k16 products (bf16 in, fp32 accumulate) through ldmatrix; S, P and O
//   stay in registers, and P goes from the S accumulator to the A operand as
//   bf16 pairs.
// - Softmax on the fragments: a row lives in a quad, so its max and sum take
//   two xor shuffles; p = 2^x by ex2.approx. Without ALiBi m is the raw
//   score's maximum and x = s scale log2(e) - m scale log2(e) is one FFMA;
//   with ALiBi x = (s - m) log2(e), as flash_fwd.cu (log2(e) is not folded
//   into a score in the hundreds).
// - Tiles. K/V tiles of 64 keys come through a 2-stage ring in shared memory,
//   zero-filled at or past ctx; each tile row looks up its own page
//   (block_tables[kpos / bs]), so any bs works. bf16 pages come by cp.async
//   while the other stage multiplies.
// - int8 pools: the codes cross from device memory through registers (half
//   the bytes of a bf16 tile), loaded while the other stage multiplies, and
//   are converted to bf16 as they are stored into the stage: exact for
//   |code| <= 128 (an fp32 magic-number add and the high half of the float,
//   no conversion instruction). Converting once at the store, not in each of
//   the 4 warps' fragment loads, lets both pools share one ldmatrix/mma body.
//   The K scale multiplies the score column after the product, the V scale
//   multiplies p before p is rounded to bf16; l sums the bare p.
// - Masks on absolute positions: query position qpos0[b] + s; key visible
//   when key < ctx, key <= the query position and, with a window, key > the
//   query position - window. A warp skips a tile that no row of it sees and
//   takes the masked body only for a tile that a mask cuts for its rows; the
//   masked and unmasked bodies, ALiBi and the window are compile-time copies.
//   A row that sees no key keeps m = kNegInf, its p are selected to 0 before
//   any product, and it writes zeros.
// - Scheduling: the grid enumerates the last query tiles first.
// - Small chunks: when the grid has fewer blocks than SMs (2 x 16 queries at
//   llama3_8b's heads give 16), the wrapper's _prefill_plan deals each
//   block's key tiles round-robin to `splits` blocks, which write fp32
//   partials (m, l, acc) that paged_combine_kernel (paged_decode.cu) merges
//   in split order.
// Not yet: wgmma, TMA, a persistent grid.
#include "mma.cuh"
#include "paged.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // score rows a block
constexpr int kBN = 64;   // keys a tile
constexpr int kNT = 128;  // four warps of 16 rows

template <int D>
struct PrefillGeo {
  static constexpr int LD = D + 8;  // +16 bytes: ldmatrix rows on distinct banks
  static constexpr size_t q_bytes = static_cast<size_t>(kBM) * LD * 2;
  static constexpr size_t kv_bytes = static_cast<size_t>(kBN) * LD * 2;
  static constexpr size_t scale_bytes = 2 * kBN * sizeof(float);  // K and V scales of a stage (int8 pools)
  static constexpr size_t smem = q_bytes + 4 * kv_bytes + 2 * scale_bytes;
};

// The 4 int8 codes of a word -> their values as 2 bf16 pairs, exactly: the byte
// biased by 128 is the low mantissa of 2^23 + u, and 2^23 + 128 taken away
// leaves the code; an integer of 8 significant bits is the float's high half.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// Block x = (((n_qt - 1 - query tile) B + b) KVH + h) splits + split: the last query tiles first.
template <typename KT, int D, bool ALIBI, bool WINDOW>
__global__ void __launch_bounds__(kNT, 2) paged_prefill_kernel(const PagedArgs a, int n_qt) {
  using Geo = PrefillGeo<D>;
  constexpr bool Q8 = sizeof(KT) == 1;
  constexpr int LD = Geo::LD, KD = D / 16, NS = kBN / 8, NO = D / 8, VPR = D / 8;
  constexpr int C8 = kBN * (D / 16) / kNT;  // 16-code chunks a thread moves per tile and tensor (int8 pools)
  constexpr bool FOLD = !ALIBI;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + Geo::q_bytes + (2 * s) * Geo::kv_bytes); };
  auto sV = [&](int s) { return reinterpret_cast<bf16*>(smem + Geo::q_bytes + (2 * s + 1) * Geo::kv_bytes); };
  auto sKs = [&](int s) { return reinterpret_cast<float*>(smem + Geo::q_bytes + 4 * Geo::kv_bytes + s * Geo::scale_bytes); };
  auto sVs = [&](int s) { return sKs(s) + kBN; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t2 = (lane & 3) * 2;
  int x = blockIdx.x;
  const int js = x % a.splits;
  x /= a.splits;
  const int h = x % a.KVH;
  x /= a.KVH;
  const int b = x % a.B;
  const int qt = n_qt - 1 - x / a.B;
  const int G = a.H / a.KVH;
  const int QT = kBM / G;                   // query positions a block
  const int s0 = qt * QT;                   // the block's first query of the chunk
  const int nq = min(QT, a.S - s0);
  const int rows_valid = nq * G;            // score rows that are real (row r: query s0 + r / G, head h G + r % G)
  const int ctx = min(max(a.ctx[b], 0), a.P * a.bs);
  const int q0 = a.qpos0[b] + s0;           // absolute position of the block's first query
  const int wr = 16 * warp;                 // the warp's first row
  const bool warp_live = wr < rows_valid;
  const int qp_lo = q0 + wr / G, qp_hi = q0 + min(wr + 15, rows_valid - 1) / G;
  const float scale = a.scale, scale2 = a.scale * kLog2e;
  const int window = WINDOW ? a.window : 0;

  // this lane's rows wr + g8 + 8 i: their query positions and slopes
  int qp[2];
  float sl[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g8 + 8 * i;
    qp[i] = q0 + r / G;
    if constexpr (ALIBI) sl[i] = a.slopes[h * G + r % G];
  }

  // the key tiles any row of the block sees, and this split's share: kt_begin + js, + splits, ...
  const int last = min(ctx, q0 + nq) - 1;
  const int kt_end = last < 0 ? 0 : last / kBN + 1;
  const int kt_begin = WINDOW ? max(q0 - window + 1, 0) / kBN : 0;
  const int span = kt_end - kt_begin - js;
  const int n_it = span <= 0 ? 0 : (span + a.splits - 1) / a.splits;

  const bf16* q = static_cast<const bf16*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  const int* bt = a.bt + static_cast<size_t>(b) * a.P;
  for (int i = tid; i < kBM * VPR; i += kNT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < rows_valid;
    const size_t src = ((static_cast<size_t>(b) * a.S + s0 + r / G) * a.H + h * G + r % G) * D + c;
    cp_async16(sQ + r * LD + c, ok ? q + src : q, ok ? 16 : 0);
  }
  cp_async_commit();

  // the pool slot of key kpos (ok: kpos < ctx)
  auto slot_of = [&](int kpos) {
    return (static_cast<size_t>(bt[kpos / a.bs]) * a.bs + kpos % a.bs) * a.KVH + h;
  };
  auto load_bf16 = [&](int st, int kt) {  // cp.async of a bf16 tile into stage st
    const int k0 = kt * kBN;
    bf16* dk = sK(st);
    bf16* dv = sV(st);
    for (int i = tid; i < kBN * VPR; i += kNT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool ok = k0 + r < ctx;
      const size_t off = ok ? slot_of(k0 + r) * D + c : 0;
      cp_async16(dk + r * LD + c, reinterpret_cast<const bf16*>(kp) + off, ok ? 16 : 0);
      cp_async16(dv + r * LD + c, reinterpret_cast<const bf16*>(vp) + off, ok ? 16 : 0);
    }
  };
  // int8 pools: a tile's codes and scales into registers, then converted into stage st
  uint4 ck[C8], cv[C8];
  float ks_r = 0.f, vs_r = 0.f;
  auto fetch_int8 = [&](int kt) {
    const int k0 = kt * kBN;
#pragma unroll
    for (int i = 0; i < C8; ++i) {
      const int idx = tid + i * kNT, r = idx / (D / 16), c = (idx % (D / 16)) * 16;
      ck[i] = cv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < ctx) {
        const size_t off = slot_of(k0 + r) * D + c;
        ck[i] = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const int8_t*>(kp) + off));
        cv[i] = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const int8_t*>(vp) + off));
      }
    }
    ks_r = vs_r = 0.f;
    if (tid < kBN && k0 + tid < ctx) {
      const size_t sl_off = slot_of(k0 + tid);
      ks_r = __ldg(a.kscale + sl_off);
      vs_r = __ldg(a.vscale + sl_off);
    }
  };
  auto store_int8 = [&](int st) {
#pragma unroll
    for (int i = 0; i < C8; ++i) {
      const int idx = tid + i * kNT, r = idx / (D / 16), c = (idx % (D / 16)) * 16;
      const uint32_t kw[4] = {ck[i].x, ck[i].y, ck[i].z, ck[i].w}, vw[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
      uint32_t ko[8], vo[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        codes_to_bf16(kw[w], ko[2 * w], ko[2 * w + 1]);
        codes_to_bf16(vw[w], vo[2 * w], vo[2 * w + 1]);
      }
      uint4* dk = reinterpret_cast<uint4*>(sK(st) + r * LD + c);
      uint4* dv = reinterpret_cast<uint4*>(sV(st) + r * LD + c);
      dk[0] = make_uint4(ko[0], ko[1], ko[2], ko[3]);
      dk[1] = make_uint4(ko[4], ko[5], ko[6], ko[7]);
      dv[0] = make_uint4(vo[0], vo[1], vo[2], vo[3]);
      dv[1] = make_uint4(vo[4], vo[5], vo[6], vo[7]);
    }
    if (tid < kBN) {
      sKs(st)[tid] = ks_r;
      sVs(st)[tid] = vs_r;
    }
  };
  auto tile_of = [&](int it) { return kt_begin + js + it * a.splits; };
  if (n_it > 0) {
    if constexpr (Q8) {
      fetch_int8(tile_of(0));
      store_int8(0);
    } else {
      load_bf16(0, tile_of(0));
    }
  }
  cp_async_commit();

  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, kt = tile_of(it), k0 = kt * kBN;
    const bool more = it + 1 < n_it;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed for every thread; every warp is done with tile it - 1
    if constexpr (Q8) {
      if (more) fetch_int8(tile_of(it + 1));  // into registers while tile it multiplies
    } else {
      if (more) load_bf16(s ^ 1, tile_of(it + 1));  // into tile it - 1's stage, while tile it multiplies
      cp_async_commit();
    }
    // which keys of the tile the warp's rows see: all, some, or none
    bool none = !warp_live || k0 >= ctx || k0 > qp_hi;
    bool masked = k0 + kBN > ctx || k0 + kBN - 1 > qp_lo;
    if constexpr (WINDOW) {
      none = none || k0 + kBN - 1 <= qp_lo - window;
      masked = masked || k0 <= qp_hi - window;
    }
    if (!none) {
      float sacc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      const bf16* ksm = sK(s);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4];
        ldsm_x4(qa, sQ + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, ksm + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sacc[2 * np], qa, r[0], r[1]);
          mma_bf16(sacc[2 * np + 1], qa, r[2], r[3]);
        }
      }
      float2 kscl[NS], vscl[NS];  // int8 pools: the scales of this lane's two columns of each n8 block
      if constexpr (Q8) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          kscl[j] = *reinterpret_cast<const float2*>(sKs(s) + j * 8 + t2);
          vscl[j] = *reinterpret_cast<const float2*>(sVs(s) + j * 8 + t2);
        }
      }
      uint32_t pa[NS / 2][4];  // P as the A operand of P V: 16 keys per k-step
      auto softmax = [&](auto masked_tag) {
        constexpr bool MASKED = decltype(masked_tag)::value;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + t2 + (e & 1);
            float sv = sacc[j][e];
            if constexpr (Q8) sv *= (e & 1) ? kscl[j].y : kscl[j].x;
            if constexpr (!FOLD) sv = sv * scale + sl[e >> 1] * static_cast<float>(col);
            if constexpr (MASKED) {
              const int p = qp[e >> 1];
              const bool vis = col < ctx && col <= p && (!WINDOW || col > p - window);
              sv = vis ? sv : kNegInf;
            }
            sacc[j][e] = sv;
            mx[e >> 1] = fmaxf(mx[e >> 1], sv);
          }
        float mn[2], ms[2], al[2], ps[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mn[r] = fmaxf(m_r[r], quad_max(mx[r]));
          ms[r] = __fmul_rn(mn[r], scale2);
          al[r] = FOLD ? fast_exp2(__fmul_rn(m_r[r], scale2) - ms[r]) : fast_exp2((m_r[r] - mn[r]) * kLog2e);
          m_r[r] = mn[r];
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (FOLD) {
              p[e] = fast_exp2(fmaf(sacc[j][e], scale2, -ms[e >> 1]));
            } else {
              p[e] = fast_exp2((sacc[j][e] - mn[e >> 1]) * kLog2e);
            }
            if (MASKED && sacc[j][e] <= kNegInf) p[e] = 0.f;
          }
          ps[0] += p[0] + p[1];
          ps[1] += p[2] + p[3];
          if constexpr (Q8) {  // the V scale rides on the weight; l sums the bare weight
            p[0] *= vscl[j].x;
            p[1] *= vscl[j].y;
            p[2] *= vscl[j].x;
            p[3] *= vscl[j].y;
          }
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * al[r] + ps[r];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          oacc[j][0] *= al[0];
          oacc[j][1] *= al[0];
          oacc[j][2] *= al[1];
          oacc[j][3] *= al[1];
        }
      };
      if (masked) {
        softmax(std::true_type{});
      } else {
        softmax(std::false_type{});
      }
      const bf16* vsm = sV(s);
#pragma unroll
      for (int kb = 0; kb < NS / 2; ++kb)
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, vsm + (kb * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(oacc[2 * dp], pa[kb], r[0], r[1]);
          mma_bf16(oacc[2 * dp + 1], pa[kb], r[2], r[3]);
        }
    }
    if constexpr (Q8) {
      if (more) store_int8(s ^ 1);  // stage s ^ 1 was last read in tile it - 1, before this tile's barrier
    }
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
  const size_t rows = static_cast<size_t>(a.B) * a.S * a.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g8 + 8 * r;
    const float l = quad_sum(l_r[r]);
    if (row >= rows_valid) continue;
    const size_t orow = (static_cast<size_t>(b) * a.S + s0 + row / G) * a.H + h * G + row % G;
    if (a.splits == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);  // a row that sees no key writes zeros
      bf16* o = out + orow * D;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(o + j * 8 + t2) = pack_bf16(oacc[j][2 * r] * inv, oacc[j][2 * r + 1] * inv);
    } else {
      const size_t part = orow * a.splits + js;
      if (n_it > 0) {
        float* o = a.ws + part * D;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<float2*>(o + j * 8 + t2) = make_float2(oacc[j][2 * r], oacc[j][2 * r + 1]);
      }
      if ((lane & 3) == 0) {
        float* ml = partial_ml(a, rows) + part * 2;
        ml[0] = FOLD ? __fmul_rn(m_r[r], scale2) : m_r[r];  // the combine's units: log2, or natural with ALiBi
        ml[1] = l;
      }
    }
  }
}

template <typename KT, int D, bool ALIBI, bool WINDOW>
int launch_prefill(const PagedArgs& a, int n_qt, cudaStream_t stream) {
  auto kernel = paged_prefill_kernel<KT, D, ALIBI, WINDOW>;
  const cudaError_t attr = allow_smem(kernel, PrefillGeo<D>::smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(n_qt) * a.B * a.KVH * a.splits;
  if (blocks > 0x7fffffffLL) return kUnsupported;
  kernel<<<static_cast<unsigned>(blocks), kNT, PrefillGeo<D>::smem, stream>>>(a, n_qt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  return paged_combine_bf16(a, a.B * a.S * a.H, stream);
}

template <typename KT, int D>
int prefill_by_features(const PagedArgs& a, int n_qt, cudaStream_t s) {
  const bool alibi = a.slopes != nullptr, window = a.window > 0;
  if (alibi && window) return launch_prefill<KT, D, true, true>(a, n_qt, s);
  if (alibi) return launch_prefill<KT, D, true, false>(a, n_qt, s);
  if (window) return launch_prefill<KT, D, false, true>(a, n_qt, s);
  return launch_prefill<KT, D, false, false>(a, n_qt, s);
}

}  // namespace

int paged_prefill_bf16(const PagedArgs& a, cudaStream_t s) {
  const int G = a.H / a.KVH;
  if (G > kBM || a.splits < 1 || (a.splits > 1 && a.ws == nullptr) || !aligned16(a.q)) return kUnsupported;
  const int QT = kBM / G;
  const int n_qt = (a.S + QT - 1) / QT;
  const bool q8 = a.kscale != nullptr;
  if (a.D == 128) return q8 ? prefill_by_features<int8_t, 128>(a, n_qt, s) : prefill_by_features<bf16, 128>(a, n_qt, s);
  if (a.D == 64) return q8 ? prefill_by_features<int8_t, 64>(a, n_qt, s) : prefill_by_features<bf16, 64>(a, n_qt, s);
  return kUnsupported;
}

}  // namespace dstorch
