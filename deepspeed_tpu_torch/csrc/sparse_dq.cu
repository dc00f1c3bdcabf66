// The bfloat16 block-sparse attention dq for Hopper: dq of a static block layout from q, k, v, dout
// (B, S, H, D), the forward's lse and delta = rowsum(o * dout) (B, H, S), over the plan of the kidx lists
// that the forward walks (sparse_self_attention.py's query_plan).
//
// Replaces, for bf16, the TPU kernel _sp_dq_kernel of deepspeed_tpu/ops/sparse_attention/
// sparse_self_attention.py (pallas_call at :222, via _sp_bwd). The float32 dq stays in sparse_attention.cu,
// which routes bf16 here. The arithmetic is that kernel's: s = (q.k) scale, p = exp(s - lse), masked on a
// causal run only inside the diagonal block, dp = dout v, ds = p (dp - delta) scale rounded to bf16,
// dq = ds k over the active blocks.
//
// What bounds it: 6 P D flops (three products) for the layout's P active pairs against reading q, k, v,
// dout once and writing dq: the tensor cores at the layouts users run (0.21 ms at gpt2_1_3b's heads, S 8192,
// the Fixed layout), the bytes only at Longformer's thin windows at D 128.
//
// The design (flash_bwd.cu's dq on mma.sync, over sparse_walk.cuh's walk, the forward's):
// - A CUDA block of 4 warps owns 64 query rows of neighbouring query blocks of one head and walks the union
//   of their lists; every warp shares each staged tile and skips a sub-tile that holds none of its member's
//   entries. The plan lists the longest walks first.
// - A step stages 64 keys (K and V), each row's address from its walk entry, through a ring of 2 stages
//   filled by cp.async (zeros past the walk's end), with one block barrier a step. Q and dO come in once;
//   their fragments are read from shared memory at each sub-tile (held in registers they leave too few for
//   the three products' accumulators).
// - A warp's S = Q K^T and dP = dO V^T are mma.sync m16n8k16 products in registers over a sub-tile of KS keys;
//   dS = P (dP - delta) scale goes from their C fragments to dQ += dS K as bf16 A fragments, K read by the
//   transposing ldmatrix. dQ is an fp32 register accumulator. Nothing else goes through shared memory.
// - p = 2^x by one ex2.approx, x = q.k scale log2(e) - lse log2(e) one FFMA.
// - Mask arithmetic only where a mask can act: the masked body (a compile-time copy) only for a sub-tile
//   holding another member's entry, the walk's end or a chunk the causal diagonal cuts. A row with no active
//   key (lse = kNegInf) has no valid chunk and is never multiplied: its dq is 0.
// - No walk is split and there are no atomics: dq repeats bit for bit.
// Not yet: wgmma, TMA, a persistent grid, splitting long walks.
#include "sparse_walk.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using namespace sparse_walk;

template <int D>
struct SpDqGeo {
  static constexpr int STAGES = 2;
  static constexpr int KS = 64;                       // keys a sub-tile
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr bool QREG = false;                 // Q's and dO's fragments read from shared memory at each use
  static constexpr int LD = D + 8;                    // +16 bytes: ldmatrix rows on distinct banks
  static constexpr size_t q_bytes = static_cast<size_t>(kBM) * LD * 2;
  static constexpr size_t kv_bytes = static_cast<size_t>(kBN) * LD * 2;
  static constexpr size_t smem = 2 * q_bytes + STAGES * 2 * kv_bytes + kRecBytes;  // Q, dO, the stages, the record
};

// Grid (n_items * B): x = item * B + batch row.
template <int D>
__global__ void __launch_bounds__(kNT, SpDqGeo<D>::MIN_BLOCKS)
sparse_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ items, const unsigned* __restrict__ entries, bf16* __restrict__ dq,
                      int B, int S, int H, int blk, int causal, float scale) {
  using G = SpDqGeo<D>;
  constexpr int LD = G::LD, KS = G::KS, KD = D / 16, NS = KS / 8, NO = D / 8, ST = G::STAGES, CPS = KS / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + G::q_bytes);
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + 2 * G::q_bytes + (2 * s) * G::kv_bytes); };
  auto sV = [&](int s) { return reinterpret_cast<bf16*>(smem + 2 * G::q_bytes + (2 * s + 1) * G::kv_bytes); };
  int* sRec = reinterpret_cast<int*>(smem + 2 * G::q_bytes + ST * 2 * G::kv_bytes);
  unsigned* sE = reinterpret_cast<unsigned*>(smem + G::smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int b = static_cast<int>(blockIdx.x % B);
  const Walk w = begin_walk(items, entries, B, blk, sRec, sE);
  const float scale2 = scale * kLog2e;

  load_rows<D, LD>(sQ, q, b, S, H, w.h, sRec, blk);
  load_rows<D, LD>(sdO, dout, b, S, H, w.h, sRec, blk);
  for (int i = 0; i < ST - 1; ++i) {  // one group a stage (Q and dO with the first), empty past the walk's end
    if (i < w.n_steps) load_step<D, LD>(sK(i), sV(i), k, v, b, S, H, w, i);
    cp_async_commit();
  }

  RowFrags<KD, G::QREG> qf, df;
  qf.init(sQ + 16 * warp * LD, LD);
  df.init(sdO + 16 * warp * LD, LD);
  // this lane's rows w.qw + g + 8 r, r in {0, 1}: lse log2(e) and delta
  float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f};
  if (w.mrow >= 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = (static_cast<size_t>(b) * H + w.h) * S + w.qw + g + 8 * r;
      lse_r[r] = lse[at] * kLog2e;
      dlt_r[r] = delta[at];
    }
  }
  float dqacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[j][e] = 0.f;

  for (int t = 0; t < w.n_steps; ++t) {
    const int s = t % ST;
    cp_async_wait<ST - 2>();
    __syncthreads();  // step t (and Q, dO) landed for every thread; every warp is done with step t - 1
    if (t + ST - 1 < w.n_steps) load_step<D, LD>(sK((t + ST - 1) % ST), sV((t + ST - 1) % ST), k, v, b, S, H, w,
                                                 t + ST - 1);  // into step t - 1's stage
    cp_async_commit();
    if (w.mrow < 0) continue;  // a member the group does not have: the warp only stages
    if (t == 0) {
      qf.load();
      df.load();
    }
    const StepMask sm(w, t, causal);
    const bf16* ks = sK(s);
    const bf16* vs = sV(s);
#pragma unroll
    for (int sub = 0; sub < kBN / KS; ++sub) {
      const unsigned chunks = (1u << CPS) - 1u, valid = (sm.valid >> (sub * CPS)) & chunks;
      if (valid == 0u) continue;  // none of the sub-tile's keys is the member's
      float sacc[NS][4], pacc[NS][4];  // S = Q K^T and dP = dO V^T
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4], da[4];
        qf.get(kd, qa);
        df.get(kd, da);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int off = (sub * KS + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, ks + off);
          mma_bf16(sacc[2 * np], qa, r[0], r[1]);
          mma_bf16(sacc[2 * np + 1], qa, r[2], r[3]);
          ldsm_x4(r, vs + off);
          mma_bf16(pacc[2 * np], da, r[0], r[1]);
          mma_bf16(pacc[2 * np + 1], da, r[2], r[3]);
        }
      }
      // dS = p (dp - delta) scale on the fragments, as dQ's A operand: 16 keys per k-step
      uint32_t dsa[NS / 2][4];
      auto form_ds = [&](auto masked_tag) {
        constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sacc[j][e], scale2, -lse_r[e >> 1]));
            if (MASKED && sm.masked(w.qw + g + (e < 2 ? 0 : 8), sub * CPS + (j >> 1), (j & 1) * 8 + t2 + (e & 1)))
              p = 0.f;
            ds[e] = p * (pacc[j][e] - dlt_r[e >> 1]) * scale;
          }
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (valid == chunks && ((sm.cut >> (sub * CPS)) & chunks) == 0u) {
        form_ds(std::false_type{});
      } else {
        form_ds(std::true_type{});
      }
      // dQ += dS K
#pragma unroll
      for (int kb = 0; kb < NS / 2; ++kb)
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, ks + (sub * KS + kb * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(dqacc[2 * dp], dsa[kb], r[0], r[1]);
          mma_bf16(dqacc[2 * dp + 1], dsa[kb], r[2], r[3]);
        }
    }
  }
  cp_async_wait<0>();
  if (w.mrow < 0) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* drow = dq + ((static_cast<size_t>(b) * S + w.qw + g + 8 * r) * H + w.h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(drow + j * 8 + t2) = pack_bf16(dqacc[j][2 * r], dqacc[j][2 * r + 1]);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* delta,
           const int* plan, int n_items, int max_entries, bf16* dq, int B, int S, int H, int blk, int causal,
           float scale, cudaStream_t stream) {
  using G = SpDqGeo<D>;
  if (static_cast<long long>(n_items) * B > 0x7fffffffLL) return kUnsupported;
  const unsigned* entries = reinterpret_cast<const unsigned*>(plan + static_cast<size_t>(n_items) * kIW);
  const size_t smem = G::smem + static_cast<size_t>(max_entries) * 4;
  if (smem > 232448) return kUnsupported;
  const cudaError_t err = allow_smem(sparse_dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0)
    sparse_dq_bf16_kernel<D><<<n_items * B, kNT, smem, stream>>>(q, k, v, dout, lse, delta, plan, entries, dq, B, S,
                                                                 H, blk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int sparse_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                   const float* delta, const int* plan, int n_items, int max_entries, int rows, bf16* dq, int B,
                   int S, int H, int D, int blk, int causal, float scale, cudaStream_t stream) {
  if (plan == nullptr || rows != kBM || n_items < 0 || max_entries < 0) return kUnsupported;
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, plan, n_items, max_entries, dq, B, S, H, blk, causal,
                               scale, stream);
    case 64: return launch<64>(q, k, v, dout, lse, delta, plan, n_items, max_entries, dq, B, S, H, blk, causal,
                               scale, stream);
    case 128: return launch<128>(q, k, v, dout, lse, delta, plan, n_items, max_entries, dq, B, S, H, blk, causal,
                                 scale, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
