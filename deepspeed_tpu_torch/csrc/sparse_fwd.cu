// The bfloat16 block-sparse attention forward for Hopper: o and lse of a static block layout from q, k, v
// (B, S, H, D), over a plan of the kidx lists (the key blocks each query block attends) that
// sparse_self_attention.py's query_plan works out on the host once per configuration.
//
// Replaces, for bf16, the TPU kernel _sp_fwd_kernel of deepspeed_tpu/ops/sparse_attention/
// sparse_self_attention.py (pallas_call at :193, via _sp_fwd). The float32 forward stays in
// sparse_attention.cu, which routes bf16 here; the bf16 dq is sparse_dq.cu, the dk/dv sparse_dkv.cu. The
// arithmetic is that kernel's: s = (q.k) scale over the active blocks, masked on a causal run only inside
// the diagonal block (a key after its query), the online softmax, p rounded to bf16 before P V. lse is
// natural-log; a row with no active key writes o = 0 and lse = kNegInf, as the plain version
// (sparse_fwd_ref) does.
//
// What bounds it: 4 P D flops (two products) for the layout's P active pairs against reading q, k, v once
// and writing o and lse: at the layouts users run (a quarter to a twentieth of S^2, D 64-128) the tensor
// cores (0.14 ms at gpt2_1_3b's heads, S 8192, the Fixed layout), the bytes only at Longformer's thin
// windows at D 128. What stands between the layout and that bound is each step's overhead around the two
// products: at the default block of 16 a query block is one warp's rows, and a list entry 16 keys.
//
// The design (flash_fwd.cu's forward on mma.sync, over sparse_walk.cuh's walk):
// - A CUDA block of 4 warps owns 64 query rows: 64 / min(blk, 64) neighbouring query blocks of one head
//   (or 64 rows of a block of 128). Their lists are nearly the same (one local window, the same global
//   columns), so the block walks their union and every warp shares each staged tile; a warp skips a step
//   that holds none of its member's entries. The plan lists the longest walks first.
// - A step stages 64 keys (K and V): the next 64 / blk walk entries, or 64 keys of a block of 128, each
//   row's address from its entry, through a ring of 2 stages filled by cp.async (zeros past the walk's end)
//   while the other multiplies, with one block barrier a step. Q comes in once, and its fragments stay in
//   registers for the whole walk.
// - S = Q K^T and O += P V are mma.sync m16n8k16 products; S's C fragments become P's A fragments (bf16
//   pairs), V is read by the transposing ldmatrix, O is an fp32 register accumulator. The online softmax
//   runs on the fragments: a row lives in the 4 lanes of a quad (two xor shuffles for its max and sum), l
//   is summed per lane and reduced once at the end. Nothing else goes through shared memory.
// - p = 2^x by one ex2.approx, x = q.k scale log2(e) - m scale log2(e) one FFMA, with m the raw q.k maximum
//   (the max commutes with the positive scale, so lse's m scale rounds as the plain version's m).
// - Mask arithmetic only where a mask can act: the masked body (a compile-time copy) only for a step holding
//   another member's entry, the walk's end or a chunk the causal diagonal cuts; else the unmasked body.
// - No walk is split (the longest at the cases of chip_smoke.py is 64 steps) and there are no atomics: o
//   and lse repeat bit for bit.
// Not yet: wgmma, TMA, a persistent grid, splitting long walks.
#include "sparse_walk.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using namespace sparse_walk;

template <int D>
struct SpFwdGeo {
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr bool QREG = true;  // Q's fragments held in registers for the whole walk
  static constexpr int LD = D + 8;    // +16 bytes: ldmatrix rows on distinct banks
  static constexpr size_t q_bytes = static_cast<size_t>(kBM) * LD * 2;
  static constexpr size_t kv_bytes = static_cast<size_t>(kBN) * LD * 2;
  static constexpr size_t smem = q_bytes + STAGES * 2 * kv_bytes + kRecBytes;  // Q, the stages, the record
};

// Grid (n_items * B): x = item * B + batch row.
template <int D>
__global__ void __launch_bounds__(kNT, SpFwdGeo<D>::MIN_BLOCKS)
sparse_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const int* __restrict__ items, const unsigned* __restrict__ entries, bf16* __restrict__ o,
                       float* __restrict__ lse, int B, int S, int H, int blk, int causal, float scale) {
  using G = SpFwdGeo<D>;
  constexpr int LD = G::LD, KD = D / 16, NS = kBN / 8, NO = D / 8, ST = G::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + G::q_bytes + (2 * s) * G::kv_bytes); };
  auto sV = [&](int s) { return reinterpret_cast<bf16*>(smem + G::q_bytes + (2 * s + 1) * G::kv_bytes); };
  int* sRec = reinterpret_cast<int*>(smem + G::q_bytes + ST * 2 * G::kv_bytes);
  unsigned* sE = reinterpret_cast<unsigned*>(smem + G::smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int b = static_cast<int>(blockIdx.x % B);
  const Walk w = begin_walk(items, entries, B, blk, sRec, sE);
  const float scale2 = scale * kLog2e;

  load_rows<D, LD>(sQ, q, b, S, H, w.h, sRec, blk);
  for (int i = 0; i < ST - 1; ++i) {  // one group a stage (Q with the first), empty past the walk's end
    if (i < w.n_steps) load_step<D, LD>(sK(i), sV(i), k, v, b, S, H, w, i);
    cp_async_commit();
  }

  RowFrags<KD, G::QREG> qf;
  qf.init(sQ + 16 * warp * LD, LD);
  // this lane's rows: w.qw + g + 8 r for r in {0, 1}
  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < w.n_steps; ++t) {
    const int s = t % ST;
    cp_async_wait<ST - 2>();
    __syncthreads();  // step t (and Q) landed for every thread; every warp is done with step t - 1
    if (t + ST - 1 < w.n_steps) load_step<D, LD>(sK((t + ST - 1) % ST), sV((t + ST - 1) % ST), k, v, b, S, H, w,
                                                 t + ST - 1);  // into step t - 1's stage
    cp_async_commit();
    if (w.mrow < 0) continue;  // a member the group does not have: the warp only stages
    if (t == 0) qf.load();
    const StepMask sm(w, t, causal);
    if (sm.valid == 0u) continue;  // none of the step's keys is the member's
    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    const bf16* ks = sK(s);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      qf.get(kd, qa);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], qa, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qa, r[2], r[3]);
      }
    }
    // row maxima of the raw q.k, P, and the rescale of l and O; MASKED is a compile-time copy
    uint32_t pa[NS / 2][4];  // P as the A operand of P V: 16 keys per k-step
    auto softmax = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MASKED) {
            if (sm.masked(w.qw + g + (e < 2 ? 0 : 8), j >> 1, (j & 1) * 8 + t2 + (e & 1))) sacc[j][e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
        }
      float ms[2], al[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m_r[r], quad_max(mx[r]));
        // the old max is rounded as ms is (no FMA): equal maxima, kNegInf ones included, give 2^0 exactly
        ms[r] = __fmul_rn(mn, scale2);
        al[r] = fast_exp2(__fmul_rn(m_r[r], scale2) - ms[r]);
        m_r[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(sacc[j][e], scale2, -ms[e >> 1]));
          if (MASKED && sacc[j][e] <= kNegInf) p[e] = 0.f;
        }
        ps[0] += p[0] + p[1];
        ps[1] += p[2] + p[3];
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
    if (sm.valid == (1u << kChunks) - 1u && sm.cut == 0u) {
      softmax(std::false_type{});
    } else {
      softmax(std::true_type{});
    }
    const bf16* vs = sV(s);
#pragma unroll
    for (int kb = 0; kb < NS / 2; ++kb)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + (kb * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(oacc[2 * dp], pa[kb], r[0], r[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kb], r[2], r[3]);
      }
  }
  cp_async_wait<0>();
  if (w.mrow < 0) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w.qw + g + 8 * r;
    const float l = quad_sum(l_r[r]);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    bf16* orow = o + ((static_cast<size_t>(b) * S + row) * H + w.h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t2) = pack_bf16(oacc[j][2 * r] * inv, oacc[j][2 * r + 1] * inv);
    if ((lane & 3) == 0)  // natural-log lse; m scale rounds as the plain version's max of q.k scale; no key: kNegInf
      lse[(static_cast<size_t>(b) * H + w.h) * S + row] = l == 0.f ? kNegInf : m_r[r] * scale + logf(l);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* plan, int n_items, int max_entries, bf16* o,
           float* lse, int B, int S, int H, int blk, int causal, float scale, cudaStream_t stream) {
  using G = SpFwdGeo<D>;
  if (static_cast<long long>(n_items) * B > 0x7fffffffLL) return kUnsupported;
  const unsigned* entries = reinterpret_cast<const unsigned*>(plan + static_cast<size_t>(n_items) * kIW);
  const size_t smem = G::smem + static_cast<size_t>(max_entries) * 4;
  if (smem > 232448) return kUnsupported;
  const cudaError_t err = allow_smem(sparse_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0)
    sparse_fwd_bf16_kernel<D><<<n_items * B, kNT, smem, stream>>>(q, k, v, plan, entries, o, lse, B, S, H, blk,
                                                                  causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int sparse_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const int* plan, int n_items, int max_entries,
                    int rows, bf16* o, float* lse, int B, int S, int H, int D, int blk, int causal, float scale,
                    cudaStream_t stream) {
  if (plan == nullptr || rows != kBM || n_items < 0 || max_entries < 0) return kUnsupported;
  switch (D) {
    case 32: return launch<32>(q, k, v, plan, n_items, max_entries, o, lse, B, S, H, blk, causal, scale, stream);
    case 64: return launch<64>(q, k, v, plan, n_items, max_entries, o, lse, B, S, H, blk, causal, scale, stream);
    case 128: return launch<128>(q, k, v, plan, n_items, max_entries, o, lse, B, S, H, blk, causal, scale, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
