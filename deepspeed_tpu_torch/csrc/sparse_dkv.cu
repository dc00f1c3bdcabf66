// The bfloat16 block-sparse dk/dv for Hopper: dk and dv of a static block
// layout, from q, k, v, dout (B, S, H, D), the forward's lse and delta =
// rowsum(o * dout) (B, H, S), over a plan of the qidx lists (the query blocks
// that attend each key block) that sparse_self_attention.py's dkv_plan works
// out on the host once per configuration.
//
// Replaces, for bf16, the TPU kernel _sp_dkv_kernel of deepspeed_tpu/ops/
// sparse_attention/sparse_self_attention.py (pallas_call at :239, via
// _sp_bwd). The float32 dk/dv stays in sparse_attention.cu, which routes
// the bf16 dk/dv here. The arithmetic is that kernel's: s = (q.k) scale,
// p = exp(s - lse), masked on a causal run only inside the diagonal block (a
// key after its query), dv = p^T dout with p rounded to bf16,
// ds = p (dp - delta) scale rounded to bf16, dk = ds^T q.
//
// What bounds it: 8 P D flops (four products) for the layout's P active
// pairs against reading q, k, v, dout once and writing dk, dv: at the layouts
// users run (a quarter to a twentieth of S^2, D 64-128) the tensor cores
// (0.28 ms at gpt2_1_3b's heads, S 8192, the Fixed layout). Two things stand
// between the layout and that bound. The lists are imbalanced: in the Fixed
// layouts a quarter of the key blocks (the global columns) are attended by
// every later query block, and hold 96-97 % of the work, the rest by the 4 of
// their window. And a key block at the default block of 16 is 16 rows, one
// warp: alone it shares no staged tile with anyone.
//
// The design (flash_bwd.cu's dk/dv on mma.sync, over lists):
// - A CUDA block of 4 warps owns 64 key rows: the members of a group, 64 /
//   min(blk, 64) key blocks of one head whose lists are alike (dkv_plan: of
//   one length class, and their union takes no more steps than the longest).
//   In the Fixed layouts that puts four global columns together, whose lists
//   are all query blocks (bidirectional) or nearly the same suffix of them
//   (unidirectional), and three local blocks of one window together. The
//   block walks the union of its members' lists (ascending, with a bit per
//   member that attends each entry) and every warp shares each staged tile;
//   a warp skips a sub-tile that holds none of its member's entries.
// - A walk longer than the plan's split (64 steps) is split into pieces, each
//   a CUDA block writing fp32 partials of the group's dk and dv into its own
//   slot of a workspace; a second kernel sums a group's pieces in order. No
//   atomics: dk and dv repeat bit for bit. The plan lists the longest walks
//   first.
// - A step stages 64 query rows (Q, dO, lse, delta): the next 64 / blk list
//   entries, or 64 rows of a block of 128, each row's address from its entry,
//   through a ring of 2 stages filled by cp.async (zero past the walk's end)
//   while the other multiplies, with one block barrier a step.
// - A warp's S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k16 products in
//   registers, over a sub-tile of QS queries (32, at D 128 16); P^T and dS^T
//   go from their C fragments to dV += P^T dO and dK += dS^T Q (dO and Q
//   through the transposing ldmatrix). dK and dV are fp32 register
//   accumulators. Nothing else goes through shared memory.
// - Mask arithmetic only where a mask can act: a warp takes the masked body
//   (compile-time copy) for a sub-tile holding an entry not its member's, the
//   walk's end, or its own block on a causal run; else the unmasked body.
// - p = 2^x by one ex2.approx, x = q.k scale log2(e) - lse log2(e) one FFMA.
// The bf16 forward and dq (sparse_fwd.cu, sparse_dq.cu) share this design
// on the query side, over query_plan (neighbouring query blocks grouped).
// Not yet: wgmma, TMA, a persistent grid.
#include "flash_common.cuh"  // kLog2e, fast_exp2
#include "mma.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

// 4 warps of 16 key rows; query tiles of BN through the ring, taken QS queries at a time.
template <int D>
struct SpDkvGeo {
  static constexpr int NW = 4, NT = 32 * NW, BM = 16 * NW, BN = 64, QS = D <= 64 ? 32 : 16;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr int LD = D + 8;        // +16 bytes: ldmatrix rows on distinct banks
  static constexpr int IW = 4 + BM / 16;  // ints of a plan record
  static constexpr size_t kv_bytes = static_cast<size_t>(BM) * LD * 2;
  static constexpr size_t q_bytes = static_cast<size_t>(BN) * LD * 2;
  static constexpr size_t vec_bytes = static_cast<size_t>(BN) * 4;
  static constexpr size_t stage_bytes = 2 * q_bytes + 2 * vec_bytes;        // Q, dO, lse, delta
  static constexpr size_t smem = 2 * kv_bytes + STAGES * stage_bytes + 128;  // K, V, stages, the record
};

constexpr unsigned kBlockBits = 0xFFFFFFu;  // a walk entry: query block | owner bits << 24

// Grid (n_items * B): x = item * B + batch row. Item `rec` (IW ints): head, first entry, entries, slot (-1:
// dk and dv straight out), first key row of each member (-1: none). Warp w serves member 16 w / R.
template <int D>
__global__ void __launch_bounds__(SpDkvGeo<D>::NT, SpDkvGeo<D>::MIN_BLOCKS)
sparse_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ items,
                       const unsigned* __restrict__ entries, float* __restrict__ ws, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int B, int S, int H, int blk, int causal, float scale, int n_slots) {
  using G = SpDkvGeo<D>;
  constexpr int LD = G::LD, BM = G::BM, BN = G::BN, QS = G::QS, NT = G::NT, IW = G::IW;
  constexpr int KD = D / 16, NQ = QS / 8, NO = D / 8, ST = G::STAGES, VPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + G::kv_bytes);
  auto stage = [&](int s) { return smem + 2 * G::kv_bytes + s * G::stage_bytes; };
  auto sQ = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto sdO = [&](int s) { return reinterpret_cast<bf16*>(stage(s) + G::q_bytes); };
  auto sL = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * G::q_bytes); };
  auto sDl = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * G::q_bytes + G::vec_bytes); };
  int* sRec = reinterpret_cast<int*>(smem + 2 * G::kv_bytes + ST * G::stage_bytes);
  unsigned* sE = reinterpret_cast<unsigned*>(smem + G::smem);  // the item's walk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int b = static_cast<int>(blockIdx.x % B);
  const int* rec = items + static_cast<size_t>(blockIdx.x / B) * IW;
  if (tid < IW) sRec[tid] = rec[tid];
  const int n = rec[2];
  for (int i = tid; i < n; i += NT) sE[i] = entries[rec[1] + i];
  __syncthreads();  // the record and the walk, for every thread
  const int h = sRec[0], slot = sRec[3];
  const int R = min(blk, BM);         // key rows of a member
  const int m = 16 * warp / R;        // this warp's member: its owner bit
  const int mrow = sRec[4 + m];       // the member's first key row, -1 where the group has no such member
  const int kw = mrow + 16 * warp - m * R;  // the warp's first key row
  const int kb = mrow / blk;          // the member's key block
  const int span = min(blk, BN), E = BN / span, SPT = blk > BN ? blk / BN : 1;  // rows a slot; entries, steps
  const int n_steps = (n + E - 1) / E * SPT;
  const float scale2 = scale * kLog2e;

  for (int i = tid; i < BM * VPR; i += NT) {  // the members' K and V rows (zeros for a missing member)
    const int r = i / VPR, c = (i % VPR) * 8, row0 = sRec[4 + r / R];
    const bool ok = row0 >= 0;
    const size_t at = ((static_cast<size_t>(b) * S + row0 + r % R) * H + h) * D + c;
    cp_async16(sK + r * LD + c, ok ? k + at : k, ok ? 16 : 0);
    cp_async16(sV + r * LD + c, ok ? v + at : v, ok ? 16 : 0);
  }
  cp_async_commit();
  // step t: slots (t / SPT) * E + u of the walk, u = row / span, rows (t % SPT) * BN + row % span of each
  auto entry = [&](int t, int row) { return (t / SPT) * E + row / span; };
  auto position = [&](int t, int row, unsigned e) {
    return static_cast<int>(e & kBlockBits) * blk + (t % SPT) * BN + row % span;
  };
  auto load_step = [&](int s, int t) {
    for (int i = tid; i < BN * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8, ei = entry(t, r);
      const bool ok = ei < n;
      const size_t at = ((static_cast<size_t>(b) * S + (ok ? position(t, r, sE[ei]) : 0)) * H + h) * D + c;
      cp_async16(sQ(s) + r * LD + c, ok ? q + at : q, ok ? 16 : 0);
      cp_async16(sdO(s) + r * LD + c, ok ? dout + at : dout, ok ? 16 : 0);
    }
    for (int r = tid; r < BN; r += NT) {
      const int ei = entry(t, r);
      const bool ok = ei < n;
      const size_t at = (static_cast<size_t>(b) * H + h) * S + (ok ? position(t, r, sE[ei]) : 0);
      cp_async4(sL(s) + r, ok ? lse + at : lse, ok ? 4 : 0);
      cp_async4(sDl(s) + r, ok ? delta + at : delta, ok ? 4 : 0);
    }
  };
  for (int i = 0; i < ST - 1; ++i) {  // one group a stage, empty past the walk's end
    if (i < n_steps) load_step(i, i);
    cp_async_commit();
  }

  // this lane's keys: kw + g + 8 r for r in {0, 1}
  float dkacc[NO][4], dvacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int s = t % ST;
    cp_async_wait<ST - 2>();
    __syncthreads();  // step t (and K, V) landed for every thread; every warp is done with step t - 1
    if (t + ST - 1 < n_steps) load_step((t + ST - 1) % ST, t + ST - 1);  // into step t - 1's stage
    cp_async_commit();
    if (mrow < 0) continue;  // a member the group does not have: the warp only stages
    const bf16* qs = sQ(s);
    const bf16* dos = sdO(s);
    const float* ls = sL(s);
    const float* dls = sDl(s);
#pragma unroll
    for (int sub = 0; sub < BN / QS; ++sub) {
      // the slots of the sub-tile's QS query rows (one, or two of 16 rows), and what they are to this warp:
      // its member's entries (some, or all and none of them its own block on a causal run), or none
      bool any = false, all = true;
#pragma unroll
      for (int u = 0; u < (QS + 15) / 16; ++u) {
        const int row = sub * QS + u * 16, ei = entry(t, row);
        if (u > 0 && row / span == (sub * QS) / span) continue;  // the same slot as u - 1
        const unsigned e = ei < n ? sE[ei] : 0u;
        const bool own = ei < n && ((e >> (24 + m)) & 1u);
        any = any || own;
        all = all && own && !(causal && static_cast<int>(e & kBlockBits) == kb);
      }
      if (!any) continue;
      float sacc[NQ][4], pacc[NQ][4];  // S^T = K Q^T and dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
        ldsm_x4(va, sV + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int off = (sub * QS + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, qs + off);
          mma_bf16(sacc[2 * np], ka, r[0], r[1]);
          mma_bf16(sacc[2 * np + 1], ka, r[2], r[3]);
          ldsm_x4(r, dos + off);
          mma_bf16(pacc[2 * np], va, r[0], r[1]);
          mma_bf16(pacc[2 * np + 1], va, r[2], r[3]);
        }
      }
      // P^T and dS^T on the fragments, as the A operands of dV and dK: 16 query rows per k-step
      uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
      auto form_p_ds = [&](auto masked_tag) {
        constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int c = sub * QS + j * 8 + t2;  // this lane's two query rows in the step (one slot)
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
          const float lq[2] = {l2.x * kLog2e, l2.y * kLog2e};
          const float dl[2] = {d2.x, d2.y};
          bool own = true, diag = false;
          int qoff = 0;  // the query rows' offset in their block
          if constexpr (MASKED) {
            const int ei = entry(t, c);
            const unsigned e = ei < n ? sE[ei] : 0u;
            own = ei < n && ((e >> (24 + m)) & 1u);
            diag = causal && static_cast<int>(e & kBlockBits) == kb;
            qoff = (t % SPT) * BN + c % span;
          }
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = fast_exp2(fmaf(sacc[j][e], scale2, -lq[e & 1]));
            // a masked pair: not the member's entry, or on its own block a key after the query
            if (MASKED && (!own || (diag && qoff + (e & 1) < kw - kb * blk + g + (e < 2 ? 0 : 8)))) p[e] = 0.f;
            ds[e] = p[e] * (pacc[j][e] - dl[e & 1]) * scale;
          }
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (all) {
        form_p_ds(std::false_type{});
      } else {
        form_p_ds(std::true_type{});
      }
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kb16 = 0; kb16 < NQ / 2; ++kb16)
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          const int off = (sub * QS + kb16 * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, dos + off);
          mma_bf16(dvacc[2 * dp], pa[kb16], r[0], r[1]);
          mma_bf16(dvacc[2 * dp + 1], pa[kb16], r[2], r[3]);
          ldsm_x4_t(r, qs + off);
          mma_bf16(dkacc[2 * dp], dsa[kb16], r[0], r[1]);
          mma_bf16(dkacc[2 * dp + 1], dsa[kb16], r[2], r[3]);
        }
    }
  }
  cp_async_wait<0>();
  if (mrow < 0) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (slot < 0) {  // the whole walk: dk and dv out
      const size_t base = ((static_cast<size_t>(b) * S + kw + g + 8 * r) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(dk + base + j * 8 + t2) = pack_bf16(dkacc[j][2 * r], dkacc[j][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + j * 8 + t2) = pack_bf16(dvacc[j][2 * r], dvacc[j][2 * r + 1]);
      }
    } else {  // a piece: fp32 partials in its slot (dk's, then n_slots further on dv's)
      float* wk = ws + ((static_cast<size_t>(slot) * B + b) * BM + 16 * warp + g + 8 * r) * D;
      float* wv = wk + static_cast<size_t>(n_slots) * B * BM * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<float2*>(wk + j * 8 + t2) = make_float2(dkacc[j][2 * r], dkacc[j][2 * r + 1]);
        *reinterpret_cast<float2*>(wv + j * 8 + t2) = make_float2(dvacc[j][2 * r], dvacc[j][2 * r + 1]);
      }
    }
  }
}

// Grid (n_reduce * B): x = group * B + batch row. A split group's dk and dv: the sum of its pieces' partials,
// in the pieces' order. Record: head, first slot, pieces, 0, the members' first key rows.
template <int BM, int IW>
__global__ void sparse_dkv_reduce_kernel(const int* __restrict__ reduce, const float* __restrict__ ws,
                                         bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int H, int D,
                                         int blk, int n_slots) {
  const int b = static_cast<int>(blockIdx.x % B);
  const int* rec = reduce + static_cast<size_t>(blockIdx.x / B) * IW;
  const int h = rec[0], slot0 = rec[1], pieces = rec[2], R = min(blk, BM);
  const size_t per_slot = static_cast<size_t>(B) * BM * D, dv_off = static_cast<size_t>(n_slots) * per_slot;
  for (int i = threadIdx.x * 4; i < BM * D; i += blockDim.x * 4) {
    const int r = i / D, row0 = rec[4 + r / R];
    if (row0 < 0) continue;
    float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
    for (int p = 0; p < pieces; ++p) {
      const float* src = ws + (slot0 + p) * per_slot + static_cast<size_t>(b) * BM * D + i;
      const float4 xk = *reinterpret_cast<const float4*>(src);
      const float4 xv = *reinterpret_cast<const float4*>(src + dv_off);
      ak = make_float4(ak.x + xk.x, ak.y + xk.y, ak.z + xk.z, ak.w + xk.w);
      av = make_float4(av.x + xv.x, av.y + xv.y, av.z + xv.z, av.w + xv.w);
    }
    const size_t at = ((static_cast<size_t>(b) * S + row0 + r % R) * H + h) * D + i % D;
    *reinterpret_cast<uint2*>(dk + at) = make_uint2(pack_bf16(ak.x, ak.y), pack_bf16(ak.z, ak.w));
    *reinterpret_cast<uint2*>(dv + at) = make_uint2(pack_bf16(av.x, av.y), pack_bf16(av.z, av.w));
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* delta,
           const int* plan, int n_items, int n_reduce, int n_slots, int max_entries, float* ws, bf16* dk, bf16* dv,
           int B, int S, int H, int blk, int causal, float scale, cudaStream_t stream) {
  using G = SpDkvGeo<D>;
  if (static_cast<long long>(n_items) * B > 0x7fffffffLL || static_cast<long long>(n_reduce) * B > 0x7fffffffLL)
    return kUnsupported;
  const int* reduce = plan + static_cast<size_t>(n_items) * G::IW;
  const unsigned* entries = reinterpret_cast<const unsigned*>(reduce + static_cast<size_t>(n_reduce) * G::IW);
  const size_t smem = G::smem + static_cast<size_t>(max_entries) * 4;
  if (smem > 232448) return kUnsupported;
  cudaError_t err = allow_smem(sparse_dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0)
    sparse_dkv_bf16_kernel<D><<<n_items * B, G::NT, smem, stream>>>(q, k, v, dout, lse, delta, plan, entries, ws, dk,
                                                                    dv, B, S, H, blk, causal, scale, n_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_reduce > 0)
    sparse_dkv_reduce_kernel<G::BM, G::IW><<<n_reduce * B, 256, 0, stream>>>(reduce, ws, dk, dv, B, S, H, D, blk,
                                                                            n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int sparse_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                    const float* delta, const int* plan, int n_items, int n_reduce, int n_slots, int max_entries,
                    int rows, float* ws, bf16* dk, bf16* dv, int B, int S, int H, int D, int blk, int causal,
                    float scale, cudaStream_t stream) {
  if (plan == nullptr || rows != SpDkvGeo<32>::BM || n_items < 0 || n_reduce < 0 || n_slots < 0 || max_entries < 0 ||
      (n_slots > 0 && (ws == nullptr || !aligned16(ws))))
    return kUnsupported;
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, plan, n_items, n_reduce, n_slots, max_entries, ws, dk, dv, B,
                               S, H, blk, causal, scale, stream);
    case 64: return launch<64>(q, k, v, dout, lse, delta, plan, n_items, n_reduce, n_slots, max_entries, ws, dk, dv, B,
                               S, H, blk, causal, scale, stream);
    case 128: return launch<128>(q, k, v, dout, lse, delta, plan, n_items, n_reduce, n_slots, max_entries, ws, dk, dv,
                                 B, S, H, blk, causal, scale, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
