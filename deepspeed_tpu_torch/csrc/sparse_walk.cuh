// The query-side walk shared by the bfloat16 block-sparse forward (sparse_fwd.cu) and dq (sparse_dq.cu):
// a CUDA block of 4 warps owns 64 query rows of one head, the members of a group of
// sparse_self_attention.py's query_plan (64 / min(blk, 64) neighbouring query blocks, or 64 rows of a block
// of 128), and walks the union of their kidx lists, staging 64 keys a step.
//
// The plan's record of the block (kIW ints): head, first entry, entries, slot (always -1: the query plan
// splits no walk), first query row of each member (-1: none). An entry of the walk is a key block | a bit
// per member that attends it << 24. Warp w serves member 16 w / R (R = min(blk, 64) rows a member).
#pragma once

#include "flash_common.cuh"
#include "mma.cuh"

namespace dstorch {
namespace sparse_walk {

using bf16 = __nv_bfloat16;

constexpr int kNW = 4, kNT = 32 * kNW;  // 4 warps of 16 query rows
constexpr int kBM = 16 * kNW;           // query rows a block
constexpr int kBN = 64;                 // keys a step
constexpr int kChunks = kBN / 16;       // chunks of 16 keys a step: the unit of ownership and of the causal mask
constexpr int kIW = 4 + kBM / 16;       // ints of a plan record
constexpr unsigned kBlockBits = 0xFFFFFFu;
constexpr size_t kRecBytes = 128;       // the record's room in shared memory, before the walk

// The block's walk as one warp sees it. Blocks, slots and steps are powers of two, so the walk's index
// arithmetic is shifts and masks: integer division there made the forward a third slower at block 16
// (sparse_probe.py on an H100).
struct Walk {
  const unsigned* sE;  // the walk's entries, in shared memory
  int h, n;            // head, entries
  int lblk, lspan, le, lspt, n_steps;  // log2 of the layout block, of rows a slot, of slots and of steps an entry
  int m, mrow, qw, qb;  // the warp's member (its owner bit), its first row (-1: none), the warp's first row and
                        // the member's query block

  // step t stages key rows ((t / SPT) * E + r / span) of the walk (entry), rows (t % SPT) * kBN + r % span of each
  __device__ __forceinline__ int entry(int t, int r) const { return ((t >> lspt) << le) + (r >> lspan); }
  __device__ __forceinline__ int position(int t, int r, unsigned e) const {
    return (static_cast<int>(e & kBlockBits) << lblk) + ((t & ((1 << lspt) - 1)) * kBN) + (r & ((1 << lspan) - 1));
  }
};

// Item blockIdx.x / B's record and walk into shared memory (every thread reads both after the barrier). blk is
// 16, 32, 64 or 128.
__device__ __forceinline__ Walk begin_walk(const int* __restrict__ items, const unsigned* __restrict__ entries,
                                           int B, int blk, int* sRec, unsigned* sE) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int* rec = items + static_cast<size_t>(blockIdx.x / B) * kIW;
  if (tid < kIW) sRec[tid] = rec[tid];
  const int n = rec[2];
  for (int i = tid; i < n; i += kNT) sE[i] = entries[rec[1] + i];
  __syncthreads();
  Walk w;
  w.sE = sE;
  w.h = sRec[0];
  w.n = n;
  w.lblk = __ffs(blk) - 1;
  w.lspan = min(w.lblk, 6);  // kBN = 64 keys a step
  w.le = 6 - w.lspan;
  w.lspt = max(w.lblk - 6, 0);
  w.n_steps = ((n + (1 << w.le) - 1) >> w.le) << w.lspt;
  const int R = min(blk, kBM);
  w.m = 16 * warp / R;
  w.mrow = sRec[4 + w.m];
  w.qw = w.mrow + 16 * warp - w.m * R;
  w.qb = w.mrow >> w.lblk;
  return w;
}

// The members' query rows of head h of a (B, S, H, D) tensor into shared memory (row stride LD) by cp.async,
// zeros for a missing member.
template <int D, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ x, int b, int S, int H, int h,
                                          const int* sRec, int blk) {
  constexpr int VPR = D / 8;
  const int R = min(blk, kBM);
  for (int i = threadIdx.x; i < kBM * VPR; i += kNT) {
    const int r = i / VPR, c = (i % VPR) * 8, row0 = sRec[4 + r / R];
    const bool ok = row0 >= 0;
    const size_t at = ((static_cast<size_t>(b) * S + row0 + r % R) * H + h) * D + c;
    cp_async16(dst + r * LD + c, ok ? x + at : x, ok ? 16 : 0);
  }
}

// Step t's K and V rows (head h of (B, S, H, D) tensors), each row's address from its walk entry, zeros past
// the walk's end, into shared memory by cp.async.
template <int D, int LD>
__device__ __forceinline__ void load_step(bf16* sK, bf16* sV, const bf16* __restrict__ k,
                                          const bf16* __restrict__ v, int b, int S, int H, const Walk& w, int t) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < kBN * VPR; i += kNT) {
    const int r = i / VPR, c = (i % VPR) * 8, ei = w.entry(t, r);
    const bool ok = ei < w.n;
    const size_t at = ((static_cast<size_t>(b) * S + (ok ? w.position(t, r, w.sE[ei]) : 0)) * H + w.h) * D + c;
    cp_async16(sK + r * LD + c, ok ? k + at : k, ok ? 16 : 0);
    cp_async16(sV + r * LD + c, ok ? v + at : v, ok ? 16 : 0);
  }
}

// What step t's kChunks chunks of 16 keys are to the warp: bit c of `valid` when its member attends chunk c
// and some key of it is visible to some row of the warp; bit c of `cut` when the causal mask cuts the chunk
// inside the warp's rows (the member's own block: key > query masked), with kpos[c] the chunk's first key.
// The warp skips a step of no valid chunk, and takes the masked body unless every chunk is valid and uncut.
struct StepMask {
  unsigned valid, cut;
  int kpos[kChunks];

  __device__ __forceinline__ StepMask(const Walk& w, int t, int causal) : valid(0u), cut(0u) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ei = w.entry(t, 16 * c);
      const unsigned e = ei < w.n ? w.sE[ei] : 0u;
      kpos[c] = w.position(t, 16 * c, e);
      bool own = ei < w.n && ((e >> (24 + w.m)) & 1u);
      if (own && causal && static_cast<int>(e & kBlockBits) == w.qb) {
        own = kpos[c] <= w.qw + 15;                           // not after every row of the warp
        if (own && kpos[c] + 15 > w.qw) cut |= 1u << c;     // after some row of it
      }
      if (own) valid |= 1u << c;
    }
  }
  // whether element (row, key `off` of chunk c) is masked: an invalid chunk, or a key after the query
  __device__ __forceinline__ bool masked(int row, int c, int off) const {
    return !((valid >> c) & 1u) || (((cut >> c) & 1u) && kpos[c] + off > row);
  }
};

// A warp's 16 rows of an operand in shared memory (row stride LD) as mma.sync A fragments: held in
// registers for the whole walk (REG), or read again by ldmatrix at each use.
template <int KD, bool REG>
struct RowFrags {
  uint32_t f[REG ? KD : 1][4];
  const bf16* p;  // this lane's ldmatrix address at k-step 0

  __device__ __forceinline__ void init(const bf16* rows, int ld) {
    const int lane = threadIdx.x & 31;
    p = rows + (lane & 15) * ld + (lane >> 4) * 8;
  }
  __device__ __forceinline__ void load() {
    if constexpr (REG) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) ldsm_x4(f[kd], p + kd * 16);
    }
  }
  __device__ __forceinline__ void get(int kd, uint32_t (&a)[4]) const {
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kd][i];
    } else {
      ldsm_x4(a, p + kd * 16);
    }
  }
};

}  // namespace sparse_walk
}  // namespace dstorch
