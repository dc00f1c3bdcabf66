// Block-sparse attention for Hopper: the C entry points of the forward, dq and dk/dv over (B, S, H, D)
// tensors and a static block layout given as active-block lists, and the float32 bodies of all three.
// The bfloat16 bodies are register-resident kernels over a host plan of the lists
// (sparse_self_attention.py's WalkPlan), each in its own file, to which the entry points route bf16:
// sparse_fwd.cu (the forward) and sparse_dq.cu (dq) over query_plan, sparse_dkv.cu (dk/dv) over dkv_plan.
//
// Replaces, in float32, the TPU kernels of deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:
// _sp_fwd_kernel (pallas_call at :193, via _sp_fwd), _sp_dq_kernel (:222, via _sp_bwd) and _sp_dkv_kernel
// (:239). A layout of blk x blk blocks becomes kidx (H, S/blk, A): the key blocks each query block
// attends, ascending, -1 padded; and its transpose qidx (H, S/blk, Aq): the query blocks that attend each
// key block. Scores are s = (q.k) * scale; on causal runs the lists are already cut to the block-level
// lower triangle and only the diagonal block masks elements (key > query -> kNegInf).
//
// What bounds them: with P the active (query, key) pairs of the layout, the forward does 4*P*D flops (two
// products), dq 6*P*D and dk/dv 8*P*D, against reading q, k, v (do) and writing o (dq, dk, dv) once: in
// float32, outside the tensor cores, the operations at every layout users run. The float32 bodies:
// - Forward and dq: a CUDA block owns 32 query rows, 16 per warp: 32 / blk query blocks, or part of one
//   larger block. It walks the union of their lists, merged by one thread into shared memory at the start
//   with a bit per query block that attends each entry. Every warp shares each staged key tile, and a warp
//   computes only the columns of its own list (and skips a tile that holds none).
// - dk/dv: a CUDA block owns one key block's rows (at most 32; a larger block is split over several CUDA
//   blocks that walk the same list) and walks its list alone, on the transposed problem (key rows against
//   query columns: S^T = K Q^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q), so each block owns its dk/dv
//   rows outright: no atomics, and the result does not depend on scheduling.
// - A step covers a tile of 32 rows of the other sequence: the next 32 / blk entries of the list, one block
//   each, or 32 rows of one larger block. Several small blocks a step amortise the softmax's row
//   reductions, the rescale of the accumulator and the two barriers, whatever the layout block.
// - The TPU program ran all A steps and masked the -1 padding; the walk here stops at the first -1 (the
//   merged walk holds no padding), which gives the same numbers (a padded step adds p = 0 with a correction
//   of exp(0) = 1) and skips the padding's work. Slots of a tile past the end of the list are zero-filled
//   and masked.
// - Only the diagonal block of a causal run masks elements: each lane knows for its columns whether they
//   belong to it. A one-block step that lies wholly above (dk/dv: below) the diagonal is skipped.
// - Products are plain FMA loops over shared-memory tiles; the accumulators live in shared memory.
// - lse and delta are (B, H, S) fp32, without the TPU's 128-lane padding.
#include "common.cuh"

namespace dstorch {

// The bfloat16 bodies over a plan of the lists: `plan` (int32, on the device) holds n_items records of
// `rows` / 16 + 4 ints, n_reduce more, then the walks (sparse_self_attention.py's WalkPlan.table); ws the
// fp32 partials of the n_slots pieces of split walks (dk's, then dv's). The forward and dq (sparse_fwd.cu,
// sparse_dq.cu) walk query_plan, which splits nothing. Each returns 0, a cudaError_t or kUnsupported.
int sparse_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const int* plan,
                    int n_items, int max_entries, int rows, __nv_bfloat16* o, float* lse, int B, int S, int H, int D,
                    int blk, int causal, float scale, cudaStream_t stream);
int sparse_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta, const int* plan, int n_items,
                   int max_entries, int rows, __nv_bfloat16* dq, int B, int S, int H, int D, int blk, int causal,
                   float scale, cudaStream_t stream);
int sparse_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const __nv_bfloat16* dout, const float* lse, const float* delta, const int* plan, int n_items,
                    int n_reduce, int n_slots, int max_entries, int rows, float* ws, __nv_bfloat16* dk,
                    __nv_bfloat16* dv, int B, int S, int H, int D, int blk, int causal, float scale,
                    cudaStream_t stream);

namespace {

using bf16 = __nv_bfloat16;

// Per element type (float32 only: bf16 has its own files): at most NW warps (16 rows each) per block;
// key tiles of BN rows for forward and dq, query tiles of BN_DKV rows for dk/dv.
template <typename T>
struct SpTiles;
template <>
struct SpTiles<float> {
  static constexpr int NW = 2, BN = 32, BN_DKV = 32;
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr size_t round128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory a block may use on Hopper

// Shared-memory geometry: the block's rows, the tile strides (padded so that
// rows do not fall on one bank), and the buffer sizes (each a multiple of 128
// bytes).
template <typename T, int D, int BN_ = SpTiles<T>::BN>
struct SpGeo {
  static constexpr int NW = SpTiles<T>::NW, BN = BN_, NT = 32 * NW;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int LDT = D + PAD;   // T tiles of width D
  static constexpr int LDS = BN + 4;    // fp32 tiles of width BN
  static constexpr int LDP = BN + PAD;  // T tiles of width BN
  static constexpr int LDO = D + 4;     // fp32 tiles of width D
  int rows;                             // rows a block owns

  __host__ __device__ explicit SpGeo(int rows_) : rows(rows_) {}
  // forward and dq: 16 * NW query rows, whatever the layout block; dk/dv: one
  // key block's rows, at most 16 * NW
  __host__ __device__ static int fwd_rows() { return 16 * NW; }
  __host__ __device__ static int dkv_rows(int blk) { return imin(blk, 16 * NW); }
  __host__ __device__ size_t tileT(int r) const { return round128(sizeof(T) * r * LDT); }
  __host__ __device__ size_t tileS() const { return round128(sizeof(float) * rows * LDS); }
  __host__ __device__ size_t tileP() const { return round128(sizeof(T) * rows * LDP); }
  __host__ __device__ size_t tileO() const { return round128(sizeof(float) * rows * LDO); }
  __host__ __device__ static constexpr size_t vec() { return round128(sizeof(float) * BN); }
  __host__ __device__ size_t fwd() const { return tileT(rows) + 2 * tileT(BN) + tileS() + tileP() + tileO(); }
  __host__ __device__ size_t dq() const { return 2 * tileT(rows) + 2 * tileT(BN) + 2 * tileS() + tileP() + tileO(); }
  __host__ __device__ size_t dkv() const {
    return 2 * tileT(rows) + 2 * tileT(BN) + 2 * vec() + 2 * tileS() + 2 * tileP() + 2 * tileO();
  }
};

// A walk over active-block lists: idx (H, S / blk, A) int32, ascending, -1 padded.
struct Walk {
  const int* idx;
  int A, S, H, blk, causal;
  float scale;
};

// One step of a walk covers a tile of BN rows of the other sequence: with
// blk <= BN, the next nbt = BN / blk entries of the list, one block each (rows
// of a slot past the list's end are zeros and masked); with blk > BN, rows
// [sub, sub + BN) of one entry's block. `span` = min(blk, BN) rows per slot.
// `list` holds n entries (-1 after the last); `owners`, when given, has a bit
// per query block of the CUDA block that attends each entry (a merged walk).
struct Step {
  const int* list;
  const unsigned char* owners;
  int n, t, nbt, span, sub;

  // the list entry (block index) of tile row r, -1 past the end of the list
  __device__ __forceinline__ int entry(int r) const {
    const int u = r / span;
    return u < nbt && t + u < n ? list[t + u] : -1;
  }
  // whether query block `g` of the CUDA block attends the entry of tile row r
  __device__ __forceinline__ bool owned(int r, int g) const {
    return owners == nullptr || ((owners[t + r / span] >> g) & 1);
  }
  // the sequence position of tile row r of entry e
  __device__ __forceinline__ int pos(int r, int e, const Walk& w) const { return e * w.blk + sub + r % span; }
};

// The tile rows of a step, from head h of a (B, S, H, D) tensor, into shared
// memory (row stride LD) with 16-byte loads by all threads of the block.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage_step(T* sX, const T* __restrict__ x, int b, int h, const Step& st,
                                           const Walk& w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int e = st.entry(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (e >= 0) {
      const size_t row = static_cast<size_t>(b) * w.S + st.pos(r, e, w);
      val = *reinterpret_cast<const uint4*>(x + (row * w.H + h) * D + c);
    }
    *reinterpret_cast<uint4*>(sX + r * LD + c) = val;
  }
}

// Rows [r0, r0 + rows) of head h of a (B, S, H, D) tensor into shared memory;
// rows at or past S are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* sX, const T* __restrict__ x, int b, int h, int r0, int rows,
                                           const Walk& w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < w.S)
      val = *reinterpret_cast<const uint4*>(x + ((static_cast<size_t>(b) * w.S + r0 + r) * w.H + h) * D + c);
    *reinterpret_cast<uint4*>(sX + r * LD + c) = val;
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// This lane's columns of a step's tile (columns lane + 32 * j) for the warp's
// block `own` (bit `g` of the owner masks): their sequence positions, whether
// an entry of the warp's own list backs them, and whether they belong to the
// diagonal block of a causal run (the only block whose elements are masked).
template <int CPL>
struct Cols {
  int pos[CPL];
  bool valid[CPL], diag[CPL];

  __device__ __forceinline__ Cols(const Step& st, const Walk& w, int own, int g, int lane) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j, e = st.entry(c);
      valid[j] = e >= 0 && st.owned(c, g);
      diag[j] = w.causal && e == own;
      pos[j] = st.pos(c, e, w);
    }
  }
  // whether any lane of the warp has a column to compute
  __device__ __forceinline__ bool any() const {
    bool v = false;
#pragma unroll
    for (int j = 0; j < CPL; ++j) v = v || valid[j];
    return __any_sync(0xffffffffu, v);
  }
};

// The walk over list `list_row` of head h, as it is (dk/dv).
__device__ __forceinline__ Step list_walk(const Walk& w, int list_row, int h, int BN) {
  const int* list = w.idx + (static_cast<size_t>(h) * (w.S / w.blk) + list_row) * w.A;
  return Step{list, nullptr, w.A, 0, w.blk < BN ? BN / w.blk : 1, imin(w.blk, BN), 0};
}

// Forward and dq: a CUDA block of `rows` query rows from r0 holds nq =
// rows / blk query blocks when blk < rows (else part of one). It walks the
// union of their lists, merged here by one thread into shared memory (at most
// `cap` entries) with a bit per query block that attends each entry: every
// warp shares each staged key tile, and a warp computes only its own columns.
// Neighbouring query blocks of the layouts users run attend nearly the same
// key blocks (the same local window and global columns), so the union is
// about as long as one list.
__device__ __forceinline__ Step merged_walk(const Walk& w, int r0, int rows, int h, int BN, int* u_list,
                                            unsigned char* u_owners) {
  const int nb = w.S / w.blk, qb0 = r0 / w.blk, nq = w.blk < rows ? rows / w.blk : 1;
  __shared__ int n_union;
  if (threadIdx.x == 0) {
    const int* lists[4];
    int at[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      lists[g] = g < nq && qb0 + g < nb ? w.idx + (static_cast<size_t>(h) * nb + qb0 + g) * w.A : nullptr;
      at[g] = 0;
    }
    int n = 0;
    for (;;) {
      int next = 0x7fffffff;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (lists[g] != nullptr && at[g] < w.A && lists[g][at[g]] >= 0) next = min(next, lists[g][at[g]]);
      if (next == 0x7fffffff) break;
      unsigned char bits = 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (lists[g] != nullptr && at[g] < w.A && lists[g][at[g]] == next) {
          bits |= static_cast<unsigned char>(1u << g);
          ++at[g];
        }
      }
      u_list[n] = next;
      u_owners[n] = bits;
      ++n;
    }
    n_union = n;
  }
  __syncthreads();
  return Step{u_list, u_owners, n_union, 0, w.blk < BN ? BN / w.blk : 1, imin(w.blk, BN), 0};
}

// The merged walk's capacity: the union of nq lists of A entries over nb blocks.
__host__ __device__ inline int union_cap(int blk, int rows, int A, int S) {
  const int nq = blk < rows ? rows / blk : 1;
  return imin(nq * A, S / blk);
}
__host__ __device__ inline size_t union_bytes(int cap) { return round128(sizeof(int) * cap) + round128(cap); }

// ---------------------------------------------------------------- warp products
// C[16 x N] = A[16 x K] . B[N x K]^T; A, B row-major in shared memory, C fp32.
template <int N, int K>
__device__ __forceinline__ void warp_nt(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    const float* b = B + c * ldb;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[k], b[k], s);
    C[r * ldc + c] = s;
  }
}

// C[16 x N] += A[16 x K] . B[K x N]; A, B row-major in shared memory, C fp32.
template <int N, int K>
__device__ __forceinline__ void warp_nn_acc(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    float s = C[r * ldc + c];
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[k], B[k * ldb + c], s);
    C[r * ldc + c] = s;
  }
}

// A warp's fp32 accumulator of a 16 x D tile in shared memory, C += A[16 x K] . B[K x D].
template <typename T, int D>
struct WarpAcc;

template <int D>
struct WarpAcc<float, D> {
  static constexpr int LD = D + 4;
  float* C;  // 16 x D, row stride LD

  __device__ __forceinline__ explicit WarpAcc(float* tile) : C(tile) {
    for (int i = threadIdx.x & 31; i < 16 * LD; i += 32) C[i] = 0.f;
    __syncwarp();
  }
  template <int K>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb) {
    warp_nn_acc<D, K>(C, LD, A, lda, B, ldb);
  }
  __device__ __forceinline__ void store(float* out, size_t stride, float*) const {
    __syncwarp();
    for (int e = threadIdx.x & 31; e < 16 * D; e += 32) out[(e / D) * stride + e % D] = C[(e / D) * LD + e % D];
  }
};

// ---------------------------------------------------------------- forward
// Grid (ceil(S / rows), H, B), rows = 16 * NW. o (B, S, H, D) in T; lse (B, H, S) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(SpGeo<T, D>::NT)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, Walk w) {
  using G = SpGeo<T, D>;
  constexpr int BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO, CPL = BN / 32;
  const G g(G::fwd_rows());
  const int cap = union_cap(w.blk, g.rows, w.A, w.S);
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* sQ = reinterpret_cast<T*>(smem + off);
  off += g.tileT(g.rows);
  T* sK = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  T* sV = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  float* sS = reinterpret_cast<float*>(smem + off);
  off += g.tileS();
  T* sP = reinterpret_cast<T*>(smem + off);
  off += g.tileP();
  float* sO = reinterpret_cast<float*>(smem + off);
  off += g.tileO();
  int* u_list = reinterpret_cast<int*>(smem + off);
  unsigned char* u_owners = smem + off + round128(sizeof(int) * cap);

  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * g.rows, qi = r0 / w.blk, last_row = min(r0 + g.rows, w.S) - 1;
  const int wr = 16 * warp;                   // the warp's first row in the block
  const int own = (r0 + wr) / w.blk;          // the warp's query block
  const int gw = own - qi;                    // and its bit in the owner masks
  stage_rows<T, D, LDT>(sQ, q, b, h, r0, g.rows, w);
  zero(sO, g.rows * LDO);

  float* sSw = sS + wr * LDS;
  T* sPw = sP + wr * LDP;
  float* sOw = sO + wr * LDO;
  float m_i[16], l_i[16];  // running max and sum of the warp's 16 rows
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
  }
  for (Step st = merged_walk(w, r0, g.rows, h, BN, u_list, u_owners); st.t < st.n; st.t += st.nbt) {
    const int e0 = st.list[st.t];
    for (st.sub = 0; st.sub < w.blk; st.sub += st.span) {
      if (st.nbt == 1 && w.causal && e0 == qi && e0 * w.blk + st.sub > last_row) break;  // above the diagonal
      __syncthreads();  // the previous tile's readers are done (and sQ, sO are written)
      stage_step<T, D, BN, LDT>(sK, k, b, h, st, w);
      stage_step<T, D, BN, LDT>(sV, v, b, h, st, w);
      __syncthreads();
      const Cols<CPL> cols(st, w, own, gw, lane);
      if (!cols.any()) continue;  // none of the tile's blocks is in this warp's list
      warp_nt<BN, D>(sSw, LDS, sQ + wr * LDT, LDT, sK, LDT);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = r0 + wr + i;
        float s[CPL];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float x = sSw[i * LDS + lane + 32 * j] * w.scale;
          s[j] = !cols.valid[j] || (cols.diag[j] && cols.pos[j] > row) ? kNegInf : x;
          mx = fmaxf(mx, s[j]);
        }
        const float mnew = fmaxf(m_i[i], warp_max(mx));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float p = s[j] <= kNegInf ? 0.f : expf(s[j] - mnew);
          ps += p;
          sPw[i * LDP + lane + 32 * j] = from_float<T>(p);
        }
        const float alpha = expf(m_i[i] - mnew);
        l_i[i] = l_i[i] * alpha + warp_sum(ps);
        m_i[i] = mnew;
        for (int c = lane; c < D; c += 32) sOw[i * LDO + c] *= alpha;
      }
      __syncwarp();
      warp_nn_acc<D, BN>(sOw, LDO, sPw, LDP, sV, LDT);
    }
  }
  __syncwarp();
  if (r0 + wr >= w.S) return;  // the rows of a last, partial block past the end
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = r0 + wr + i;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    T* orow = o + ((static_cast<size_t>(b) * w.S + row) * w.H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = from_float<T>(sOw[i * LDO + c] / l);
    if (lane == 0) lse[(static_cast<size_t>(b) * w.H + h) * w.S + row] = l_i[i] == 0.f ? kNegInf : m_i[i] + logf(l);
  }
}

// ---------------------------------------------------------------- dq
// Grid (ceil(S / rows), H, B), rows = 16 * NW. dq = sum over the active key blocks of
// (p * (dp - delta) * scale) k, with p = exp(s - lse) and ds rounded to T.
template <typename T, int D>
__global__ void __launch_bounds__(SpGeo<T, D>::NT)
sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, Walk w) {
  using G = SpGeo<T, D>;
  constexpr int BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO, CPL = BN / 32;
  const G g(G::fwd_rows());
  const int cap = union_cap(w.blk, g.rows, w.A, w.S);
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* sQ = reinterpret_cast<T*>(smem + off);
  off += g.tileT(g.rows);
  T* sdO = reinterpret_cast<T*>(smem + off);
  off += g.tileT(g.rows);
  T* sK = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  T* sV = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  float* sS = reinterpret_cast<float*>(smem + off);
  off += g.tileS();
  float* sdP = reinterpret_cast<float*>(smem + off);
  off += g.tileS();
  T* sdS = reinterpret_cast<T*>(smem + off);
  off += g.tileP();
  float* sdQ = reinterpret_cast<float*>(smem + off);
  off += g.tileO();
  int* u_list = reinterpret_cast<int*>(smem + off);
  unsigned char* u_owners = smem + off + round128(sizeof(int) * cap);

  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * g.rows, qi = r0 / w.blk, last_row = min(r0 + g.rows, w.S) - 1;
  const int wr = 16 * warp;
  const int own = (r0 + wr) / w.blk, gw = own - qi;
  stage_rows<T, D, LDT>(sQ, q, b, h, r0, g.rows, w);
  stage_rows<T, D, LDT>(sdO, dout, b, h, r0, g.rows, w);

  float* sSw = sS + wr * LDS;
  float* sdPw = sdP + wr * LDS;
  T* sdSw = sdS + wr * LDP;
  WarpAcc<T, D> acc(sdQ + wr * LDO);
  const size_t rowbase = (static_cast<size_t>(b) * w.H + h) * w.S;
  float lse_i[16], delta_i[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool in = r0 + wr + i < w.S;
    lse_i[i] = in ? lse[rowbase + r0 + wr + i] : 0.f;
    delta_i[i] = in ? delta[rowbase + r0 + wr + i] : 0.f;
  }
  for (Step st = merged_walk(w, r0, g.rows, h, BN, u_list, u_owners); st.t < st.n; st.t += st.nbt) {
    const int e0 = st.list[st.t];
    for (st.sub = 0; st.sub < w.blk; st.sub += st.span) {
      if (st.nbt == 1 && w.causal && e0 == qi && e0 * w.blk + st.sub > last_row) break;
      __syncthreads();
      stage_step<T, D, BN, LDT>(sK, k, b, h, st, w);
      stage_step<T, D, BN, LDT>(sV, v, b, h, st, w);
      __syncthreads();
      const Cols<CPL> cols(st, w, own, gw, lane);
      if (!cols.any()) continue;
      warp_nt<BN, D>(sSw, LDS, sQ + wr * LDT, LDT, sK, LDT);
      warp_nt<BN, D>(sdPw, LDS, sdO + wr * LDT, LDT, sV, LDT);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = r0 + wr + i;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          const float x = sSw[i * LDS + c] * w.scale;
          const float s = !cols.valid[j] || (cols.diag[j] && cols.pos[j] > row) ? kNegInf : x;
          const float p = s <= kNegInf ? 0.f : expf(s - lse_i[i]);
          sdSw[i * LDP + c] = from_float<T>(p * (sdPw[i * LDS + c] - delta_i[i]) * w.scale);
        }
      }
      __syncwarp();
      acc.template mma<BN>(sdSw, LDP, sK, LDT);  // dQ += dS K
    }
  }
  __syncwarp();
  if (r0 + wr >= w.S) return;
  acc.store(dq + ((static_cast<size_t>(b) * w.S + r0 + wr) * w.H + h) * D, static_cast<size_t>(w.H) * D, sSw);
}

// ---------------------------------------------------------------- dk / dv (fp32; bf16 in sparse_dkv.cu)
// Grid (S / rows, H, B), rows = min(blk, 16 * NW). Block rows are keys of key block kj; the block walks
// qidx[h, kj], the query blocks that attend it.
template <typename T, int D>
__global__ void __launch_bounds__(SpGeo<T, D>::NT)
sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, Walk w) {
  using G = SpGeo<T, D, SpTiles<T>::BN_DKV>;
  constexpr int BN = G::BN, LDT = G::LDT, LDS = G::LDS, LDP = G::LDP, LDO = G::LDO, CPL = BN / 32;
  const G g(G::dkv_rows(w.blk));
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* sK = reinterpret_cast<T*>(smem + off);
  off += g.tileT(g.rows);
  T* sV = reinterpret_cast<T*>(smem + off);
  off += g.tileT(g.rows);
  T* sQ = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  T* sdO = reinterpret_cast<T*>(smem + off);
  off += g.tileT(BN);
  float* sLse = reinterpret_cast<float*>(smem + off);
  off += G::vec();
  float* sDelta = reinterpret_cast<float*>(smem + off);
  off += G::vec();
  float* sS = reinterpret_cast<float*>(smem + off);
  off += g.tileS();
  float* sdP = reinterpret_cast<float*>(smem + off);
  off += g.tileS();
  T* sPt = reinterpret_cast<T*>(smem + off);
  off += g.tileP();
  T* sdS = reinterpret_cast<T*>(smem + off);
  off += g.tileP();
  float* sdK = reinterpret_cast<float*>(smem + off);
  off += g.tileO();
  float* sdV = reinterpret_cast<float*>(smem + off);

  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * g.rows, kj = r0 / w.blk;
  stage_rows<T, D, LDT>(sK, k, b, h, r0, g.rows, w);
  stage_rows<T, D, LDT>(sV, v, b, h, r0, g.rows, w);

  const int wr = 16 * warp;  // the warp's first key row in the block
  float* sSw = sS + wr * LDS;
  float* sdPw = sdP + wr * LDS;
  T* sPtw = sPt + wr * LDP;
  T* sdSw = sdS + wr * LDP;
  WarpAcc<T, D> acc_k(sdK + wr * LDO), acc_v(sdV + wr * LDO);
  const size_t rowbase = (static_cast<size_t>(b) * w.H + h) * w.S;
  for (Step st = list_walk(w, kj, h, BN); st.t < st.n; st.t += st.nbt) {
    const int e0 = st.list[st.t];
    if (e0 < 0) break;  // the end of the list: the rest is padding
    for (st.sub = 0; st.sub < w.blk; st.sub += st.span) {
      // every query of the tile precedes every key of the block
      if (st.nbt == 1 && w.causal && e0 == kj && e0 * w.blk + st.sub + BN - 1 < r0) continue;
      __syncthreads();
      stage_step<T, D, BN, LDT>(sQ, q, b, h, st, w);
      stage_step<T, D, BN, LDT>(sdO, dout, b, h, st, w);
      for (int c = threadIdx.x; c < BN; c += blockDim.x) {
        const int e = st.entry(c);
        sLse[c] = e >= 0 ? lse[rowbase + st.pos(c, e, w)] : 0.f;
        sDelta[c] = e >= 0 ? delta[rowbase + st.pos(c, e, w)] : 0.f;
      }
      __syncthreads();
      const Cols<CPL> cols(st, w, kj, 0, lane);
      warp_nt<BN, D>(sSw, LDS, sK + wr * LDT, LDT, sQ, LDT);   // S^T = K Q^T
      warp_nt<BN, D>(sdPw, LDS, sV + wr * LDT, LDT, sdO, LDT);  // dP^T = V dO^T
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int key = r0 + wr + r;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          const float x = sSw[r * LDS + c] * w.scale;
          const float s = !cols.valid[j] || (cols.diag[j] && cols.pos[j] < key) ? kNegInf : x;
          const float p = s <= kNegInf ? 0.f : expf(s - sLse[c]);
          sPtw[r * LDP + c] = from_float<T>(p);
          sdSw[r * LDP + c] = from_float<T>(p * (sdPw[r * LDS + c] - sDelta[c]) * w.scale);
        }
      }
      __syncwarp();
      acc_v.template mma<BN>(sPtw, LDP, sdO, LDT);  // dV += P^T dO
      acc_k.template mma<BN>(sdSw, LDP, sQ, LDT);   // dK += dS^T Q
    }
  }
  __syncwarp();
  const size_t base = ((static_cast<size_t>(b) * w.S + r0 + wr) * w.H + h) * D;
  const size_t stride = static_cast<size_t>(w.H) * D;
  acc_k.store(dk + base, stride, sSw);
  acc_v.store(dv + base, stride, sSw);
}

// ---------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *dq, *dk, *dv;
  int B;
  Walk w;
  cudaStream_t stream;
  const int* plan;  // the bf16 bodies' plan, and the dk/dv's workspace
  float* ws;
  int n_items, n_reduce, n_slots, max_entries, rows;
};

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Pass pass, const Args& a) {
  using G = SpGeo<T, D>;
  const G gf(G::fwd_rows());
  const size_t u_bytes = union_bytes(union_cap(a.w.blk, gf.rows, a.w.A, a.w.S));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (pass == kDkv) {
    using GK = SpGeo<T, D, SpTiles<T>::BN_DKV>;
    const GK gk(GK::dkv_rows(a.w.blk));
    const size_t smem = gk.dkv();
    if (smem > kMaxSmem) return kUnsupported;
    const dim3 grid((a.w.S + gk.rows - 1) / gk.rows, a.w.H, a.B);
    if ((err = allow_smem(sparse_dkv_kernel<T, D>, smem)) != cudaSuccess) return static_cast<int>(err);
    sparse_dkv_kernel<T, D><<<grid, 2 * gk.rows, smem, a.stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
                                                                   static_cast<T*>(a.dv), a.w);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (pass == kFwd ? gf.fwd() : gf.dq()) + u_bytes;
  if (smem > kMaxSmem) return kUnsupported;  // a merged list too long for shared memory
  const dim3 grid((a.w.S + gf.rows - 1) / gf.rows, a.w.H, a.B);
  const int threads = 2 * gf.rows;  // a warp per 16 rows
  if (pass == kFwd) {
    if ((err = allow_smem(sparse_fwd_kernel<T, D>, smem)) != cudaSuccess) return static_cast<int>(err);
    sparse_fwd_kernel<T, D><<<grid, threads, smem, a.stream>>>(q, k, v, static_cast<T*>(a.o),
                                                               static_cast<float*>(a.out_lse), a.w);
  } else {
    if ((err = allow_smem(sparse_dq_kernel<T, D>, smem)) != cudaSuccess) return static_cast<int>(err);
    sparse_dq_kernel<T, D><<<grid, threads, smem, a.stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(a.dq),
                                                              a.w);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(Pass pass, int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(pass, a);
    case 64: return launch<T, 64>(pass, a);
    case 128: return launch<T, 128>(pass, a);
    default: return kUnsupported;
  }
}

int run(Pass pass, int D, int dtype, const Args& a) {
  const Walk& w = a.w;
  if (w.blk != 16 && w.blk != 32 && w.blk != 64 && w.blk != 128) return kUnsupported;
  if (a.B < 0 || w.S < 0 || w.S % w.blk != 0 || w.H <= 0 || w.A <= 0 || a.B > 65535 || w.H > 65535 ||
      w.idx == nullptr)
    return kUnsupported;
  if (a.B == 0 || w.S == 0) return 0;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.o, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return kUnsupported;
  if (dtype == kFloat32) return dispatch_d<float>(pass, D, a);
  if (dtype != kBFloat16) return kUnsupported;
  // bf16: the register-resident bodies of sparse_fwd.cu, sparse_dq.cu and sparse_dkv.cu, over the plan
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const float *lse = static_cast<const float*>(a.lse), *delta = static_cast<const float*>(a.delta);
  switch (pass) {
    case kFwd: return sparse_fwd_bf16(q, k, v, a.plan, a.n_items, a.max_entries, a.rows, static_cast<bf16*>(a.o),
                                      static_cast<float*>(a.out_lse), a.B, w.S, w.H, D, w.blk, w.causal, w.scale,
                                      a.stream);
    case kDq: return sparse_dq_bf16(q, k, v, dout, lse, delta, a.plan, a.n_items, a.max_entries, a.rows,
                                    static_cast<bf16*>(a.dq), a.B, w.S, w.H, D, w.blk, w.causal, w.scale, a.stream);
    default: return sparse_dkv_bf16(q, k, v, dout, lse, delta, a.plan, a.n_items, a.n_reduce, a.n_slots,
                                    a.max_entries, a.rows, a.ws, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                                    a.B, w.S, w.H, D, w.blk, w.causal, w.scale, a.stream);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* idx, const void* plan, int B, int S, int H,
               int blk, int A, int n_items, int max_entries, int rows, float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.w = Walk{static_cast<const int*>(idx), A, S, H, blk, causal, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  a.plan = static_cast<const int*>(plan);
  a.n_items = n_items;
  a.max_entries = max_entries;
  a.rows = rows;
  return a;
}

}  // namespace
}  // namespace dstorch

// q, k, v (B, S, H, D) of `dtype`, contiguous; kidx (H, S / blk, A) int32, each
// row the ascending active key blocks of a query block, -1 padded (already cut
// to the block-level lower triangle when causal). o like q; lse (B, H, S) fp32.
// bf16 walks `plan` (int32 on the device: sparse_self_attention.py's
// query_plan table, with its n_items and max_entries, made for blocks of
// `rows` query rows); fp32 walks kidx and takes neither (null, zeros).
extern "C" int ds_sparse_fwd(const void* q, const void* k, const void* v, const void* kidx, const void* plan, void* o,
                             void* lse, int B, int S, int H, int D, int blk, int A, int n_items, int max_entries,
                             int rows, float scale, int causal, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, kidx, plan, B, S, H, blk, A, n_items, max_entries, rows, scale, causal, stream);
  a.o = o;
  a.out_lse = lse;
  return run(kFwd, D, dtype, a);
}

// dout like q; lse, delta (B, H, S) fp32 (delta = rowsum(o * dout)). dq like q.
// bf16 walks the forward's plan.
extern "C" int ds_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* kidx, const void* plan, void* dq, int B, int S, int H,
                                int D, int blk, int A, int n_items, int max_entries, int rows, float scale,
                                int causal, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, kidx, plan, B, S, H, blk, A, n_items, max_entries, rows, scale, causal, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  return run(kDq, D, dtype, a);
}

// qidx (H, S / blk, Aq) int32: each row the ascending query blocks that attend
// a key block, -1 padded. dk, dv like k. bf16 walks `plan` instead (int32 on
// the device: sparse_self_attention.py's dkv_plan table, with its n_items,
// n_reduce, n_slots and max_entries, made for blocks of `rows` key rows) and
// needs `ws`, fp32 (2, n_slots, B, rows, D), when n_slots > 0; fp32 takes
// neither (null, zeros).
extern "C" int ds_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, const void* qidx, const void* plan, void* ws, void* dk, void* dv,
                                 int B, int S, int H, int D, int blk, int Aq, int n_items, int n_reduce, int n_slots,
                                 int max_entries, int rows, float scale, int causal, int dtype, void* stream) {
  using namespace dstorch;
  Args a = make_args(q, k, v, qidx, plan, B, S, H, blk, Aq, n_items, max_entries, rows, scale, causal, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.ws = static_cast<float*>(ws);
  a.n_reduce = n_reduce;
  a.n_slots = n_slots;
  return run(kDkv, D, dtype, a);
}
