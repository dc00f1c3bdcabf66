// Grouped GEMM with device-side group offsets for Hopper: the expert products of MoE serving.
//
// out[r] = x[r] @ w[e] for every row r of group e, where x (R, K) holds its rows sorted by expert, w (E, K, N)
// is the flax layout of the stacked experts (wi, wg: K = d, N = f; wo: K = f, N = d), and group e is the rows
// [offsets[e], offsets[e + 1]) of an int32 (E + 1,) cumulative table that lives in device memory. This is
// lax.ragged_dot(x, w, group_sizes) of the reference's serving module (deepspeed_tpu/inference/v2/modules.py
// moe_tpu, :195-203), which is plain XLA and not a Pallas kernel: this kernel replaces no TPU kernel. It exists
// because the group sizes are known only on the device. A loop of matmuls over the experts needs them on the
// host, and reading them back is a sync, which a captured CUDA graph (inference/v2/graphs.py) cannot hold.
// Upstream DeepSpeed-FastGen runs CUTLASS's grouped GEMM here (cutlass_multi_gemm).
//
// The launch depends on host-known shapes only, so one configuration serves every routing and the step
// stays capturable:
// - The grid is (ceil(R / BM) + E) row tiles x ceil(N / BN) column tiles. Each group is cut into tiles of BM
//   rows from its own first row, so a tile never straddles two experts; the groups need at most
//   sum_e ceil(size_e / BM) <= ceil(R / BM) + E - 1 tiles, whatever the routing. A block finds its (expert,
//   rows) by one thread's scan of the offsets, staged in shared memory, and exits if its index is past the
//   last tile. An empty expert takes no tile; one expert with every row takes ceil(R / BM).
// - Offsets are clamped to [0, R] and made non-decreasing before the scan, so a malformed table cannot send a
//   block out of bounds; rows outside [offsets[0], offsets[E]) are not written (the wrapper's contract is
//   offsets[0] = 0 and offsets[E] = R).
// - No atomics and one thread per output element in a fixed order: results repeat bit for bit.
//
// What bounds it on this card. At a decode step (R = 128 rows: 64 tokens x top-2, about 16 rows an expert at
// Mixtral's 8 experts) the bytes of the routed experts' weights, which every column tile streams once per row
// tile of its expert: 939 MB for Mixtral's wi over 8 experts, 0.28 ms at 3.35 TB/s. At a prefill quantum
// (R = 1536) still the bytes, but closer to the products (2 R K N operations, 0.18 ms for wi at 989 TFLOP/s).
//
// The bf16 body (gg_bf16_kernel): 4 warps side by side along N, a tile of BM x 128 outputs (BM 32 while an
// expert averages at most 16 rows, else 64, chosen by the wrapper from R / E), mma.sync m16n8k16 with fp32
// accumulators, a 4-stage cp.async ring of 32-deep slices of x's rows and the expert's weights (zero-filled
// past the tile's rows and past K and N), padded rows for conflict-free ldmatrix (the weights through
// ldmatrix.trans, since w is K-major). It needs K and N multiples of 8 and 16-byte aligned x and w. Not yet:
// wgmma and TMA, a persistent grid, gathering the rows inside the first product, a split K for the
// few-row-tile decode grid of wo.
//
// The float32 body (gg_fp32_kernel) is the parity route: 64 x 64 tiles, FMA loops over fp32 tiles in shared
// memory, any K and N.
#include "common.cuh"
#include "mma.cuh"

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxExperts = 1024;

// Stage the offsets in shared memory (clamped to [0, R], non-decreasing), then one thread walks the groups'
// tiles to this block's. s_tile = (expert or -1, first row, rows). True when the block has a tile.
template <int BM>
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int E, int R, int* s_off, int* s_tile) {
  for (int i = threadIdx.x; i <= E; i += blockDim.x) s_off[i] = min(max(__ldg(offsets + i), 0), R);
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = blockIdx.x, expert = -1, row0 = 0, rows = 0, start = s_off[0];
    for (int e = 0; e < E; ++e) {
      const int end = max(s_off[e + 1], start);
      const int tiles = (end - start + BM - 1) / BM;
      if (t < tiles) {
        expert = e;
        row0 = start + t * BM;
        rows = min(BM, end - row0);
        break;
      }
      t -= tiles;
      start = end;
    }
    s_tile[0] = expert;
    s_tile[1] = row0;
    s_tile[2] = rows;
  }
  __syncthreads();
  return s_tile[0] >= 0;
}

// ---------------------------------------------------------------- bf16 body
constexpr int kThreads = 128;
constexpr int BN = 128;         // output columns a block: 32 a warp
constexpr int BK = 32;          // k-depth of a ring stage
constexpr int kStages = 4;
constexpr int kPad = 8;         // elements of row padding
constexpr int LDA = BK + kPad;  // 80-byte rows: the 8 rows of an ldmatrix fall in distinct banks
constexpr int LDB = BN + kPad;  // 272-byte rows: likewise

template <int BM>
constexpr size_t bf16_smem() {
  return static_cast<size_t>(kStages) * (BM * LDA + BK * LDB) * sizeof(bf16);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
gg_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const int* __restrict__ offsets,
               bf16* __restrict__ out, int R, int K, int N, int E) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_tile[3];
  if (!find_tile<BM>(offsets, E, R, s_off, s_tile)) return;
  const int expert = s_tile[0], row0 = s_tile[1], rows = s_tile[2];

  constexpr int MT = BM / 16;  // m16 tiles a warp
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][LDA]
  bf16* sB = sA + kStages * BM * LDA;            // [kStages][BK][LDB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const bf16* xt = x + static_cast<size_t>(row0) * K;
  const bf16* we = w + static_cast<size_t>(expert) * K * N;

  auto load = [&](int stage, int k0) {
    bf16* a = sA + stage * BM * LDA;
    bf16* b = sB + stage * BK * LDB;
#pragma unroll
    for (int i = tid; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + c < K;
      cp_async16(a + r * LDA + c, ok ? xt + static_cast<size_t>(r) * K + k0 + c : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BK * BN / 8; i += kThreads) {
      const int kr = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + kr < K && n0 + c < N;
      cp_async16(b + kr * LDB + c, ok ? we + static_cast<size_t>(k0 + kr) * N + n0 + c : w, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed for every thread, and stage kt - 1 is no longer read
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt * BK);
    cp_async_commit();
    const bf16* a = sA + (kt % kStages) * BM * LDA;
    const bf16* b = sB + (kt % kStages) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldsm_x4(af[mi], a + (mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r4[4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of the pair
        ldsm_x4_t(r4, b + (kk + (lane & 15)) * LDB + warp * 32 + nj * 8 + (lane >> 4) * 8);
        bfr[nj][0] = r4[0];
        bfr[nj][1] = r4[1];
        bfr[nj + 1][0] = r4[2];
        bfr[nj + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  bf16* ot = out + static_cast<size_t>(row0) * N;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int col = n0 + warp * 32 + nj * 8 + 2 * t;  // even, and N % 8 == 0: col + 1 < N when col < N
    if (col >= N) continue;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = mi * 16 + g;
      if (r < rows)
        *reinterpret_cast<__nv_bfloat162*>(ot + static_cast<size_t>(r) * N + col) =
            __floats2bfloat162_rn(acc[mi][nj][0], acc[mi][nj][1]);
      if (r + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(ot + static_cast<size_t>(r + 8) * N + col) =
            __floats2bfloat162_rn(acc[mi][nj][2], acc[mi][nj][3]);
    }
  }
}

template <int BM>
int launch_bf16(const void* x, const void* w, const void* offsets, void* out, int R, int K, int N, int E,
                cudaStream_t s) {
  constexpr size_t smem = bf16_smem<BM>();
  // always raise the cap: with the offsets' static shared memory, 32-row tiles pass 48 KB in all
  static const cudaError_t attr = cudaFuncSetAttribute(gg_bf16_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((R + BM - 1) / BM + E, (N + BN - 1) / BN);
  gg_bf16_kernel<BM><<<grid, kThreads, smem, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                                  static_cast<const int*>(offsets), static_cast<bf16*>(out), R, K,
                                                  N, E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- float32 body
constexpr int kThreadsF = 256;
constexpr int BMF = 64;
constexpr int BNF = 64;
constexpr int BKF = 16;

__global__ void __launch_bounds__(kThreadsF)
gg_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ offsets,
               float* __restrict__ out, int R, int K, int N, int E) {
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_tile[3];
  __shared__ float sA[BKF][BMF + 4];  // x's tile, k-major
  __shared__ float sB[BKF][BNF + 4];
  if (!find_tile<BMF>(offsets, E, R, s_off, s_tile)) return;
  const int expert = s_tile[0], row0 = s_tile[1], rows = s_tile[2];
  const int tid = threadIdx.x, n0 = blockIdx.y * BNF;
  const float* we = w + static_cast<size_t>(expert) * K * N;
  // thread (ty, tx) owns rows 4 ty + i and columns tx + 16 j
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BKF) {
    for (int i = tid; i < BMF * BKF; i += kThreadsF) {
      const int r = i / BKF, c = i % BKF;
      sA[c][r] = (r < rows && k0 + c < K) ? x[static_cast<size_t>(row0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < BKF * BNF; i += kThreadsF) {
      const int kr = i / BNF, c = i % BNF;
      sB[kr][c] = (k0 + kr < K && n0 + c < N) ? we[static_cast<size_t>(k0 + kr) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[static_cast<size_t>(row0 + r) * N + col] = acc[i][j];
    }
  }
}

}  // namespace
}  // namespace dstorch

// x (R, K), w (E, K, N) and out (R, N) contiguous of `dtype`; offsets (E + 1,) int32 on the device. bm: rows
// a tile (bf16: 32 or 64; float32: 64), chosen by the wrapper; the grid is (ceil(R / bm) + E) x
// ceil(N / tile columns). Returns 0, a cudaError_t, or kUnsupported.
extern "C" int ds_moe_grouped_gemm(const void* x, const void* w, const void* offsets, void* out, int R, int K,
                                   int N, int E, int bm, int dtype, void* stream) {
  using namespace dstorch;
  if (R <= 0 || N <= 0) return 0;
  if (E <= 0 || E > kMaxExperts || K < 0) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (bm != BMF) return kUnsupported;
    const dim3 grid((R + BMF - 1) / BMF + E, (N + BNF - 1) / BNF);
    gg_fp32_kernel<<<grid, kThreadsF, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                               static_cast<const int*>(offsets), static_cast<float*>(out), R, K,
                                               N, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kBFloat16) return kUnsupported;
  if (K % 8 || N % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out)) return kUnsupported;
  switch (bm) {
    case 32: return launch_bf16<32>(x, w, offsets, out, R, K, N, E, s);
    case 64: return launch_bf16<64>(x, w, offsets, out, R, K, N, E, s);
    default: return kUnsupported;
  }
}
