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
// The launch depends on host-known shapes only (the plan, ops/moe_grouped_gemm.py gemm_plan), so one
// configuration serves every routing and the step stays capturable:
// - Each group is cut into tiles of `rows` rows from its own first row, so a tile never straddles two experts:
//   at most ceil(R / rows) + E - 1 row tiles, whatever the routing, times the column tiles. Blocks find their
//   tiles from the offsets (staged in shared memory, clamped to [0, R] and made non-decreasing, so a malformed
//   table cannot send a block out of bounds); an empty expert takes no tile; rows outside [offsets[0],
//   offsets[E]) are not written (the wrapper's contract is offsets[0] = 0 and offsets[E] = R).
// - No atomics on the output, one writer for each element and sums in a fixed order: results repeat bit for
//   bit.
//
// What bounds it on this card. At a decode step (16 rows at the mixtral serve's bucket of 8, 128 at 64 tokens:
// 2 to 16 rows an expert at Mixtral's 8 experts) the bytes of the routed experts' weights, which each column
// tile streams once: 939 MB for Mixtral's wi over 8 experts, 0.28 ms at 3.35 TB/s. At a 768-token quantum
// (1,536 rows) still the bytes, with the products close behind (2 R K N operations, 0.18 ms for wi at 989
// TFLOP/s); at the serve's 2,048-token quantum (4,096 rows) the products (0.49 ms), with the weights' bytes
// more than half of that. On an H100 at 700 W (chip_smoke.py, phase moe_gemm) this body runs a decode step at
// 90-92 % of its bytes bound, 1,536 rows at 80-89 % of it (level with one torch._grouped_mm call), and 4,096
// rows at 61-62 % of the bf16 peak.
//
// The bf16 body (gg_wgmma_kernel):
// - Swap AB: wgmma's M is fixed at 64, so the expert's rows go on its N side. Each of two consumer warpgroups
//   computes out^T (its 64 weight columns x the tile's rows) = w^T x^T on wgmma m64nNk16, with the weight box
//   as the MN-major A operand (w is N-contiguous: a transposed shared-memory descriptor) and the x box as the
//   K-major B operand, both in the 128-byte swizzle in which TMA lands them. A tile is 128 weight columns by
//   16, 32, 64, 128 or 256 rows (the plan's pick from R / E); each tile's MMA is trimmed to the narrowest N
//   (16, 32, 64, 128, 192, 256) that holds its own rows, so a 2-row group of a decode step or a group's
//   8-row last tile does not pay for a full tile's products. (x as A would fill a 64-row MMA with a 2-row
//   group.)
// - TMA into a ring of 4 to 6 stages (64-deep boxes: two 64-column weight boxes from a 3D map over (E, K, N),
//   which zero-fills K's tail where a 2D view would read the next expert; x in boxes of up to 64 rows from a
//   2D map, only as many as the tile's rows reach), with full and empty mbarriers. One producer warpgroup, one
//   thread issuing, keeps the ring full; the consumers give a stage back once the products that read it are
//   done. The tensor maps are encoded on every call (cuTensorMapEncodeTiled through the runtime's entry-point
//   query, so the library links cudart only) and passed as __grid_constant__ parameters: a captured graph
//   keeps them by value, and a cache keyed on the pointer could go stale.
// - Blocks walk the tiles expert-major (each expert's column tiles, inside one its row tiles): the blocks in
//   flight share one expert's x rows, which stay in L2 while its weights stream past once. The epilogue
//   stages the fragment in the ring as an fp32 (rows x 128) tile and writes rows < `rows` with 16-byte
//   stores; a TMA store would clip only at the tensor's edge and overwrite the next group's rows. Up to 64
//   rows two blocks share an SM; 128 and 256 rows take one, with setmaxnreg moving registers from the
//   producer to the consumers' 64 x 256 accumulators. (A persistent grid, each block walking tiles in turn
//   with the epilogue written straight from the fragment while the producer ran on into the next tile, was
//   tried and dropped: slower at 4,096 rows, no faster at a decode step.)
// - A split K where the fewest tiles any routing can give (every row on one expert) leave SMs idle: the host
//   launches the slices from its shapes, and a block takes them only when the routing on the device gives
//   fewer tiles than the card has SMs; otherwise slice 0 takes all of K and the other slices' blocks leave at
//   once (a split costs 1-2 % at a decode step's usual routing). Each slice writes an fp32 partial to a
//   workspace, and the last slice of a tile to arrive (a per-tile counter that it resets) sums them in slice
//   order.
// It needs K and N multiples of 8 (TMA's 16-byte strides) and 16-byte aligned x, w and out. Not done: rows of
// a bucket's padding still go through the experts, x's rows are gathered by a copy before the first product
// (TMA has no row gather), and no thread block cluster multicasts a box to two SMs.
//
// The float32 body (gg_fp32_kernel) is the parity route: 64 x 64 tiles, FMA loops over fp32 tiles in shared
// memory, any K and N.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxExperts = 1024;

// The fp32 body's walk: stage the offsets in shared memory (clamped to [0, R], non-decreasing), then one thread
// walks the groups' row tiles to this block's. s_tile = (expert or -1, first row, rows). True when the block
// has a tile.
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

// The bf16 body's walk: blocks in expert-major order, each expert's column tiles in turn and, inside one, its
// row tiles, so the blocks in flight together share one expert's x rows (kept in L2 while its weights stream
// past) and the row tiles of one weight column tile run side by side (the weights come from device memory
// once). Block index L of a linear grid; s_tile = (expert or -1, first row, rows, column tile, the routing's
// tiles in all).
template <int BM>
__device__ __forceinline__ bool find_tile_expert_major(const int* __restrict__ offsets, int E, int R, int C,
                                                       int* s_off, int* s_tile) {
  for (int i = threadIdx.x; i <= E; i += blockDim.x) s_off[i] = min(max(__ldg(offsets + i), 0), R);
  __syncthreads();
  if (threadIdx.x == 0) {
    int l = blockIdx.x, expert = -1, row0 = 0, rows = 0, col = 0, total = 0, start = s_off[0];
    for (int e = 0; e < E; ++e) {
      const int end = max(s_off[e + 1], start);
      const int tiles = (end - start + BM - 1) / BM;
      if (expert < 0 && l < tiles * C) {
        expert = e;
        col = l / tiles;
        row0 = start + (l % tiles) * BM;
        rows = min(BM, end - row0);
      }
      l -= tiles * C;
      total += tiles * C;
      start = end;
    }
    s_tile[0] = expert;
    s_tile[1] = row0;
    s_tile[2] = rows;
    s_tile[3] = col;
    s_tile[4] = total;
  }
  __syncthreads();
  return s_tile[0] >= 0;
}

// ---------------------------------------------------------------- bf16 body
// Swap AB: each consumer warpgroup computes out^T (its 64 weight columns x the tile's rows) = w^T x^T on
// wgmma m64nNk16, the weight box as the MN-major A operand and the x box as the K-major B operand, both in
// the 128-byte swizzle in which TMA lands them. One producer warpgroup (one thread issuing) keeps the ring
// full; the consumers release a stage once the products that read it are done.
constexpr int kBK = 64;                  // k-depth of a stage: one 128-byte swizzled row of x
constexpr int kCols = 128;               // weight columns a block: 64 a consumer warpgroup
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreadsW = 384;           // and one producer warpgroup
constexpr int kWBox = 64 * kBK * 2;      // bytes of one warpgroup's weight box (64 columns x 64 k)
constexpr int kLDE = kCols + 4;          // fp32 epilogue rows: conflict-free fragment stores, 16-byte rows
constexpr int kEpilogueBarrier = 1;      // named barrier of the consumer threads

// Ring stages and blocks an SM by tile rows: up to 64 rows two blocks share an SM (the decode steps, where
// the weights' bytes bound the kernel and two rings keep more of them in flight); 128 and 256 rows take an
// SM each, with setmaxnreg moving registers from the producer to the consumers' 64 x 256 accumulators.
template <int BR>
struct Geo {
  static constexpr int XBOX = BR < 64 ? BR : 64;  // rows of x's TMA box
  static constexpr int X_BYTES = BR * kBK * 2;
  static constexpr int STAGE = 2 * kWBox + X_BYTES;
  static constexpr int STAGES = BR <= 32 ? 5 : BR == 64 ? 4 : BR == 128 ? 6 : 4;
  static constexpr int BLOCKS = BR <= 64 ? 2 : 1;
  static constexpr size_t smem = static_cast<size_t>(STAGES) * STAGE + 1024;  // + alignment of the swizzle atoms
  static_assert(STAGE % 1024 == 0, "stages keep the 1 KB alignment of the swizzle atoms");
  static_assert(BR * kLDE * 4 <= STAGES * STAGE, "the fp32 epilogue tile fits in the ring");
};

// The tile's k steps [kb, ke) on wgmma N = NE (the smallest width that holds the tile's rows): the weight box
// of this warpgroup and the x box of each stage, 4 k16 steps a stage (A 16 k rows = 2048 bytes further, B 32
// bytes further inside its swizzled rows).
template <int BR, int NE>
__device__ __forceinline__ void consume(float* acc, unsigned char* smem, uint64_t* full, uint64_t* empty, int kb,
                                        int ke, int wg) {
  using G = Geo<BR>;
  int s = 0, phase = 0, prev = -1;
  for (int i = kb; i < ke; ++i) {
    mbar_wait(&full[s], phase);
    unsigned char* st = smem + s * G::STAGE;
    const uint64_t da = wgmma_desc_sw128_mn(st + wg * kWBox), db = wgmma_desc_sw128(st + 2 * kWBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_ss_tn<NE>(acc, da + (kk * 2048 >> 4), db + (kk * 32 >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: give it back to the producer
    if (prev >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == G::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
}

// Grid ((row-tile slots) x (column tiles of 128), splits), walked by find_tile_expert_major. When the routing
// gives fewer than `split_below` tiles, slice z takes k boxes [z * steps, (z + 1) * steps); otherwise slice 0
// takes all of K and the other slices' blocks leave at once (they come last in the launch order).
template <int BR>
__global__ void __launch_bounds__(kThreadsW, Geo<BR>::BLOCKS)
gg_wgmma_kernel(__grid_constant__ const CUtensorMap xmap, __grid_constant__ const CUtensorMap wmap,
                const int* __restrict__ offsets, bf16* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ counters, int R, int K, int N, int E, int steps, int split_below) {
  using G = Geo<BR>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_tile[5];
  __shared__ __align__(8) uint64_t full[G::STAGES], empty[G::STAGES];
  __shared__ int is_last;
  if (!find_tile_expert_major<BR>(offsets, E, R, (N + kCols - 1) / kCols, s_off, s_tile)) return;
  const int expert = s_tile[0], row0 = s_tile[1], rows = s_tile[2];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1 KB aligned
  const int tid = threadIdx.x, n0 = s_tile[3] * kCols;
  const int splits = s_tile[4] < split_below ? static_cast<int>(gridDim.z) : 1;
  if (static_cast<int>(blockIdx.z) >= splits) return;
  const int nk = (K + kBK - 1) / kBK, kb = splits > 1 ? blockIdx.z * steps : 0;
  const int ke = splits > 1 ? min(nk, kb + steps) : nk;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every load
    if constexpr (G::BLOCKS == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      // x in boxes of XBOX rows, only as many as the tile's rows reach (its other rows' products are never
      // stored); rows past the group in the last box are loaded, never stored
      const int xboxes = (rows + G::XBOX - 1) / G::XBOX;
      int s = 0, phase = 0;
      for (int i = kb; i < ke; ++i) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kWBox + xboxes * G::XBOX * kBK * 2);
        unsigned char* st = smem + s * G::STAGE;
        tma_load_3d(st, &wmap, &full[s], n0, i * kBK, expert);
        tma_load_3d(st + kWBox, &wmap, &full[s], n0 + 64, i * kBK, expert);
        for (int b = 0; b < xboxes; ++b)
          tma_load_2d(st + 2 * kWBox + b * G::XBOX * kBK * 2, &xmap, &full[s], i * kBK, row0 + b * G::XBOX);
        if (++s == G::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (G::BLOCKS == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = tid >> 7;
  float acc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
  // the MMA's N trimmed to the tile's rows: a group's last tile, or a decode step's few rows, costs its rows
  int ne = BR;
  if constexpr (BR > 192) ne = rows <= 192 ? 192 : ne;
  if constexpr (BR > 128) ne = rows <= 128 ? 128 : ne;
  if constexpr (BR > 64) ne = rows <= 64 ? 64 : ne;
  if constexpr (BR > 32) ne = rows <= 32 ? 32 : ne;
  if constexpr (BR > 16) ne = rows <= 16 ? 16 : ne;
  switch (ne) {
    case 16: consume<BR, 16>(acc, smem, full, empty, kb, ke, wg); break;
    case 32: if constexpr (BR >= 32) consume<BR, 32>(acc, smem, full, empty, kb, ke, wg); break;
    case 64: if constexpr (BR >= 64) consume<BR, 64>(acc, smem, full, empty, kb, ke, wg); break;
    case 128: if constexpr (BR >= 128) consume<BR, 128>(acc, smem, full, empty, kb, ke, wg); break;
    case 192: if constexpr (BR >= 256) consume<BR, 192>(acc, smem, full, empty, kb, ke, wg); break;
    default: if constexpr (BR >= 256) consume<BR, 256>(acc, smem, full, empty, kb, ke, wg); break;
  }
  fence_regs(acc);

  // Epilogue: out^T's fragment -> an fp32 (rows x 128) tile in the ring (once both warpgroups are done with
  // it), then rows < `rows` to out (bf16) or, split, to this slice's fp32 partial. A TMA store would clip
  // only at the tensor's edge and overwrite the next group's rows.
  named_barrier(kEpilogueBarrier, kConsumers);
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int col = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // D row: the weight column
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      if (8 * j >= ne) break;
      const int r = 8 * j + 2 * t;  // D column: the tile's row
      tile[r * kLDE + col] = acc[4 * j];
      tile[(r + 1) * kLDE + col] = acc[4 * j + 1];
      tile[r * kLDE + col + 8] = acc[4 * j + 2];
      tile[(r + 1) * kLDE + col + 8] = acc[4 * j + 3];
    }
  }
  named_barrier(kEpilogueBarrier, kConsumers);
  if (splits == 1) {
    for (int i = tid; i < rows * (kCols / 8); i += kConsumers) {
      const int r = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
      if (n0 + c >= N) continue;  // N % 8 == 0: a run of 8 is all in or all out
      const float4 a = *reinterpret_cast<const float4*>(tile + r * kLDE + c);
      const float4 b = *reinterpret_cast<const float4*>(tile + r * kLDE + c + 4);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + n0 + c) =
          make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    return;
  }
  // Split K: this slice's partial to ws, then the last slice of the tile to arrive sums every partial in slice
  // order (bit for bit from run to run) and re-zeroes the tile's counter for the next launch.
  const size_t plane = static_cast<size_t>(R) * N;
  float* part = ws + blockIdx.z * plane + static_cast<size_t>(row0) * N + n0;
  for (int i = tid; i < rows * (kCols / 4); i += kConsumers) {
    const int r = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    if (n0 + c < N)
      *reinterpret_cast<float4*>(part + static_cast<size_t>(r) * N + c) =
          *reinterpret_cast<const float4*>(tile + r * kLDE + c);
  }
  __threadfence();
  named_barrier(kEpilogueBarrier, kConsumers);
  if (tid == 0) {
    is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    if (is_last) counters[blockIdx.x] = 0;
  }
  named_barrier(kEpilogueBarrier, kConsumers);
  if (!is_last) return;
  __threadfence();
  const float* base = ws + static_cast<size_t>(row0) * N + n0;
  for (int i = tid; i < rows * (kCols / 8); i += kConsumers) {
    const int r = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
    if (n0 + c >= N) continue;
    const float* src = base + static_cast<size_t>(r) * N + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    for (int z = 0; z < splits; ++z) {
      const float4 pa = __ldcg(reinterpret_cast<const float4*>(src + z * plane));
      const float4 pb = __ldcg(reinterpret_cast<const float4*>(src + z * plane + 4));
      a.x += pa.x;
      a.y += pa.y;
      a.z += pa.z;
      a.w += pa.w;
      b.x += pb.x;
      b.y += pb.y;
      b.z += pb.z;
      b.w += pb.w;
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + n0 + c) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
}

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's entry-point query (CUDA 12.5 or
// later), so the library links against cudart alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map, `rank` dims (innermost first) with byte strides of the outer dims, boxes of `box`, in the
// 128-byte swizzle (the box's inner extent is 128 bytes), zero-filled outside the tensor. Built on every call:
// a captured graph keeps it by value, but a cache keyed on the pointer would go stale when the allocator hands
// the address to a tensor of another shape.
bool encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BR>
int launch_bf16(const void* x, const void* w, const void* offsets, void* out, void* ws, void* counters, int R,
                int K, int N, int E, int splits, int steps, int split_below, cudaStream_t s) {
  using G = Geo<BR>;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(R)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {kBK, G::XBOX};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(E)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(N) * 2, static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t wbox[3] = {64, kBK, 1};
  if (!encode_map(&xmap, x, 2, xdims, xstrides, xbox) || !encode_map(&wmap, w, 3, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gg_wgmma_kernel<BR>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((R + BR - 1) / BR + E) * ((N + kCols - 1) / kCols), 1, splits);
  gg_wgmma_kernel<BR><<<grid, kThreadsW, G::smem, s>>>(xmap, wmap, static_cast<const int*>(offsets),
                                                       static_cast<bf16*>(out), static_cast<float*>(ws),
                                                       static_cast<int*>(counters), R, K, N, E, steps,
                                                       split_below);
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

// x (R, K), w (E, K, N) and out (R, N) contiguous of `dtype`; offsets (E + 1,) int32 on the device. The
// host's plan (ops/moe_grouped_gemm.py gemm_plan): `rows` a tile (bf16: 16, 32, 64, 128 or 256; float32: 64)
// and, bf16 only, `splits` slices of K of `steps` 64-deep boxes each (the last may be shorter, none empty),
// taken when the routing gives fewer than `split_below` tiles. The grid is (ceil(R / rows) + E) x ceil(N /
// tile columns) tiles, x splits. When splits > 1, `ws` is fp32 (splits, R, N) and `counters` int32, one per
// tile, zero on entry (the kernel leaves them zero). Returns 0, a cudaError_t, or kUnsupported.
extern "C" int ds_moe_grouped_gemm(const void* x, const void* w, const void* offsets, void* out, void* ws,
                                   void* counters, int R, int K, int N, int E, int rows, int splits, int steps,
                                   int split_below, int dtype, void* stream) {
  using namespace dstorch;
  if (R <= 0 || N <= 0) return 0;
  if (E <= 0 || E > kMaxExperts || K <= 0) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (rows != BMF || splits != 1) return kUnsupported;
    const dim3 grid((R + BMF - 1) / BMF + E, (N + BNF - 1) / BNF);
    gg_fp32_kernel<<<grid, kThreadsF, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                               static_cast<const int*>(offsets), static_cast<float*>(out), R, K,
                                               N, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kBFloat16) return kUnsupported;
  const int nk = (K + kBK - 1) / kBK;
  if (K % 8 || N % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out) || splits < 1 || splits > 65535 ||
      steps < 1 || static_cast<long long>(splits - 1) * steps >= nk || static_cast<long long>(splits) * steps < nk ||
      (splits > 1 && (ws == nullptr || counters == nullptr || !aligned16(ws))))
    return kUnsupported;
  switch (rows) {
    case 16: return launch_bf16<16>(x, w, offsets, out, ws, counters, R, K, N, E, splits, steps, split_below, s);
    case 32: return launch_bf16<32>(x, w, offsets, out, ws, counters, R, K, N, E, splits, steps, split_below, s);
    case 64: return launch_bf16<64>(x, w, offsets, out, ws, counters, R, K, N, E, splits, steps, split_below, s);
    case 128:
      return launch_bf16<128>(x, w, offsets, out, ws, counters, R, K, N, E, splits, steps, split_below, s);
    case 256:
      return launch_bf16<256>(x, w, offsets, out, ws, counters, R, K, N, E, splits, steps, split_below, s);
    default: return kUnsupported;
  }
}
