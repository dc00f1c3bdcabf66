// The bfloat16 flash attention backward for Hopper: dq, and dk/dv, from q, k,
// v, dout and the forward's lse with delta = rowsum(o * dout), with optional
// ALiBi slopes, a causal mask, a sliding window, GQA and an additive fp32 bias
// (dq then also writes dbias, per program or summed over the programs that
// share a bias slice).
//
// Replaces, for bf16, the TPU kernels of deepspeed_tpu/ops/pallas/
// flash_attention.py: _dq_kernel (pallas_call at :417, via _flash_bwd: the
// body without a bias, and the has_bias body that writes dbias per program),
// _dq_kernel_collapsed (:456: dq plus dbias summed over the programs that
// share a bias slice), _dkv_kernel (:485: dk/dv with the bias tile) and
// _dkv_kernel_gqa (:518). The float32 bodies, the collapsed dq's plan and
// the fixed-order reduce of its partials stay in flash_attention.cu. Both
// kernels recompute the score with
// masked_score's arithmetic and mask (`visible`, flash_common.cuh) and
// p = exp(s - lse); dlogits = p (dp - delta) and ds = dlogits * scale,
// rounded to bf16 where the plain version rounds it (as the A operand of the
// next product), as is p in dk/dv; dbias = dlogits in fp32.
//
// What bounds it: at gpt2_1_3b's training shape (B 8, S 1024, H 32, D 64,
// causal) dq does 3 products of 17 GFLOP each (S = Q K^T, dP = dO V^T,
// dQ = dS K) and dk/dv 4 (S^T, dP^T, dV = P^T dO, dK = dS^T Q), against
// about 170 MB of operands: both are bound by the tensor cores (0.052 and
// 0.070 ms at 989 TFLOP/s). So the products have to stay on the tensor
// cores, fed from shared memory by ldmatrix, and nothing else may take their
// time: no score, probability or accumulator goes through shared memory.
// With an evoformer bias (D 32, S 256-384) the fp32 bias is the largest
// tensor and about 200 flops meet each 8 bytes of bias and dbias: dq reads
// the bias and writes dbias (268 MB each at msa_row, 1.6 ms at 3.35 TB/s for
// the 384 x 512 crop's 2.4 GB each) and dk/dv reads the bias again, so both
// are bound by those bytes (0.186 and 0.111 ms at msa_row). There the design
// has to keep the bias streaming at the card's memory rate: about 25 KB in
// flight per SM, dbias stored in whole 32-byte sectors, nothing atomic.
//
// The design (FlashAttention-2's backward on mma.sync, as two kernels
// without atomics, so dq, dbias, dk and dv repeat bit for bit):
// - dq: a block owns 128 query rows of one (batch, head), 8 warps of 16 rows,
//   and walks the key tiles of the causal or window band. A warp's S and dP
//   stripes are mma.sync m16n8k16 products (bf16 in, fp32 out) in registers:
//   Q and dO fragments by ldmatrix, K and V by ldmatrix as the B operand.
//   dS is formed on the fragments, and its C layout, rounded to bf16 pairs,
//   is the A layout of dQ += dS K (K by the transposing ldmatrix). dQ is an
//   fp32 register accumulator, written once.
// - dk/dv: the transposed problem. A block owns 64 key rows of one (batch,
//   KV head), 4 warps of 16 keys, and walks, for each of the H / KVH query
//   heads of that KV head in order, the query tiles that see its keys. With
//   64 keys a block, llama3_8b's heads at S 2048 (8 KV heads) give 256
//   blocks, two for each of the 132 SMs. S^T = K Q^T and
//   dP^T = V dO^T take Q and dO as the non-transposed B operand; P^T and
//   dS^T go from their C fragments to dV += P^T dO and dK += dS^T Q, with
//   dO and Q through the transposing ldmatrix. lse and delta of the tile's
//   query columns come with the tile. dK and dV are fp32 register
//   accumulators, summed over the group's heads in a fixed order.
// - A warp takes its products over a sub-tile of KS keys (dq: 32, at D 128
//   or with a bias 64) or QS queries (dk/dv: 32, at D 128 16) at a time,
//   which keeps the S and dP fragments small beside the accumulators (at
//   D 128, dK and dV alone hold 128 fp32 a lane). The choices are
//   flash_bwd_probe.py's: on an H100, dk/dv with 8 warps a block spilled at
//   D 64 within the 128 registers of two blocks an SM, and 4 warps at three
//   blocks an SM ran as fast without spilling; dq at D 128 took 6 % less
//   time with 64 keys a sub-tile. With a bias, dq at two blocks an SM
//   spilled within 128 registers; one block of 240 registers and 64 keys a
//   sub-tile ran 7-10 % faster at msa_row and the crop, without a spill.
// - The streamed tiles (K and V for dq; Q, dO, lse and delta for dk/dv) come
//   through a ring of 2 stages in shared memory, filled by cp.async (zero past
//   the end) while the other stage multiplies, with one block barrier a tile.
// - The bias (BIAS, a compile-time parameter: the bodies without one carry no
//   bias code) is one more part of each stage: dq's (128 query rows x 64
//   keys, 32 KB) and dk/dv's (64 query rows x 64 keys, 16 KB, or the one row
//   when every query row shares it) come by 16-byte cp.async copies along the
//   keys (4-byte ones when Sk is not a multiple of 4), so one tile's bias
//   flies while the other multiplies: 32 KB a SM for dq at D 32 (one block)
//   and 48 KB for dk/dv (three). dq reads its rows back as float2 in the S
//   fragment layout (rows 72 floats apart: a half-warp's 4 rows on distinct
//   banks), dk/dv down the query rows (68 apart: 4 rows of 8 keys on distinct
//   banks). The alternatives lost or spilled on an H100: dq's bias read from
//   device memory straight into the fragments before the sub-tile's
//   products, as the forward does, was slower; in flash_bwd_probe.py a
//   third stage (STAGES 3) gained dq at most 1.5 % and
//   spilled at D 64, and slowed dk/dv (two blocks an SM); dk/dv with 8 warps
//   ran 6-11 % faster but spilled in its ALiBi body.
// - dbias is stored straight from the dS fragments as float2 with streaming
//   stores: a quad writes a whole 32-byte sector of a row, and the 268 MB do
//   not evict K and V from L2. A warp owns its rows' dbias: a sub-tile that
//   no row of it sees, and the key tiles the block's walk skips, get zeros.
// - The collapsed dq (a bias slice shared by n_rep programs: at msa_row_pair
//   128 MSA rows share each head's (256, 256) pair bias, at msa_col 8 heads
//   share each row's mask row). There the bias is 2 MB and stays in L2, and
//   what bounds the TPU kernel's carried dbias block here is the sum: a block
//   walks a chunk of the sharing programs in the reference's order (Q and dO
//   of the next program come with its first key tile, in a second buffer
//   where it fits, D <= 64), with this body's ring, fragments and dQ
//   accumulator, dq written per program. Sqb == Sq: each lane adds its
//   dlogits fragments into the block's own rows of an fp32 partial, read and
//   written in L2 (__ldcg / __stcg; the reads issued before the sub-tile's
//   products); the first program stores. Sqb == 1: each warp sums its 16 rows
//   on the fragments (shuffles across the quads' rows) into Sk floats of
//   shared memory, kept over the chunk and written once. Each partial has
//   one owner and a fixed order, and flash_attention.cu sums the partials in
//   a fixed order: no atomics, dq and dbias repeat bit for bit. The plan
//   (flash_attention.cu) sizes the chunks to whole waves of one block an SM
//   and keeps the partials below the expanded bias.
// - Mask arithmetic only where a mask can act: a warp takes the masked body
//   for a sub-tile only if it crosses Sq, Sk or the causal or window edge for
//   its 16 rows, skips a sub-tile that no row of it sees, and otherwise runs
//   the unmasked body; the two bodies are compile-time copies.
// - p = 2^x by one ex2.approx. Without ALiBi or a bias, x = q.k scale
//   log2(e) - lse log2(e) is one FFMA; with either, the score is formed first
//   as the plain version forms it (q.k scale + slope key + bias) and
//   x = (s - lse) log2(e). An evoformer mask bias of -1e9 is a finite score:
//   a row whose keys all carry it has lse about -1e9, and its p comes out as
//   in the plain version. A row that sees no key has lse = kNegInf, so x is
//   huge there; it only ever meets the masked body, which selects p = 0 for
//   a masked pair before any product.
// - Longest work first: dq's grid enumerates the last query tiles first,
//   dk/dv's the first key tiles (a causal mask gives them the most queries).
// Not yet: wgmma (a warpgroup's 64 rows with K, V or Q, dO as shared-memory
// operands), TMA, warp specialisation, a persistent grid.
#include "flash_common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace dstorch {
namespace {

using bf16 = __nv_bfloat16;

// What dq does with its dlogits: nothing (no bias); store them per program (kPerProgram: dbias (B*H, Sq,
// Sk)); or, the collapsed dq, sum them over the programs of the block's chunk that share a bias slice:
// into the block's rows of an fp32 partial (kSumRows, Sqb == Sq), or each warp's column sums over its 16
// rows into an fp32 row of its own (kSumCols, Sqb == 1).
enum DqBias { kNoBias = 0, kPerProgram = 1, kSumRows = 2, kSumCols = 3 };

// dq: 8 warps of 16 query rows; key tiles of BN through the ring, taken KS keys at a time.
template <int D, int DB>
struct DqGeo {
  static constexpr bool BIAS = DB != kNoBias, SUM = DB >= kSumRows;
  static constexpr int NW = 8, NT = 32 * NW, BM = 16 * NW, BN = 64, KS = D <= 64 && !BIAS ? 32 : 64;
  static constexpr int STAGES = 2;  // the ring's depth: tiles in flight while one multiplies, plus one
  static constexpr int MIN_BLOCKS = D <= 64 && !BIAS ? 2 : 1;
  static constexpr int LD = D + 8;    // +16 bytes: ldmatrix rows on distinct banks
  static constexpr int LDB = BN + 8;  // fp32 bias rows: a half-warp's float2 reads of 4 rows on distinct banks
  static constexpr size_t q_bytes = static_cast<size_t>(BM) * LD * 2;
  static constexpr size_t kv_bytes = static_cast<size_t>(BN) * LD * 2;
  // the bias of a stage: BM rows, or the one row every query row shares (kSumCols)
  static constexpr size_t b_bytes = !BIAS ? 0 : DB == kSumCols ? BN * 4 : static_cast<size_t>(BM) * LDB * 4;
  static constexpr size_t ring = STAGES * (2 * kv_bytes + b_bytes);  // K, V, bias a stage
  // the collapsed dq walks several programs: their Q and dO alternate between two buffers where both fit,
  // so that the next program's come with its first key tile
  static constexpr int QBUF = SUM && 4 * q_bytes + ring <= 200 * 1024 ? 2 : 1;
  static constexpr size_t smem = 2 * QBUF * q_bytes + ring;  // Q, dO (per buffer), then the ring
};

// dk/dv: NW warps of 16 key rows; query tiles of BN through the ring, taken QS queries at a time.
template <int D, bool BIAS>
struct DkvGeo {
  static constexpr int NW = 4, NT = 32 * NW, BM = 16 * NW, BN = 64, QS = D <= 64 ? 32 : 16;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = D <= (BIAS ? 32 : 64) ? 3 : (BIAS && D > 64 ? 1 : 2);
  static constexpr int LD = D + 8;
  static constexpr int LDB = BM + 4;  // fp32 bias rows, read down the query rows: 4 rows of 8 keys on distinct banks
  static constexpr size_t kv_bytes = static_cast<size_t>(BM) * LD * 2;
  static constexpr size_t q_bytes = static_cast<size_t>(BN) * LD * 2;
  static constexpr size_t vec_bytes = static_cast<size_t>(BN) * 4;
  static constexpr size_t b_bytes = BIAS ? static_cast<size_t>(BN) * LDB * 4 : 0;
  static constexpr size_t stage_bytes = 2 * q_bytes + 2 * vec_bytes + b_bytes;  // Q, dO, lse, delta, bias
  static constexpr size_t smem = 2 * kv_bytes + STAGES * stage_bytes;             // K, V, then the stages
};

// Rows [r0, r0 + ROWS) of head h of a (B, S, NH, D) bf16 tensor into shared memory (row stride LD) by
// cp.async, zero-filled at or past S; NT threads.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ x, int b, int S, int NH, int h, int r0) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + c, ok ? x + ((static_cast<size_t>(b) * S + r0 + r) * NH + h) * D + c : x, ok ? 16 : 0);
  }
}

// `rows` rows from r0 and COLS keys from c0 of an fp32 (nrows, sk) bias slice into shared memory (row
// stride LDB) by cp.async, zero-filled at or past nrows and sk: 16-byte copies when `vec` (sk a multiple
// of 4 and the slice 16-byte aligned), else 4-byte ones; NT threads.
template <int COLS, int LDB, int NT>
__device__ __forceinline__ void load_bias(float* dst, const float* __restrict__ bs, int rows, int r0, int nrows,
                                          int c0, int sk, int vec) {
  if (vec) {
    constexpr int VPR = COLS / 4;
    for (int i = threadIdx.x; i < rows * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 4;
      const bool ok = r0 + r < nrows && c0 + c < sk;
      cp_async16(dst + r * LDB + c, ok ? bs + static_cast<size_t>(r0 + r) * sk + c0 + c : bs, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r0 + r < nrows && c0 + c < sk;
      cp_async4(dst + r * LDB + c, ok ? bs + static_cast<size_t>(r0 + r) * sk + c0 + c : bs, ok ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------- dq
// Grid (n_qt * H, B): x = (n_qt - 1 - query tile) * H + head. kPerProgram: the bias slice of program (b, h)
// is (Sq, Sk) (nothing collapses), and dbias (B*H, Sq, Sk) fp32 receives every pair's dlogits.
// The collapsed dq (kSumRows, kSumCols): grid (n_qt * n_bh, n_chunks): x = slice * n_qt + n_qt - 1 - query
// tile; chunk y walks programs [y * per, min(n_rep, (y + 1) * per)) of the n_rep that share the slice, in
// the reference's order, and `dbias` holds the partials: kSumRows rows [q0, q0 + BM) of part[y] (n_chunks,
// n_bh, Sq, Sk); kSumCols each warp's row part[(y * n_qt + query tile) * NW + warp] of (n_parts, n_bh, 1, Sk).
template <int D, bool ALIBI, int DB>
__device__ __forceinline__ void
dq_bf16_body(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ slopes, Bias bias, bf16* __restrict__ dq, float* __restrict__ dbias,
             int H, int KVH, Mask mk, int n_qt, int vec, int n_rep, int per) {
  using G = DqGeo<D, DB>;
  constexpr bool BIAS = G::BIAS, SUM = G::SUM;
  constexpr int LD = G::LD, LDB = G::LDB, BM = G::BM, BN = G::BN, KS = G::KS, NT = G::NT, NW = G::NW;
  constexpr int KD = D / 16, NS = KS / 8, NO = D / 8, ST = G::STAGES, QB = G::QBUF;
  constexpr bool FOLD = !ALIBI && !BIAS;  // x = q.k scale log2(e) - lse log2(e) as one FFMA
  extern __shared__ __align__(128) unsigned char smem[];
  auto sQ = [&](int i) { return reinterpret_cast<bf16*>(smem + 2 * i * G::q_bytes); };
  auto sdO = [&](int i) { return reinterpret_cast<bf16*>(smem + (2 * i + 1) * G::q_bytes); };
  unsigned char* ring = smem + 2 * QB * G::q_bytes;
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(ring + (2 * s) * G::kv_bytes); };
  auto sV = [&](int s) { return reinterpret_cast<bf16*>(ring + (2 * s + 1) * G::kv_bytes); };
  auto sB = [&](int s) { return reinterpret_cast<float*>(ring + 2 * ST * G::kv_bytes + s * G::b_bytes); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  // the block's query tile and the programs it walks: one, (b0, h0), or programs r0 .. r0 + n_prog - 1 of
  // those that share bias slice sl
  int qt, sl = 0, r0 = 0, n_prog = 1, b0 = 0, h0 = 0;
  if constexpr (SUM) {
    qt = n_qt - 1 - static_cast<int>(blockIdx.x) % n_qt;
    sl = static_cast<int>(blockIdx.x) / n_qt;
    r0 = blockIdx.y * per;
    n_prog = min(n_rep - r0, per);
  } else {
    h0 = blockIdx.x % H;
    qt = n_qt - 1 - static_cast<int>(blockIdx.x) / H;
    b0 = blockIdx.y;
  }
  auto program = [&](int pi, int& b, int& h) {
    if constexpr (SUM) {
      const int p = sharing_program(bias, sl, r0 + pi, H);
      b = p / H;
      h = p % H;
    } else {
      b = b0;
      h = h0;
    }
  };
  const int q0 = qt * BM, wr = q0 + 16 * warp;  // the block's and the warp's first rows
  const float scale2 = mk.scale * kLog2e;

  int kt_begin = 0, kt_end = (mk.sk + BN - 1) / BN;
  if (mk.causal) {
    const int last = mk.offset + min(q0 + BM, mk.sq) - 1;  // the last key any row of the block sees
    kt_end = min(kt_end, last < 0 ? 0 : last / BN + 1);
    if (mk.window > 0) kt_begin = max(mk.offset + q0 - mk.window + 1, 0) / BN;
  }
  const int n_kt = max(kt_end - kt_begin, 0), n_it = n_prog * n_kt;  // iteration it: program it / n_kt

  // the bias every program of the block reads (SUM: the shared slice), and where its dlogits go: row 0 of a
  // (Sq, Sk) region (kPerProgram, kSumRows), or, kSumCols, this warp's column sums (Sk floats past the
  // ring, summed over the chunk's programs) and then its partial row
  const float* bs = nullptr;
  float* drows = nullptr;
  float* scol = reinterpret_cast<float*>(smem + G::smem) + warp * ((mk.sk + 3) & ~3);
  if constexpr (SUM) {
    bs = bias.p + static_cast<size_t>(sl) * bias.Sqb * mk.sk;
    const int n_bh = gridDim.x / n_qt;
    if constexpr (DB == kSumRows) {
      drows = dbias + (static_cast<size_t>(blockIdx.y) * n_bh + sl) * mk.sq * mk.sk;
    } else {
      drows = dbias + ((static_cast<size_t>(blockIdx.y) * n_qt + qt) * NW + warp) * n_bh * mk.sk +
              static_cast<size_t>(sl) * mk.sk;
      for (int c = lane; c < mk.sk; c += 32) scol[c] = 0.f;
      __syncwarp();
    }
  } else if constexpr (BIAS) {
    bs = bias.slice(b0, h0, mk.sk);
    drows = dbias + (static_cast<size_t>(b0) * H + h0) * mk.sq * mk.sk;
  }

  auto load_q = [&](int buf, int pi) {
    int b, h;
    program(pi, b, h);
    load_rows<D, LD, BM, NT>(sQ(buf), q, b, mk.sq, H, h, q0);
    load_rows<D, LD, BM, NT>(sdO(buf), dout, b, mk.sq, H, h, q0);
  };
  // the ring runs over (program, key tile) in order; tile (pi, kt) into stage s
  const int hk0 = h0 / (H / KVH);
  auto load_tile = [&](int s, int pi, int kt) {
    int b, h;
    program(pi, b, h);
    if constexpr (QB == 2) {
      if (kt == kt_begin) load_q(pi & 1, pi);  // buffer pi & 1 last served program pi - 2, long done
    }
    const int hk = SUM ? h / (H / KVH) : hk0;
    load_rows<D, LD, BN, NT>(sK(s), k, b, mk.sk, KVH, hk, kt * BN);
    load_rows<D, LD, BN, NT>(sV(s), v, b, mk.sk, KVH, hk, kt * BN);
    if constexpr (DB == kSumCols) {
      load_bias<BN, LDB, NT>(sB(s), bs, 1, 0, 1, kt * BN, mk.sk, vec);
    } else if constexpr (BIAS) {
      load_bias<BN, LDB, NT>(sB(s), bs, BM, q0, mk.sq, kt * BN, mk.sk, vec);
    }
  };
  // the tile `ahead` iterations after (pi, kt), if the walk has it
  auto load_ahead = [&](int s, int pi, int kt, int ahead) {
    if constexpr (SUM) {
      for (int i = 0; i < ahead; ++i) {
        if (++kt == kt_end) {
          kt = kt_begin;
          ++pi;
        }
      }
      if (pi < n_prog) load_tile(s, pi, kt);
    } else {
      if (kt + ahead < kt_end) load_tile(s, 0, kt + ahead);
    }
  };
  if constexpr (QB == 1) {
    if (n_it > 0) load_q(0, 0);
  }
  cp_async_commit();
  for (int i = 0; i < ST - 1; ++i) {  // one group a stage, empty past the walk's end
    if (n_it > 0) load_ahead(i, 0, kt_begin, i);
    cp_async_commit();
  }

  // dbias of this lane's row wr + g + 8 r at keys col and col + 1; nothing past Sq or Sk is stored. The
  // collapsed dq's partials stay in L2 for the next program's add; dbias per program streams out.
  auto put_dbias = [&](int r, int col, float x0, float x1) {
    const int row = wr + g + 8 * r;
    if (row >= mk.sq) return;
    float* d = drows + static_cast<size_t>(row) * mk.sk + col;
    if (vec) {  // col even and sk a multiple of 4: both keys or neither
      if (col < mk.sk) {
        if constexpr (SUM) {
          __stcg(reinterpret_cast<float2*>(d), make_float2(x0, x1));
        } else {
          __stcs(reinterpret_cast<float2*>(d), make_float2(x0, x1));
        }
      }
    } else if constexpr (SUM) {
      if (col < mk.sk) __stcg(d, x0);
      if (col + 1 < mk.sk) __stcg(d + 1, x1);
    } else {
      if (col < mk.sk) __stcs(d, x0);
      if (col + 1 < mk.sk) __stcs(d + 1, x1);
    }
  };
  // kSumRows: the partial at (row wr + g + 8 r, keys col and col + 1) before this program adds to it
  auto get_part = [&](int r, int col, float& x0, float& x1) {
    const int row = wr + g + 8 * r;
    x0 = x1 = 0.f;
    if (row >= mk.sq) return;
    const float* d = drows + static_cast<size_t>(row) * mk.sk + col;
    if (vec) {
      if (col < mk.sk) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(d));
        x0 = x.x;
        x1 = x.y;
      }
    } else {
      if (col < mk.sk) x0 = __ldcg(d);
      if (col + 1 < mk.sk) x1 = __ldcg(d + 1);
    }
  };
  // dq of this warp's rows of program (b, h) out, and the accumulator cleared for the next program
  float dqacc[NO][4];
  auto put_dq = [&](int b, int h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g + 8 * r;
      if (row >= mk.sq) continue;
      bf16* drow = dq + ((static_cast<size_t>(b) * mk.sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(drow + j * 8 + t2) = pack_bf16(dqacc[j][2 * r], dqacc[j][2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqacc[j][e] = 0.f;
  };
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[j][e] = 0.f;

  // this lane's rows wr + g + 8 r, r in {0, 1}, of program (b, h): lse (times log2(e) when folded) and delta
  float lse_r[2], dlt_r[2];
  auto load_stats = [&](int b, int h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g + 8 * r;
      const size_t at = (static_cast<size_t>(b) * H + h) * mk.sq + row;
      const float l = row < mk.sq ? lse[at] : 0.f;
      lse_r[r] = FOLD ? l * kLog2e : l;
      dlt_r[r] = row < mk.sq ? delta[at] : 0.f;
    }
  };
  int b = b0, h = h0;
  if constexpr (!SUM) load_stats(b, h);  // one program: its stats load while the ring's first tile lands
  for (int pi = 0; pi < n_prog && n_kt > 0; ++pi) {
    if constexpr (SUM) {
      program(pi, b, h);
      load_stats(b, h);
    }
    const float slope = ALIBI ? slopes[h] : 0.f;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int it = (SUM ? pi * n_kt : 0) + kt - kt_begin, s = it % ST;
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile it (and Q, dO) landed for every thread; every warp is done with tile it - 1
      if constexpr (QB == 1 && SUM) {
        if (kt == kt_begin && pi > 0) {  // the next program's Q and dO, now that every warp is done with them
          load_q(0, pi);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
      }
      load_ahead((it + ST - 1) % ST, pi, kt, ST - 1);  // into tile it - 1's stage
      cp_async_commit();
      const bool first = pi == 0;  // kSumRows: the chunk's first program stores its dlogits, the rest add
      const bf16* qs = sQ(QB == 2 ? pi & 1 : 0);
      const bf16* dos = sdO(QB == 2 ? pi & 1 : 0);
      const bf16* ks = sK(s);
      const bf16* vs = sV(s);
#pragma unroll
      for (int sub = 0; sub < BN / KS; ++sub) {
        const int c0 = kt * BN + sub * KS;  // the sub-tile's first key
        // which keys of the sub-tile the warp's rows see: all, some, or none (kSumCols: rows past Sq read the
        // shared bias row, so they take the masked body, which gives them p = 0)
        bool none = wr >= mk.sq;
        bool masked = c0 + KS > mk.sk || (DB == kSumCols && wr + 16 > mk.sq);
        if (mk.causal) {
          const int diag_lo = mk.offset + wr, diag_hi = mk.offset + wr + 15;  // the first and last row's last key
          none = none || c0 > diag_hi || (mk.window > 0 && c0 + KS - 1 <= diag_lo - mk.window);
          masked = masked || c0 + KS - 1 > diag_lo || (mk.window > 0 && c0 <= diag_hi - mk.window);
        }
        if (none) {
          if (DB == kPerProgram || (DB == kSumRows && first)) {
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              put_dbias(0, c0 + j * 8 + t2, 0.f, 0.f);
              put_dbias(1, c0 + j * 8 + t2, 0.f, 0.f);
            }
          }
          continue;
        }
        float part[DB == kSumRows ? NS : 1][4];  // kSumRows: the partial before this program, fetched early
        if constexpr (DB == kSumRows) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (first) {
              part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
            } else {
              get_part(0, c0 + j * 8 + t2, part[j][0], part[j][1]);
              get_part(1, c0 + j * 8 + t2, part[j][2], part[j][3]);
            }
          }
        }
        float sacc[NS][4], pacc[NS][4];  // S = Q K^T and dP = dO V^T
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t qa[4], da[4];
          ldsm_x4(qa, qs + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
          ldsm_x4(da, dos + (16 * warp + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            const int off =
                (sub * KS + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 + ((lane >> 3) & 1) * 8;
            uint32_t r[4];
            ldsm_x4(r, ks + off);
            mma_bf16(sacc[2 * np], qa, r[0], r[1]);
            mma_bf16(sacc[2 * np + 1], qa, r[2], r[3]);
            ldsm_x4(r, vs + off);
            mma_bf16(pacc[2 * np], da, r[0], r[1]);
            mma_bf16(pacc[2 * np + 1], da, r[2], r[3]);
          }
        }
        // dS = p (dp - delta) scale on the fragments, as dQ's A operand: 16 keys per k-step; dlogits = p (dp - delta)
        uint32_t dsa[NS / 2][4];
        auto form_ds = [&](auto masked_tag) {
          constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            float bj[4];
            if constexpr (BIAS) {  // rows g, g + 8 of the warp's stripe (or the shared row), keys 2t, 2t + 1 of block j
              const float* br = sB(s) + (DB == kSumCols ? 0 : (16 * warp + g) * LDB) + sub * KS + j * 8 + t2;
              const float2 x0 = *reinterpret_cast<const float2*>(br);
              const float2 x1 = DB == kSumCols ? x0 : *reinterpret_cast<const float2*>(br + 8 * LDB);
              bj[0] = x0.x;
              bj[1] = x0.y;
              bj[2] = x1.x;
              bj[3] = x1.y;
            }
            float ds[4], dl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = wr + g + (e < 2 ? 0 : 8), col = c0 + j * 8 + t2 + (e & 1);
              float x;
              if constexpr (FOLD) {  // the raw q.k folded into one FFMA
                x = fmaf(sacc[j][e], scale2, -lse_r[e >> 1]);
              } else {  // the score first (masked_score's arithmetic), then (s - lse) log2(e)
                float sv = ALIBI ? fmaf(sacc[j][e], mk.scale, slope * static_cast<float>(col)) : sacc[j][e] * mk.scale;
                if constexpr (BIAS) sv += bj[e];
                x = (sv - lse_r[e >> 1]) * kLog2e;
              }
              float p = fast_exp2(x);
              if (MASKED && !visible(row, col, mk)) p = 0.f;
              dl[e] = p * (pacc[j][e] - dlt_r[e >> 1]);
              ds[e] = dl[e] * mk.scale;
            }
            dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
            dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
            const int col = c0 + j * 8 + t2;
            if constexpr (DB == kPerProgram) {
              put_dbias(0, col, dl[0], dl[1]);
              put_dbias(1, col, dl[2], dl[3]);
            } else if constexpr (DB == kSumRows) {
              put_dbias(0, col, part[j][0] + dl[0], part[j][1] + dl[1]);
              put_dbias(1, col, part[j][2] + dl[2], part[j][3] + dl[3]);
            } else if constexpr (DB == kSumCols) {  // the sum over the warp's 16 rows: rows g and g + 8, then the 8 g's
              float x0 = dl[0] + dl[2], x1 = dl[1] + dl[3];
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                x0 += __shfl_xor_sync(0xffffffffu, x0, o);
                x1 += __shfl_xor_sync(0xffffffffu, x1, o);
              }
              if (g == 0) {
                if (col < mk.sk) scol[col] += x0;
                if (col + 1 < mk.sk) scol[col + 1] += x1;
              }
            }
          }
        };
        if (masked) {
          form_ds(std::true_type{});
        } else {
          form_ds(std::false_type{});
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
    put_dq(b, h);
  }
  cp_async_wait<0>();

  if (n_kt == 0) {  // rows that see no key: dq = 0 for every program
    for (int pi = 0; pi < n_prog; ++pi) {
      program(pi, b, h);
      put_dq(b, h);
    }
  }
  if constexpr (DB == kPerProgram || DB == kSumRows) {  // the keys outside the walk's tiles have zero dlogits
    const int lo = min(kt_begin * BN, mk.sk), hi = min(max(kt_end * BN, lo), mk.sk);
    const int n_out = lo + mk.sk - hi;
    for (int i = tid; i < BM * n_out; i += NT) {
      const int r = i / n_out, c = i % n_out;
      if (q0 + r < mk.sq) __stcs(drows + static_cast<size_t>(q0 + r) * mk.sk + (c < lo ? c : hi + c - lo), 0.f);
    }
  }
  if constexpr (DB == kSumCols) {  // the warp's column sums over every program of the chunk
    __syncwarp();
    for (int c = lane; c < mk.sk; c += 32) drows[c] = scol[c];
  }
}

// One body under two names: the collapsed dq (kSumRows, kSumCols) is flash_dq_collapsed_bf16_kernel, so that
// a profile tells it from the dq per program.
template <int D, bool ALIBI, int DB>
__global__ void __launch_bounds__(DqGeo<D, DB>::NT, DqGeo<D, DB>::MIN_BLOCKS)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ slopes, Bias bias, bf16* __restrict__ dq, float* __restrict__ dbias,
                     int H, int KVH, Mask mk, int n_qt, int vec, int n_rep, int per) {
  dq_bf16_body<D, ALIBI, DB>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, H, KVH, mk, n_qt, vec, n_rep, per);
}

template <int D, bool ALIBI, int DB>
__global__ void __launch_bounds__(DqGeo<D, DB>::NT, DqGeo<D, DB>::MIN_BLOCKS)
flash_dq_collapsed_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ slopes, Bias bias, bf16* __restrict__ dq,
                               float* __restrict__ dbias, int H, int KVH, Mask mk, int n_qt, int vec, int n_rep,
                               int per) {
  dq_bf16_body<D, ALIBI, DB>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, H, KVH, mk, n_qt, vec, n_rep, per);
}

// ---------------------------------------------------------------- dk / dv
// Grid (n_kt * KVH, B): x = key tile * KVH + KV head, so the first key tiles (a causal mask's longest) go
// first. Block rows are keys; each block sums over the n_rep query heads of its KV head, in order, and
// over the query tiles that see its keys. BIAS: each query head reads its own slice (bias.slice), of Sq
// rows or of one row shared by every query row.
template <int D, bool ALIBI, bool BIAS>
__global__ void __launch_bounds__(DkvGeo<D, BIAS>::NT, DkvGeo<D, BIAS>::MIN_BLOCKS)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ slopes, Bias bias, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int H, int KVH, Mask mk, int vec) {
  using G = DkvGeo<D, BIAS>;
  constexpr int LD = G::LD, LDB = G::LDB, BM = G::BM, BN = G::BN, QS = G::QS, NT = G::NT;
  constexpr int KD = D / 16, NQ = QS / 8, NO = D / 8, ST = G::STAGES;
  constexpr bool FOLD = !ALIBI && !BIAS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + G::kv_bytes);
  auto stage = [&](int s) { return smem + 2 * G::kv_bytes + s * G::stage_bytes; };
  auto sQ = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto sdO = [&](int s) { return reinterpret_cast<bf16*>(stage(s) + G::q_bytes); };
  auto sL = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * G::q_bytes); };
  auto sDl = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * G::q_bytes + G::vec_bytes); };
  auto sB = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * G::q_bytes + 2 * G::vec_bytes); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int hk = blockIdx.x % KVH, kt = static_cast<int>(blockIdx.x) / KVH, b = blockIdx.y;
  const int n_rep = H / KVH;
  const int k0 = kt * BM, kw = k0 + 16 * warp;  // the block's and the warp's first keys
  const float scale2 = mk.scale * kLog2e;
  const int brows = BIAS && bias.Sqb == 1 ? 0 : LDB;  // bias row stride in a stage: 0 when one row serves all

  // query tiles whose rows can see a key of this block
  const int nq = (mk.sq + BN - 1) / BN;
  int qt_begin = 0, qt_end = nq;
  if (mk.causal) {
    qt_begin = min(max(k0 - mk.offset, 0) / BN, nq);  // row offset + r sees key c iff c <= offset + r
    if (mk.window > 0) {
      const int last_key = min(k0 + BM, mk.sk) - 1;
      const int last_row = last_key + mk.window - 1 - mk.offset;  // row <= key + window - 1 - offset
      qt_end = last_row < 0 ? 0 : min(last_row / BN + 1, nq);
    }
  }
  const int n_qt = max(qt_end - qt_begin, 0), n_it = n_rep * n_qt;

  load_rows<D, LD, BM, NT>(sK, k, b, mk.sk, KVH, hk, k0);
  load_rows<D, LD, BM, NT>(sV, v, b, mk.sk, KVH, hk, k0);
  cp_async_commit();
  // iteration it: query head hk * n_rep + it / n_qt, query tile qt_begin + it % n_qt
  auto load_q = [&](int s, int it) {
    const int h = hk * n_rep + it / n_qt, q0 = (qt_begin + it % n_qt) * BN;
    load_rows<D, LD, BN, NT>(sQ(s), q, b, mk.sq, H, h, q0);
    load_rows<D, LD, BN, NT>(sdO(s), dout, b, mk.sq, H, h, q0);
    const size_t base = (static_cast<size_t>(b) * H + h) * mk.sq + q0;
    for (int i = tid; i < BN; i += NT) {
      const bool ok = q0 + i < mk.sq;
      cp_async4(sL(s) + i, ok ? lse + base + i : lse, ok ? 4 : 0);
      cp_async4(sDl(s) + i, ok ? delta + base + i : delta, ok ? 4 : 0);
    }
    if constexpr (BIAS) {  // query rows [q0, q0 + BN) (or the one shared row) x the block's keys
      const bool one = bias.Sqb == 1;
      load_bias<BM, LDB, NT>(sB(s), bias.slice(b, h, mk.sk), one ? 1 : BN, one ? 0 : q0, one ? 1 : mk.sq, k0,
                             mk.sk, vec);
    }
  };
  for (int i = 0; i < ST - 1; ++i) {  // one group a stage, empty past the walk's end
    if (i < n_it) load_q(i, i);
    cp_async_commit();
  }

  // this lane's keys: kw + g + 8 r for r in {0, 1}
  float dkacc[NO][4], dvacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST, h = hk * n_rep + it / n_qt, q0 = (qt_begin + it % n_qt) * BN;
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage it (and K, V) landed for every thread; every warp is done with stage it - 1
    if (it + ST - 1 < n_it) load_q((it + ST - 1) % ST, it + ST - 1);
    cp_async_commit();
    const float slope = ALIBI ? slopes[h] : 0.f;
    const bf16* qs = sQ(s);
    const bf16* dos = sdO(s);
    const float* ls = sL(s);
    const float* dls = sDl(s);
    const float* bst = sB(s) + 16 * warp + g;  // BIAS: this lane's first key in the stage's bias rows
#pragma unroll
    for (int sub = 0; sub < BN / QS; ++sub) {
      const int r0 = q0 + sub * QS;  // the sub-tile's first query row
      // which query rows of the sub-tile see the warp's keys: all, some, or none
      bool none = kw >= mk.sk;
      bool masked = r0 + QS > mk.sq || kw + 16 > mk.sk;
      if (mk.causal) {
        // the pair (row r, key c) is visible iff c <= offset + r and (no window or c > offset + r - window)
        none = none || kw > mk.offset + r0 + QS - 1 || (mk.window > 0 && kw + 15 <= mk.offset + r0 - mk.window);
        masked = masked || kw + 15 > mk.offset + r0 || (mk.window > 0 && kw <= mk.offset + r0 + QS - 1 - mk.window);
      }
      if (none) continue;
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
          const int c = sub * QS + j * 8 + t2;  // this lane's two query rows in the stage
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
          const float lq[2] = {FOLD ? l2.x * kLog2e : l2.x, FOLD ? l2.y * kLog2e : l2.y};
          const float dl[2] = {d2.x, d2.y};
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw + g + (e < 2 ? 0 : 8), row = q0 + c + (e & 1);
            float x;
            if constexpr (FOLD) {
              x = fmaf(sacc[j][e], scale2, -lq[e & 1]);
            } else {  // the score first (masked_score's arithmetic), then (s - lse) log2(e)
              float sv = ALIBI ? fmaf(sacc[j][e], mk.scale, slope * static_cast<float>(key)) : sacc[j][e] * mk.scale;
              if constexpr (BIAS) sv += bst[(c + (e & 1)) * brows + (e < 2 ? 0 : 8)];
              x = (sv - lq[e & 1]) * kLog2e;
            }
            p[e] = fast_exp2(x);
            if (MASKED && !visible(row, key, mk)) p[e] = 0.f;
            ds[e] = p[e] * (pacc[j][e] - dl[e & 1]) * mk.scale;
          }
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (masked) {
        form_p_ds(std::true_type{});
      } else {
        form_p_ds(std::false_type{});
      }
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kb = 0; kb < NQ / 2; ++kb)
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          const int off = (sub * QS + kb * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, dos + off);
          mma_bf16(dvacc[2 * dp], pa[kb], r[0], r[1]);
          mma_bf16(dvacc[2 * dp + 1], pa[kb], r[2], r[3]);
          ldsm_x4_t(r, qs + off);
          mma_bf16(dkacc[2 * dp], dsa[kb], r[0], r[1]);
          mma_bf16(dkacc[2 * dp + 1], dsa[kb], r[2], r[3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= mk.sk) continue;
    const size_t base = ((static_cast<size_t>(b) * mk.sk + key) * KVH + hk) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dk + base + j * 8 + t2) = pack_bf16(dkacc[j][2 * r], dkacc[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + j * 8 + t2) = pack_bf16(dvacc[j][2 * r], dvacc[j][2 * r + 1]);
    }
  }
}

// 16-byte bias copies and float2 dbias stores: Sk a multiple of 4 and every slice 16-byte aligned
int bias_vec(const float* bias, const float* dbias, int sk) {
  return bias != nullptr && sk % 4 == 0 && aligned16(bias) && (dbias == nullptr || aligned16(dbias));
}

// The grid and block do not depend on the bias: only the shared memory does.
template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* delta,
              const float* slopes, Bias bias, bf16* dq, float* dbias, int B, int H, int KVH, Mask mk,
              cudaStream_t stream) {
  using G = DqGeo<D, kNoBias>;
  static_assert(DqGeo<D, kPerProgram>::NT == G::NT && DqGeo<D, kPerProgram>::BM == G::BM,
                "one grid with or without a bias");
  const int n_qt = (mk.sq + G::BM - 1) / G::BM;
  if (static_cast<long long>(n_qt) * H > 0x7fffffffLL) return kUnsupported;
  const bool has_bias = bias.p != nullptr;
  auto kernel = has_bias ? (slopes != nullptr ? flash_dq_bf16_kernel<D, true, kPerProgram>
                                              : flash_dq_bf16_kernel<D, false, kPerProgram>)
                         : (slopes != nullptr ? flash_dq_bf16_kernel<D, true, kNoBias>
                                              : flash_dq_bf16_kernel<D, false, kNoBias>);
  const size_t smem = has_bias ? DqGeo<D, kPerProgram>::smem : G::smem;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_qt * H, B), G::NT, smem, stream>>>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, H, KVH, mk,
                                                     n_qt, bias_vec(bias.p, dbias, mk.sk), 1, 1);
  return static_cast<int>(cudaGetLastError());
}

// The collapsed dq: grid (n_qt * n_bh, n_chunks) of the plan; kSumCols adds each warp's Sk column sums to
// the shared memory.
template <int D, int DB>
int launch_dq_collapsed(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                        const float* delta, const float* slopes, Bias bias, bf16* dq, float* part, int H, int KVH,
                        Mask mk, const CollapsedPlan& pl, cudaStream_t stream) {
  using G = DqGeo<D, DB>;
  if (pl.n_qt * G::BM < mk.sq || static_cast<long long>(pl.n_qt) * pl.n_bh > 0x7fffffffLL || pl.n_chunks > 65535)
    return kUnsupported;
  auto kernel = slopes != nullptr ? flash_dq_collapsed_bf16_kernel<D, true, DB>
                                  : flash_dq_collapsed_bf16_kernel<D, false, DB>;
  const size_t smem = G::smem + (DB == kSumCols ? static_cast<size_t>(G::NW) * ((mk.sk + 3) & ~3) * 4 : 0);
  if (smem > 232448) return kUnsupported;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(pl.n_qt * pl.n_bh, pl.n_chunks), G::NT, smem, stream>>>(
      q, k, v, dout, lse, delta, slopes, bias, dq, part, H, KVH, mk, pl.n_qt, bias_vec(bias.p, part, mk.sk), pl.n_rep,
      pl.per);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* delta,
               const float* slopes, Bias bias, bf16* dk, bf16* dv, int B, int H, int KVH, Mask mk,
               cudaStream_t stream) {
  using G = DkvGeo<D, false>;
  static_assert(DkvGeo<D, true>::NT == G::NT && DkvGeo<D, true>::BM == G::BM, "one grid with or without a bias");
  const int n_kt = (mk.sk + G::BM - 1) / G::BM;
  if (static_cast<long long>(n_kt) * KVH > 0x7fffffffLL) return kUnsupported;
  const bool has_bias = bias.p != nullptr;
  auto kernel = has_bias ? (slopes != nullptr ? flash_dkv_bf16_kernel<D, true, true>
                                              : flash_dkv_bf16_kernel<D, false, true>)
                         : (slopes != nullptr ? flash_dkv_bf16_kernel<D, true, false>
                                              : flash_dkv_bf16_kernel<D, false, false>);
  const size_t smem = has_bias ? DkvGeo<D, true>::smem : G::smem;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_kt * KVH, B), G::NT, smem, stream>>>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, H, KVH, mk,
                                                       bias_vec(bias.p, nullptr, mk.sk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

void flash_dq_collapsed_bf16_geometry(int* rows, int* warps) {
  static_assert(DqGeo<32, kSumRows>::BM == DqGeo<128, kSumCols>::BM, "one plan for every head dim");
  *rows = DqGeo<32, kSumRows>::BM;
  *warps = DqGeo<32, kSumRows>::NW;
}

int flash_dq_collapsed_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                            const float* delta, const float* slopes, Bias bias, bf16* dq, float* part, int H, int KVH,
                            int D, Mask mk, const CollapsedPlan& pl, cudaStream_t stream) {
  auto run = [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return bias.Sqb == 1
               ? launch_dq_collapsed<DD, kSumCols>(q, k, v, dout, lse, delta, slopes, bias, dq, part, H, KVH, mk, pl,
                                                    stream)
               : launch_dq_collapsed<DD, kSumRows>(q, k, v, dout, lse, delta, slopes, bias, dq, part, H, KVH, mk, pl,
                                                    stream);
  };
  switch (D) {
    case 32: return run(std::integral_constant<int, 32>{});
    case 64: return run(std::integral_constant<int, 64>{});
    case 128: return run(std::integral_constant<int, 128>{});
    default: return kUnsupported;
  }
}

int flash_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                  const float* delta, const float* slopes, Bias bias, bf16* dq, float* dbias, int B, int H, int KVH,
                  int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

int flash_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                   const float* delta, const float* slopes, Bias bias, bf16* dk, bf16* dv, int B, int H, int KVH,
                   int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
