// The bfloat16 paged decode for Hopper (flash-decoding): one query token per
// row against its paged context, on bf16 or int8 pools, with optional ALiBi
// and a sliding window; and the fixed-order combine of split partials that
// paged_prefill.cu shares.
//
// Replaces, for a bf16 q, the TPU kernel deepspeed_tpu/ops/pallas/
// paged_attention.py::_decode_kernel (:275, pallas_call at :386, via
// paged_attention_decode), with its quantized=True body. The float32 body
// stays in paged_attention.cu.
//
// What bounds it: bytes. A decode step reads every live key and value once
// and does 4 D flops per (key, query head): at llama3_8b's heads (32 query
// heads on 8 KV heads, D 128) and B 64 rows of contexts up to 8,192 that is
// about 465 MB, 0.139 ms at 3.35 TB/s; at B 8, 29 MB (0.0086 ms), which an
// L2 of 50 MB holds between warm launches. The old kernel gave each (KV head,
// row) one block that walked the whole context alone: 64 blocks at B 8 on 132
// SMs, the row of 4,096 keys setting the time (38x the bound).
//
// The design:
// - Work unit: a block takes one (split j, KV head h, row b) and the keys
//   [j split_keys, (j + 1) split_keys) of the row that it can see. The split
//   count comes from host-known values only (the wrapper's _decode_plan: B,
//   KVH, P, bs and the SM count), never from ctx_lens, so the launch needs no
//   device-to-host sync and a CUDA graph can capture it. A split that starts
//   at or past ctx, or ends before the window band, exits at once.
// - Keys go from device memory straight into registers, each read once: no
//   shared-memory staging and no block barrier in the loop. A key row is cut
//   into 16-byte lane slices of E elements (8 bf16, or 16 int8 codes; 8 codes
//   in 8 bytes at a head group of 8, where 16-wide slices of q and O would not
//   fit the registers). The lane that loads K's slice [c, c + E) holds q's
//   slice of each of the G query heads and accumulates O's slice [c, c + E)
//   of each. The score is reduced across the key's lanes by xor shuffles.
//   Each warp keeps U loads of KPW keys in flight (8 keys a warp at D 128),
//   because decode is bound by latency and bytes.
// - Head dims: D in {64, 80, 96, 128, 256}. A key's D / E lanes are padded up
//   to the next power of two, LPK (D 80: 10 lanes of 16; D 96: 12 of 16; int8
//   at E 16: 5 or 6 of 8), so the xor-shuffle reduce over a key's lanes and
//   the KPW = 32 / LPK keys a warp stay as they are; the idle lanes load
//   nothing and add zeros. That keeps one code path for every D at the cost
//   of idle lanes (37.5 % at D 80, 25 % at D 96), where packing 3.2 or 2.67
//   keys into a warp would need a reduce over uneven lane groups. D 256 takes
//   a whole warp a key (LPK 32, one key a warp a load).
// - Head groups larger than 8 (falcon-7b's 71 query heads on one KV head,
//   starcoder's 48): the grid's y runs over (KV head, chunk of 8 heads), and
//   each chunk's block walks the same keys again. That reads each split's K/V
//   ceil(G / 8) times (9 at G 71; 8 of them from L2 when the split's slice of
//   the pool stays there), against once for a body that puts the group's heads
//   on the M side of mma.sync m16n8k16, as the prefill does; the chunks keep
//   the one register-resident body that G <= 8 already runs.
// - Each lane group (the lanes of one key) runs its own online softmax over
//   its keys; at the end the groups of a warp merge by xor shuffles, the 4
//   warps through shared memory, in a fixed order. Without ALiBi q is scaled
//   by scale log2(e) once, so p = 2^(s - m) (ex2.approx); with ALiBi the score
//   stays in natural units and p = 2^((s - m) log2(e)): log2(e) is never
//   folded into a score in the hundreds before m is subtracted.
// - int8 pools: the same walk over codes. The K scale multiplies the score,
//   the V scale the weight; l sums the bare weight.
// - One split: the block writes the row's output. Several: it writes a
//   partial (m, l, acc[D]) per query head into the fp32 workspace the wrapper
//   allocates, and paged_combine_kernel merges the splits in split order, so
//   two launches give the same bits. A split with no visible key writes
//   l = 0 and is skipped there; a row with ctx 0 writes zeros.
// Not yet: CUDA-graph capture of the serving step (the launch is ready for
// it), a persistent grid, TMA.
#include "paged_decode.cuh"

namespace dstorch {

int paged_decode_bf16(const PagedArgs& a, cudaStream_t s) {
  if (a.splits < 1 || a.split_keys < 1 || a.splits > 65535 || a.B > 65535 || a.KVH > 65535 ||
      static_cast<long long>(a.splits) * a.split_keys < static_cast<long long>(a.P) * a.bs ||
      (a.splits > 1 && a.ws == nullptr) || !aligned16(a.q))
    return kUnsupported;
  if (a.D == 64) return decode_by_pool<64>(a, s);
  if (a.D == 128) return decode_by_pool<128>(a, s);
  return paged_decode_bf16_wide(a, s);
}

int paged_combine_bf16(const PagedArgs& a, int rows, cudaStream_t s) {
  switch (a.D) {
    case 64: return combine_by_units<64>(a, rows, s);
    case 80: return combine_by_units<80>(a, rows, s);
    case 96: return combine_by_units<96>(a, rows, s);
    case 128: return combine_by_units<128>(a, rows, s);
    case 256: return combine_by_units<256>(a, rows, s);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
