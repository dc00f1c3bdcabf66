// The bfloat16 flash attention backward at D 32, 64 and 128: dq (with or
// without a bias writing dbias per program), the collapsed dq and dk/dv. The
// bodies and their design note are flash_bwd.cuh; D 80, 96 and 256 are
// flash_dq_wide.cu and flash_dkv_wide.cu, translation units of their own so
// that nvcc builds the three in parallel.
//
// Replaces, for bf16, the TPU kernels of deepspeed_tpu/ops/pallas/
// flash_attention.py: _dq_kernel (pallas_call at :417), _dq_kernel_collapsed
// (:456), _dkv_kernel (:485) and _dkv_kernel_gqa (:518).
#include "flash_bwd.cuh"

namespace dstorch {

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
    case 32: return launch_dq<32, true>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 64: return launch_dq<64, true>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 128: return launch_dq<128, true>(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, mk, stream);
    case 80:
    case 96:
    case 256: return flash_dq_bf16_wide(q, k, v, dout, lse, delta, slopes, bias, dq, dbias, B, H, KVH, D, mk, stream);
    default: return kUnsupported;
  }
}

int flash_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                   const float* delta, const float* slopes, Bias bias, bf16* dk, bf16* dv, int B, int H, int KVH,
                   int D, Mask mk, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dkv<32, true>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 64: return launch_dkv<64, true>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 128: return launch_dkv<128, true>(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, mk, stream);
    case 80:
    case 96:
    case 256: return flash_dkv_bf16_wide(q, k, v, dout, lse, delta, slopes, bias, dk, dv, B, H, KVH, D, mk, stream);
    default: return kUnsupported;
  }
}

}  // namespace dstorch
