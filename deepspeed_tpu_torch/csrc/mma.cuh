// Tensor-core and asynchronous-copy helpers (PTX) for the bf16 bodies of
// quantized_matmul.cu, flash_fwd.cu, flash_bwd.cu and the sparse kernels
// (sparse_fwd.cu, sparse_dq.cu, sparse_dkv.cu): warp-level mma.sync
// and, for sm_90a, the warpgroup wgmma.
//
// - cp_async16: a 16-byte global -> shared copy that bypasses the registers;
//   src_bytes < 16 fills the rest of the 16 bytes with zeros (0: nothing is
//   read), which masks a ragged edge without a branch around the copy.
//   cp_async4 the same for 4 bytes (an fp32 that need not be 16-byte aligned).
// - ldsm_x4 / ldsm_x4_t / ldsm_x2_t: ldmatrix of four (two) 8 x 8 matrices
//   of 16-bit elements. Lane l gives the address of row l % 8 of matrix l / 8;
//   the result's register i is matrix i's fragment (row lane / 4, columns
//   2 (lane % 4) and + 1, or the transpose with _t).
// - mma_bf16: mma.sync m16n8k16, bf16 inputs, fp32 accumulators. With
//   g = lane / 4 and t = lane % 4: A (16 x 16, row-major) a0 = (g, 2t..2t+1),
//   a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8)
//   b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g); C c0, c1 = (g, 2t..2t+1),
//   c2, c3 = (g + 8, 2t..2t+1). So a C fragment, rounded to bf16 in pairs, is
//   the A fragment of the next product (flash attention's P . V).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dstorch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------- warpgroup MMA (sm_90a)
// wgmma.mma_async m64nNk16 is issued by the 4 warps of a warpgroup together.
// B comes from shared memory through a matrix descriptor; A from registers
// (each warp holds rows 16 w .. 16 w + 15 of the 64 in mma_bf16's A layout);
// D (64 x N, fp32) in registers: warp w, lane (g, t) holds rows 16 w + g and
// + 8, columns 8 j + 2t, + 1, as d[4 j .. 4 j + 3] (mma_bf16's C layout per
// n8 block j). The shared-memory operand is read by the async proxy: fence
// writes to it with fence_proxy_async() before the barrier that precedes the
// wgmma, and keep it until wgmma_wait says the product is done.

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers an in-flight wgmma owns.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 64
// elements (128 bytes), the 16-byte unit u of row r stored at unit u ^ (r % 8),
// 8-row groups 1024 bytes apart (sbo), the atom 1024-byte aligned. A k16 step
// inside the row starts 32 bytes further; the hardware applies the swizzle.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem_ptr) {
  const uint64_t addr = smem_u32(smem_ptr);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128) = a (64 x 16, registers) . B (16 x 128, K-major in shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc_b));
}

}  // namespace dstorch
