// Warp-level tensor-core and async-copy primitives shared by the port's
// bf16 kernels (attention.cu, attention_bwd.cu, subm_conv.cu,
// subm_conv_wgrad.cu): cp.async (16 and 4 bytes, zero-filled when the source
// is absent), ldmatrix and ldmatrix.trans, mma.sync.m16n8k16 bf16 -> fp32, the bf16 packing of
// fp32 accumulators into A fragments, and ex2.approx. sm_80 and later;
// the port builds them for sm_90a.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously; zero-filled when !full
// (the src-size 0 form: nothing is read, `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N groups (the newest) are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i (transposed with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// Two 8x8 matrices, transposed; lanes 0-15 give the addresses (lanes 16-31
// must still pass a valid one).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator of n-tile nt (16 rows x 8 columns) as half of the A
// fragment of k-step nt / 2, rounded to bf16: n-tiles 2j and 2j + 1 make
// the A fragment of the 16 columns from 16 j (FlashAttention-2's reuse of
// S's accumulators as P's A operand, without a trip through shared memory).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], int nt,
                                         const float (&acc)[4]) {
  a[(nt & 1) * 2] = pack_bf16(acc[0], acc[1]);
  a[(nt & 1) * 2 + 1] = pack_bf16(acc[2], acc[3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace mma_sm90
