// Warp-level tensor-core and asynchronous-copy primitives (PTX for sm_80
// and later, built here for sm_90a), shared by the LM kernels and the MLP
// chain kernels.
//
// Fragment layouts of mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators, for lane L of a warp (g = L / 4, t = L % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16 values, the lower index in the low
// half.  A C fragment of two neighbouring n-tiles is therefore, element for
// element, the A fragment of a product over those 16 columns.
//
// Fragment layouts of mma.sync.m16n8k8 with tf32 operands and fp32
// accumulators (one 32-bit element a register; ldmatrix moves 16-bit
// elements, so these fragments are loaded with plain ld.shared):
//   A (16 x 8, row-major):  a0 = A[g][t],   a1 = A[g+8][t],
//                           a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, k x n):       b0 = B[t][g],   b1 = B[t+4][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes 16 zero
// bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane L holds row L / 4, columns 2 (L % 4)
// and 2 (L % 4) + 1 of matrix i (transposed: rows 2 (L % 4) and
// 2 (L % 4) + 1 of column L / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores: m16n8k8, tf32 operands, fp32 sums.  The
// operands must be tf32 already (cvt.rna): raw fp32 bits are truncated.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, in a 32-bit register whose low 13 bits are zero: the rounding of
// cvt.rna.tf32.f32, which ptxas expands on sm_90a into this very add and
// mask wrapped in a finiteness test and a select.  fp32 bits are sign and
// magnitude, so adding half of the dropped 13 bits' range rounds the
// magnitude up at a tie whatever the sign.
// Without the test an infinity still stays infinite and the canonical NaN
// a NaN; only a NaN whose payload fills the top mantissa bits carries
// into the sign and comes out as a zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 22 bits: hi = tf32(v), lo = tf32(v - hi) (v - hi is
// exact in fp32).  Three products into one fp32 sum, lo b_hi + hi b_lo +
// hi b_hi, keep an fp32 product's accuracy: the dropped lo b_lo is about
// 2^-22 of it (3xTF32).  The MMA's own sums truncate toward zero, so a
// long sum should not run in one accumulator (mlp_gemm.cuh)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// x below -126, so a finite -1e30 gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v = hi + lo to about 16 bits: hi = bf16(v), lo = bf16(v - hi), for a
// pair of floats; two products, one on each term, into one fp32 sum keep
// an fp32 operand's accuracy (the other operand exact in bf16)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

}  // namespace warp_mma
