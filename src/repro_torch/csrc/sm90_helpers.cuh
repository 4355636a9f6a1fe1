// Device helpers shared by the port's tensor-core kernels for sm_90a:
// cp.async copies, ldmatrix, mma.sync bf16, exp2 and bf16 packing (K1,
// K2), and f32-accurate products in 3xTF32 on mma.sync (K4, K5).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: relative error below 2^-22; 2^-1e30 = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, by adding
// half an ulp before clearing the low 13 mantissa bits), lo = x - hi
// exactly in f32, |lo| <= 2^-11 |x|; the tensor cores read a TF32
// operand's top 19 bits, so lo is cut to TF32 there (an error of at most
// 2^-10 |lo|, 2^-21 |x|). Three full-rate integer and f32 operations where
// cvt.rna.tf32.f32 would take two conversions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's acc[NTL][4] + cor[NTL][4] += A B over k < K in 3xTF32: A is
// 16 rows by K (a_at(row, k)), B is K by 8 NTL columns (b_at(k, col)).
// The hi.hi products go to acc and the two small ones to cor, so that
// each accumulator's chain of dependent mma is a third as long; the sum
// is acc + cor. acc[i] holds the m16n8 tile of columns 8i..8i+7:
// acc[i][0..3] at (row, col) = (g, 8i + 2q), (g, 8i + 2q + 1),
// (g + 8, 8i + 2q), (g + 8, 8i + 2q + 1), g = lane / 4, q = lane % 4.
template <int NTL, int K, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NTL][4],
                                         float (&cor)[NTL][4], FA a_at,
                                         FB b_at, int lane) {
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a_at(g, k0 + q), ah[0], al[0]);
    split_tf32(a_at(g + 8, k0 + q), ah[1], al[1]);
    split_tf32(a_at(g, k0 + q + 4), ah[2], al[2]);
    split_tf32(a_at(g + 8, k0 + q + 4), ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b_at(k0 + q, 8 * i + g), bh0, bl0);
      split_tf32(b_at(k0 + q + 4, 8 * i + g), bh1, bl1);
      mma_tf32(cor[i], al, bh0, bh1);
      mma_tf32(acc[i], ah, bh0, bh1);
      mma_tf32(cor[i], ah, bl0, bl1);
    }
  }
}

}  // namespace repro_sm90
