// Helpers shared by the flash attention kernels (the forward B2 and the
// backward B5, B6) and the SSD scan (B7): the visibility mask and a bf16
// mma.sync fragment product. Plain CUDA C++ for sm_90a.
#pragma once

#include "common.cuh"

namespace repro {

// D = C + A B on the tensor cores: one m16n8k16 bf16 product, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Query row `row` sees key column `col`. kRowBound also masks rows at or
// past Sq: the backward kernels (B5, B6) sum over the rows of a partial Q
// tile, so such rows must add nothing; the forward (B2) never stores them
// and leaves the test out of its inner loop.
template <bool kRowBound>
__device__ __forceinline__ bool visible(int row, int col, int Sq, int Skv, int causal,
                                        int window) {
  bool ok = col < Skv;
  if (kRowBound) ok = ok && row < Sq;
  if (causal) ok = ok && col <= row;
  if (window >= 0) ok = ok && col > row - window;
  return ok;
}

// acc (16 x 64, as 8 n-tiles of C fragments) = A B^T for the 16 rows from
// `r0` of shared tile `a` and all 64 rows of shared tile `b`, both D wide.
template <int D, int S>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const uint16_t* a, int r0,
                                        const uint16_t* b, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* a0 = a + (r0 + g) * S + kk * 16 + tig * 2;
    const uint16_t* a1 = a0 + 8 * S;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(a0);
    af[1] = *reinterpret_cast<const uint32_t*>(a1);
    af[2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(a1 + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint16_t* bp = b + (nt * 8 + g) * S + kk * 16 + tig * 2;
      mma_bf16(acc[nt], af, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

}  // namespace repro
