// Tile helpers shared by the flash attention kernels (the forward B2 and the
// backward B5, B6): the 64 x 64 tile geometry, the causal/SWA trimmed tile
// ranges of both grids, the visibility mask, tile loads into shared memory
// and the bf16 mma.sync fragment products. Plain CUDA C++ for sm_90a.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTile = 64;  // rows of a Q tile, positions of a KV tile

// D = C + A B on the tensor cores: one m16n8k16 bf16 product, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Inclusive [lo, hi] KV tiles seen by Q tile `q_tile` (Traversal.kv_bounds_host
// at 64 x 64 tiles); hi < lo when a window leaves nothing.
__device__ __forceinline__ void kv_tile_range(int q_tile, int n_kv, int causal, int window,
                                              int& lo, int& hi) {
  const int row0 = q_tile * kTile;
  hi = causal ? min(n_kv - 1, (row0 + kTile - 1) / kTile) : n_kv - 1;
  lo = window >= 0 ? max(row0 - (window - 1), 0) / kTile : 0;
}

// Inclusive [lo, hi] Q tiles that see KV tile `kv_tile` (Traversal.q_bounds_host
// at 64 x 64 tiles); hi < lo when no row sees it.
__device__ __forceinline__ void q_tile_range(int kv_tile, int n_q, int causal, int window,
                                             int& lo, int& hi) {
  lo = causal ? kv_tile : 0;
  hi = window >= 0 ? min(n_q - 1, ((kv_tile + 1) * kTile + window - 2) / kTile) : n_q - 1;
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

// A 64-row tile of D bf16 columns into shared memory (row stride S): row r
// from `src + r * ld`, zero for r >= `valid`.
template <int D, int S, int kThreads>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, size_t ld,
                                          int valid, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = tid; e < kTile * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) w = *reinterpret_cast<const uint4*>(src + r * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * S + c * 8) = w;
  }
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

// acc (16 x D, D/8 n-tiles) += P B, with P (16 x 64) the C fragments of an
// mma_abt product, rounded to bf16 here, and B (64 x D) the shared tile `b`.
template <int D, int S>
__device__ __forceinline__ void mma_pb(float (*acc)[4], float (*p)[4], const uint16_t* b,
                                       int g, int tig) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const uint16_t* b0 = b + (kc * 16 + tig * 2) * S + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint16_t* bp = b0 + n * 8;
      mma_bf16(acc[n], pa, pack_u16(bp[0], bp[S]), pack_u16(bp[8 * S], bp[9 * S]));
    }
  }
}

}  // namespace repro
