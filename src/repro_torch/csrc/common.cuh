// Helpers shared by the port's attention kernels: bf16 <-> f32 bit
// conversions and warp reductions. Plain CUDA C++ for sm_90a; no PyTorch
// headers, so each kernel builds in seconds.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// Finite mask value of the reference kernels (-0.7 * float32 max).
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16_at(const uint16_t* p) { return __uint_as_float((uint32_t)*p << 16); }

// float32 -> bfloat16 bits, round to nearest even; NaN stays NaN.
__device__ __forceinline__ uint32_t f32_to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

// Two floats as one bf16x2 register: `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return f32_to_bf16(lo) | (f32_to_bf16(hi) << 16);
}

__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  f[0] = bf16_lo(w.x); f[1] = bf16_hi(w.x);
  f[2] = bf16_lo(w.y); f[3] = bf16_hi(w.y);
  f[4] = bf16_lo(w.z); f[5] = bf16_hi(w.z);
  f[6] = bf16_lo(w.w); f[7] = bf16_hi(w.w);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Position of step `j` in a range of `n` tiles under the grouped reversal
// with parity key `parity` and group `group` (1: cyclic, n: sawtooth,
// g: block_snake): the arithmetic of repro_torch.core.schedule.
__device__ __forceinline__ int snake_pos(int parity, int j, int n, int group) {
  if (group <= 1 || (parity & 1) == 0) return j;
  const int base = (j / group) * group;
  const int size = min(group, n - base);
  return base + (size - 1) - (j - base);
}

// Effective reversal group over a range of `n` tiles: order 0 cyclic,
// 1 sawtooth, 2 block_snake with `snake` tiles.
__device__ __forceinline__ int order_group(int order, int snake, int n) {
  if (order == 0) return 1;
  if (order == 1) return max(n, 1);
  return max(1, min(snake, n));
}

}  // namespace repro
