// Flash attention backward, step 1 of 3 (delta), for NVIDIA Hopper (sm_90a),
// CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_delta_kernel, the first Pallas
// kernel of the fused flash backward that training runs once per attention
// layer.
//
// What it computes: delta = rowsum(dO * O) in float32 for every (batch,
// query position, head) row of o and dO (B, Sq, Hq, D) bf16, written as
// (B, Sq, Hq) float32: the softmax-gradient dot product that the dQ (B5) and
// dK/dV (B6) kernels reuse. The TPU kernel replicates it across 128 lanes;
// here it is one float per row.
//
// What bounds it on this card: bytes. It reads o and dO once (2 * D * 2
// bytes a row) for 2 * D flops, far below the 295 flops a byte at which the
// tensor cores would be the limit. Design: D / 8 lanes a row load 16 bytes
// of o and of dO each, inside a group of the next power of two of lanes (16
// at D 80, zamba2's head dim, lanes 10-15 adding zeros; 16 at D 96,
// phi-3-vision's, lanes 12-15 adding zeros), and a shuffle sum runs across
// the group; a warp covers 2 (D 128, 96 and 80) or 4 (D 64) whole rows, so
// every load is coalesced.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

// Lanes a row: D / 8 rounded up to a power of two, so that a row's lanes
// form one aligned group of the warp for the shuffle sum.
template <int D>
__host__ __device__ constexpr int lanes_per_row() {
  int n = 1;
  while (n < D / 8) n *= 2;
  return n;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const uint16_t* o, const uint16_t* dO, float* delta, int n_rows) {
  static_assert(D % 8 == 0, "a lane loads 8 bf16 (16 bytes)");
  constexpr int L = lanes_per_row<D>();
  static_assert(L <= 32, "a row's lanes lie in one warp");
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / L;
  const int c = (int)(t % L);
  float sum = 0.f;
  if (row < n_rows && c < D / 8) {
    const size_t off = (size_t)row * D + c * 8;
    float a[8], b[8];
    unpack8(*reinterpret_cast<const uint4*>(o + off), a);
    unpack8(*reinterpret_cast<const uint4*>(dO + off), b);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += a[e] * b[e];
  }
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (row < n_rows && c == 0) delta[row] = sum;
}

template <int D>
cudaError_t launch(const uint16_t* o, const uint16_t* dO, float* delta, int n_rows,
                   cudaStream_t stream) {
  const long long threads = (long long)n_rows * lanes_per_row<D>();
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  flash_bwd_delta_kernel<D><<<blocks, kThreads, 0, stream>>>(o, dO, delta, n_rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `n_rows` = B * Sq * Hq rows of D
// bf16 each in `o` and `dO`; `delta` holds n_rows floats. Returns a
// cudaError_t code, 0 on a successful launch; cudaErrorInvalidValue for an
// unsupported head dim. No synchronisation: the kernel runs on `stream`.
extern "C" int flash_bwd_delta_bf16(const void* o, const void* dO, void* delta, int n_rows,
                                    int D, void* stream) {
  const auto* o_ = static_cast<const uint16_t*>(o);
  const auto* do_ = static_cast<const uint16_t*>(dO);
  auto* d_ = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (D == 128) return static_cast<int>(launch<128>(o_, do_, d_, n_rows, st));
  if (D == 80) return static_cast<int>(launch<80>(o_, do_, d_, n_rows, st));
  if (D == 96) return static_cast<int>(launch<96>(o_, do_, d_, n_rows, st));
  if (D == 64) return static_cast<int>(launch<64>(o_, do_, d_, n_rows, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
