// Attention prologue of the paged decode step, fused: RoPE on q and k and
// the K/V page write, for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel. It fuses two plain functions that the
// reference leaves to XLA around its paged decode kernel: `rope`
// (src/repro/models/layers.py:90) and `_paged_write`
// (src/repro/models/transformer.py:168). Composed in PyTorch they are about
// fifty launches a layer in every step of the continuous engine (float32
// casts, half-slice products, the concatenation, the slot arithmetic, two
// index writes), each bound by its launch at a decode step's few rows. Here
// they are one launch a layer; the positions, cos/sin and page slots it
// reads are computed once a step (models/transformer.py `decode_view`).
//
// What it computes, for every position (b, t) of q (B, C, Hq, D) and of k
// and v (B, C, Hkv, D), bf16: q and k rotated by the half-split RoPE in
// float32,
//   y[i]       = x[i] * cos[i] - x[i + D/2] * sin[i]
//   y[i + D/2] = x[i + D/2] * cos[i] + x[i] * sin[i]        (i < D/2),
// with cos and sin (B, C, D/2) float32 as PyTorch computed them, each
// product, difference and sum rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: nothing contracts into an FMA that PyTorch's separate mul and
// sub do not make), then rounded to bf16 to nearest even. So the outputs
// equal the composed ops' bit for bit. q is rotated in place: it is the q
// projection's own buffer, and nothing else reads it unroped. The rotated k
// and the unrotated v go into the pools (n_pages, page, Hkv, D) bf16 at
// page phys[b, t], offset offset[b, t], where t < q_len[b]. The composed ops
// send the other rows to the dummy page 0, which nothing reads; this kernel
// writes nothing for them.
//
// What bounds it on this card: bytes. q, k and v are read once and written
// once (q back in place, k and v into their pages) for 3 flops an element
// of q and k, far below the 295 flops a byte at which the tensor cores
// would be the limit. Design: one block a position; each thread moves one
// pair of 16-byte vectors, the 8 elements at i and the 8 at i + D/2 of one
// head, so the rotation needs nothing from another thread, and neighbouring
// threads take neighbouring vectors of a head, then of the next head, so a
// warp's loads and stores cover whole lines. The position's cos and sin are
// staged once in shared memory and read there by every head. No
// allocation, no host read and no synchronisation: the mixed steps' CUDA
// graphs capture it. Head dims that 16 divides (64, 80, 96 and 128, every
// registered one, and the reduced configs' 16).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t bf16_rn(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return bf16_rn(lo) | (bf16_rn(hi) << 16);
}

__device__ __forceinline__ uint4 pack8_rn(const float* f) {
  return make_uint4(pack_rn(f[0], f[1]), pack_rn(f[2], f[3]), pack_rn(f[4], f[5]),
                    pack_rn(f[6], f[7]));
}

// Rotates the 8 elements at i (`lo`) and the 8 at i + D/2 (`hi`) of one
// head by the position's cos `c` and sin `s` at i.
__device__ __forceinline__ void rotate8(uint4& lo, uint4& hi, const float* c, const float* s) {
  float x1[8], x2[8], y1[8], y2[8];
  unpack8(lo, x1);
  unpack8(hi, x2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], s[e]));
    y2[e] = __fadd_rn(__fmul_rn(x2[e], c[e]), __fmul_rn(x1[e], s[e]));
  }
  lo = pack8_rn(y1);
  hi = pack8_rn(y2);
}

__global__ void __launch_bounds__(kMaxThreads)
    rope_kv_write_kernel(uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v, uint16_t* __restrict__ k_pages,
                         uint16_t* __restrict__ v_pages, const float* __restrict__ cos_tab,
                         const float* __restrict__ sin_tab, const int64_t* __restrict__ phys,
                         const int64_t* __restrict__ offset, const int* __restrict__ q_len,
                         int C, int Hq, int Hkv, int D, int page) {
  extern __shared__ float4 angles[];  // the position's cos, then its sin: D/2 floats each
  const int half = D / 2;
  const int64_t pos = blockIdx.x;  // b * C + t
  const int b = static_cast<int>(pos / C);
  const int t = static_cast<int>(pos - static_cast<int64_t>(b) * C);
  const int per_head = half / 8;  // vector pairs a head
  const int nq = Hq * per_head;
  const int nk = Hkv * per_head;
  const bool write = t < q_len[b];
  const int units = nq + (write ? 2 * nk : 0);

  const float4* c4 = reinterpret_cast<const float4*>(cos_tab + pos * half);
  const float4* s4 = reinterpret_cast<const float4*>(sin_tab + pos * half);
  for (int i = threadIdx.x; i < half / 4; i += blockDim.x) {
    angles[i] = c4[i];
    angles[half / 4 + i] = s4[i];
  }
  __syncthreads();
  const float* cs = reinterpret_cast<const float*>(angles);
  const float* sn = cs + half;
  const int64_t slot = write ? phys[pos] * page + offset[pos] : 0;

  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    if (u < nq) {  // q, rotated in place
      const int h = u / per_head;
      const int e = (u - h * per_head) * 8;
      uint16_t* x = q + (pos * Hq + h) * D + e;
      uint4 lo = *reinterpret_cast<const uint4*>(x);
      uint4 hi = *reinterpret_cast<const uint4*>(x + half);
      rotate8(lo, hi, cs + e, sn + e);
      *reinterpret_cast<uint4*>(x) = lo;
      *reinterpret_cast<uint4*>(x + half) = hi;
    } else {  // k rotated, or v as it is, into its page slot
      const bool is_k = u < nq + nk;
      const int w = u - (is_k ? nq : nq + nk);
      const int h = w / per_head;
      const int e = (w - h * per_head) * 8;
      const uint16_t* x = (is_k ? k : v) + (pos * Hkv + h) * D + e;
      uint16_t* y = (is_k ? k_pages : v_pages) + (slot * Hkv + h) * D + e;
      uint4 lo = *reinterpret_cast<const uint4*>(x);
      uint4 hi = *reinterpret_cast<const uint4*>(x + half);
      if (is_k) rotate8(lo, hi, cs + e, sn + e);
      *reinterpret_cast<uint4*>(y) = lo;
      *reinterpret_cast<uint4*>(y + half) = hi;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q (B, C, Hq, D), k and v (B, C,
// Hkv, D), k_pages and v_pages (n_pages, page, Hkv, D), all bf16 and
// contiguous; cos and sin (B, C, D/2) float32; phys and offset (B, C)
// int64; q_len (B,) int32. Returns a cudaError_t code, 0 on a successful
// launch; cudaErrorInvalidValue for a head dim that 16 does not divide. No
// synchronisation: the kernel runs on `stream`.
extern "C" int rope_kv_write_bf16(void* q, const void* k, const void* v, void* k_pages,
                                  void* v_pages, const void* cos_tab, const void* sin_tab,
                                  const void* phys, const void* offset, const void* q_len, int B,
                                  int C, int Hq, int Hkv, int D, int page, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (D <= 0 || D % 16 != 0 || Hq <= 0 || Hkv <= 0 || page <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = (Hq + 2 * Hkv) * (D / 16);
  const int threads = units < kMaxThreads ? (units + 31) / 32 * 32 : kMaxThreads;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(B) * C);
  rope_kv_write_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(k_pages),
      static_cast<uint16_t*>(v_pages), static_cast<const float*>(cos_tab),
      static_cast<const float*>(sin_tab), static_cast<const int64_t*>(phys),
      static_cast<const int64_t*>(offset), static_cast<const int*>(q_len), C, Hq, Hkv, D, page);
  return static_cast<int>(cudaGetLastError());
}
