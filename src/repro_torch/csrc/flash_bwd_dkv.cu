// Flash attention backward, step 3 of 3 (dK and dV), for NVIDIA Hopper
// (sm_90a), CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_dkv_kernel, the Pallas kernel
// that computes dK and dV of the fused flash backward on the transposed grid.
//
// What it computes, for q, dO (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) bf16,
// the forward's lse and delta = rowsum(dO * O) (B, Sq, Hq) float32 (B4), with
// P = exp(q k^T * scale - lse) masked to 0 and dS = P * (dO v^T - delta) *
// scale as in the dQ kernel (B5):
//   dV = P^T dO  and  dK = dS^T q, summed over the G query heads of each kv
//   head, P and dS rounded to bf16 before their products as the TPU kernel
//   does; float32 accumulators, written once in bf16.
//
// Grid (B*Hkv, n_kv): block (bh, jkv) keeps KV tile jkv resident and streams
// every (GQA group, Q tile) that sees it as one sweep, the transposed
// Traversal: the G groups x the trimmed Q range [lo, hi] linearised into
// G * (hi - lo + 1) positions, position u visiting snake_pos(jkv, u, n,
// group), with parity on the resident tile and group 1 (cyclic), n
// (sawtooth) or min(snake_group, n) (block_snake), the arithmetic of
// Traversal.stream_block_index at 64 x 64 tiles. Each block owns its tile's
// dK and dV over all groups, so there are no atomics and two runs give equal
// bits. A KV tile no row sees (causal with Skv > Sq, a window past the Q
// length) streams nothing and writes exact zeros. With `visit_out` (B*Hkv,
// n_kv, G*n_q) int32 the block records its sweep as group * n_q + q tile, -1
// past its end.
//
// What bounds it on this card: at the training shape (Sq = Skv = 1024, D
// 128, causal) the four products (S^T, dP^T, dV, dK) take about 1.15x the
// time of the bytes, so operations. Design: the two f32 accumulators of a
// 64 x 128 tile take 128 registers a thread across 4 warps before anything
// else, so the block has 8 warps in two groups of 4 over the same 16-row
// slices of the KV tile: the first computes S^T = K Q^T and accumulates dV,
// the second recomputes S^T, computes dP^T = V dO^T and accumulates dK. Each
// thread then holds one accumulator (64 registers at D 128); the price is a
// fifth product (S^T twice). K and V stay in shared memory; Q, dO, lse and
// delta of each streamed tile arrive through shared memory. No cp.async/TMA
// pipelining and no wgmma yet: those are later work.

#include "flash_common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dO;
  const float* lse;
  const float* delta;
  uint16_t* dk;
  uint16_t* dv;
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, n_q, n_kv;
  int causal, window, order, snake;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args p) {
  constexpr int S = D + 8;  // shared row stride (bf16): conflict-free fragment loads
  constexpr int ND = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = Ks + kTile * S;
  uint16_t* Qs = Vs + kTile * S;
  uint16_t* dOs = Qs + kTile * S;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * S);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int jkv = blockIdx.y;  // the resident KV tile
  const int G = p.Hq / p.Hkv;
  const int col0 = jkv * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool dk_group = warp >= 4;  // warps 4-7 accumulate dK, 0-3 dV
  const int wr = (warp & 3) * 16;   // this warp's first KV row in the tile
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  int lo, hi;
  q_tile_range(jkv, p.n_q, p.causal, p.window, lo, hi);
  const int steps = hi - lo + 1;
  const int total = G * max(steps, 0);
  const int group = order_group(p.order, p.snake, total);

  if (p.visit != nullptr) {
    const int width = G * p.n_q;
    int* vrow = p.visit + ((size_t)bh * p.n_kv + jkv) * width;
    for (int u = tid; u < width; u += kThreads) {
      int rec = -1;
      if (u < total) {
        const int uu = snake_pos(jkv, u, total, group);
        rec = (uu / steps) * p.n_q + lo + uu % steps;
      }
      vrow[u] = rec;
    }
  }

  const size_t kv_ld = (size_t)p.Hkv * D;
  const size_t kv_off = ((size_t)(b * p.Skv + col0) * p.Hkv + kvh) * D;
  load_tile<D, S, kThreads>(Ks, p.k + kv_off, kv_ld, p.Skv - col0, tid);
  load_tile<D, S, kThreads>(Vs, p.v + kv_off, kv_ld, p.Skv - col0, tid);

  const int gcol[2] = {col0 + wr + g, col0 + wr + g + 8};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const size_t q_ld = (size_t)p.Hq * D;
  for (int u = 0; u < total; ++u) {
    const int uu = snake_pos(jkv, u, total, group);
    const int head = kvh * G + uu / steps;
    const int row0 = (lo + uu % steps) * kTile;
    const size_t q_off = ((size_t)(b * p.Sq + row0) * p.Hq + head) * D;
    __syncthreads();  // the previous Q tile is consumed
    load_tile<D, S, kThreads>(Qs, p.q + q_off, q_ld, p.Sq - row0, tid);
    load_tile<D, S, kThreads>(dOs, p.dO + q_off, q_ld, p.Sq - row0, tid);
    for (int r = tid; r < kTile; r += kThreads) {
      const bool in = row0 + r < p.Sq;
      const size_t at = (size_t)(b * p.Sq + row0 + r) * p.Hq + head;
      lse_s[r] = in ? p.lse[at] : 0.f;
      delta_s[r] = in ? p.delta[at] : 0.f;
    }
    __syncthreads();

    // S^T (this warp's 16 KV rows x 64 Q rows) = K Q^T, then P^T.
    float s[8][4];
    mma_abt<D, S>(s, Ks, wr, Qs, g, tig);
    if (!dk_group) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = nt * 8 + tig * 2 + (e & 1);
          s[nt][e] = visible<true>(row0 + qr, gcol[e >> 1], p.Sq, p.Skv, p.causal, p.window)
                         ? __expf(s[nt][e] * p.scale - lse_s[qr])
                         : 0.f;
        }
      }
      mma_pb<D, S>(acc, s, dOs, g, tig);  // dV += P^T dO
    } else {
      float dp[8][4];
      mma_abt<D, S>(dp, Vs, wr, dOs, g, tig);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = nt * 8 + tig * 2 + (e & 1);
          const float pr = visible<true>(row0 + qr, gcol[e >> 1], p.Sq, p.Skv, p.causal, p.window)
                               ? __expf(s[nt][e] * p.scale - lse_s[qr])
                               : 0.f;
          dp[nt][e] = pr * (dp[nt][e] - delta_s[qr]) * p.scale;  // dS^T
        }
      }
      mma_pb<D, S>(acc, dp, Qs, g, tig);  // dK += dS^T Q
    }
  }

  uint16_t* out = dk_group ? p.dk : p.dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (gcol[h] >= p.Skv) continue;
    uint16_t* orow = out + ((size_t)(b * p.Skv + gcol[h]) * p.Hkv + kvh) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(uint16_t) * 4 * kTile * (D + 8) + sizeof(float) * 2 * kTile;
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hkv, a.n_kv);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim.
// `order`: 0 cyclic, 1 sawtooth, 2 block_snake (reversal groups of `snake`
// tiles); `window` < 0 means none; `visit` may be null. No synchronisation:
// the kernel runs on `stream`.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* visit, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                  int causal, int window, int order, int snake, float scale,
                                  void* stream) {
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.dO = static_cast<const uint16_t*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<uint16_t*>(dk);
  a.dv = static_cast<uint16_t*>(dv);
  a.visit = static_cast<int*>(visit);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.n_q = (Sq + kTile - 1) / kTile;
  a.n_kv = (Skv + kTile - 1) / kTile;
  a.causal = causal;
  a.window = window;
  a.order = order;
  a.snake = snake;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch<128>(a, B, st));
  if (D == 64) return static_cast<int>(launch<64>(a, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
