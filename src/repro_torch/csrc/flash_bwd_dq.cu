// Flash attention backward, step 2 of 3 (dQ), for NVIDIA Hopper (sm_90a),
// CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_dq_kernel, the Pallas kernel
// that computes dQ of the fused flash backward on the forward grid.
//
// What it computes, for q, dO (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) bf16,
// the forward's lse and delta = rowsum(dO * O) (B, Sq, Hq) float32 (B4):
//   P  = exp(S * scale - lse), S = q k^T, masked to 0 where the row does
//        not see the column (causal, window, padding past Sq or Skv);
//   dS = P * (dO v^T - delta) * scale, rounded to bf16 as the TPU kernel
//        does (`ds.astype(k.dtype)`);
//   dQ = dS k, accumulated in float32 and written once in bf16.
// Masked entries are selected to 0, never computed as exp(S - lse): a row
// that sees nothing carries lse = the mask value, where that exp overflows.
//
// Grid (B*Hkv, G*n_q), the forward kernel's (B2): block (bh, i) owns Q tile
// i % n_q of GQA group i / n_q and walks the KV tiles of its trimmed range
// [lo, hi] in the paper's order, step j visiting lo + snake_pos(i, j, n,
// group), the arithmetic of Traversal.kv_block_index at 64 x 64 tiles. Tiles
// outside the range are skipped, not masked. Each block owns its dQ rows, so
// there are no atomics and two runs give equal bits. With `visit_out`
// (B*Hkv, G*n_q, n_kv) int32 the block records the tiles it walked, -1 past
// its range.
//
// What bounds it on this card: at the training shape (Sq = Skv = 1024, D
// 128, causal) the three products (S, dO v^T, dS k) take about 1.04x the
// time of the bytes, so operations, by a little. Design: 4 warps, each 16
// rows of the 64-row tile; Q and dO stay in shared memory and are read as
// mma.sync A fragments for each KV tile; K and V tiles through shared memory;
// the f32 dQ accumulator (64 registers a thread at D 128) in registers. No
// cp.async/TMA pipelining and no wgmma yet: those are later work.

#include "flash_common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dO;
  const float* lse;
  const float* delta;
  uint16_t* dq;
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, n_q, n_kv;
  int causal, window, order, snake;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args p) {
  constexpr int S = D + 8;  // shared row stride (bf16): conflict-free fragment loads
  constexpr int ND = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dOs = Qs + kTile * S;
  uint16_t* Ks = dOs + kTile * S;
  uint16_t* Vs = Ks + kTile * S;

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int i = blockIdx.y;  // folded row: group * n_q + q tile
  const int q_tile = i % p.n_q;
  const int head = kvh * (p.Hq / p.Hkv) + i / p.n_q;
  const int row0 = q_tile * kTile;
  const int tid = threadIdx.x;
  const int wr = (tid >> 5) * 16;  // this warp's first row in the tile
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  int lo, hi;
  kv_tile_range(q_tile, p.n_kv, p.causal, p.window, lo, hi);
  const int raw = hi - lo + 1;
  const int group = order_group(p.order, p.snake, raw);

  if (p.visit != nullptr) {
    int* vrow = p.visit + ((size_t)bh * gridDim.y + i) * p.n_kv;
    for (int j = tid; j < p.n_kv; j += kThreads)
      vrow[j] = j < raw ? lo + snake_pos(i, j, raw, group) : -1;
  }

  const size_t q_ld = (size_t)p.Hq * D;
  const size_t q_off = ((size_t)(b * p.Sq + row0) * p.Hq + head) * D;
  load_tile<D, S, kThreads>(Qs, p.q + q_off, q_ld, p.Sq - row0, tid);
  load_tile<D, S, kThreads>(dOs, p.dO + q_off, q_ld, p.Sq - row0, tid);

  // This thread's two rows (fragment rows g and g + 8), their lse and delta.
  const int row_a = row0 + wr + g, row_b = row_a + 8;
  const size_t at_a = (size_t)(b * p.Sq + row_a) * p.Hq + head;
  const size_t at_b = at_a + (size_t)8 * p.Hq;
  const float lse_a = row_a < p.Sq ? p.lse[at_a] : 0.f;
  const float lse_b = row_b < p.Sq ? p.lse[at_b] : 0.f;
  const float delta_a = row_a < p.Sq ? p.delta[at_a] : 0.f;
  const float delta_b = row_b < p.Sq ? p.delta[at_b] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const size_t kv_ld = (size_t)p.Hkv * D;
  for (int j = 0; j < raw; ++j) {
    const int col0 = (lo + snake_pos(i, j, raw, group)) * kTile;
    const size_t kv_off = ((size_t)(b * p.Skv + col0) * p.Hkv + kvh) * D;
    __syncthreads();  // the previous tile is consumed
    load_tile<D, S, kThreads>(Ks, p.k + kv_off, kv_ld, p.Skv - col0, tid);
    load_tile<D, S, kThreads>(Vs, p.v + kv_off, kv_ld, p.Skv - col0, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<D, S>(s, Qs, wr, Ks, g, tig);   // S = Q K^T
    mma_abt<D, S>(dp, dOs, wr, Vs, g, tig); // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool second = e >= 2;  // C fragment entries 2, 3 are row g + 8
        const int col = col0 + nt * 8 + tig * 2 + (e & 1);
        const float pr = visible<true>(second ? row_b : row_a, col, p.Sq, p.Skv, p.causal, p.window)
                             ? __expf(s[nt][e] * p.scale - (second ? lse_b : lse_a))
                             : 0.f;
        s[nt][e] = pr * (dp[nt][e] - (second ? delta_b : delta_a)) * p.scale;  // dS
      }
    }
    mma_pb<D, S>(acc, s, Ks, g, tig);  // dQ += dS K
  }

  if (row_a < p.Sq) {
    uint16_t* drow = p.dq + at_a * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) = pack_bf16(acc[n][0], acc[n][1]);
  }
  if (row_b < p.Sq) {
    uint16_t* drow = p.dq + at_b * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, int G, cudaStream_t stream) {
  constexpr size_t smem = sizeof(uint16_t) * 4 * kTile * (D + 8);
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hkv, G * a.n_q);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim.
// `order`: 0 cyclic, 1 sawtooth, 2 block_snake (reversal groups of `snake`
// tiles); `window` < 0 means none; `visit` may be null. No synchronisation:
// the kernel runs on `stream`.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dq, void* visit, int B,
                                 int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                                 int order, int snake, float scale, void* stream) {
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.dO = static_cast<const uint16_t*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<uint16_t*>(dq);
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
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch<128>(a, B, G, st));
  if (D == 64) return static_cast<int>(launch<64>(a, B, G, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
