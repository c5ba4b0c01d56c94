// Split-Q flash attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_fwd_kernel, the Pallas kernel
// of the paper: the full-sequence attention of LM.prefill (the static serve
// path) and of training's forward.
//
// What it computes: o = softmax(q k^T * scale + mask) v for q (B, Sq, Hq, D)
// against k, v (B, Skv, Hkv, D), GQA with G = Hq / Hkv query heads per kv
// head. Column c is visible to row r iff c < Skv, and c <= r when causal,
// and c > r - window with a window. Optionally the per-row log-sum-exp
// lse = m + log(l) of the scaled scores, (B, Sq, Hq) float32. Rows with no
// visible column finalise to exact zeros (l == 0 -> 1), lse = mask value.
//
// Grid (B*Hkv, G*n_q): block (bh, i) holds Q tile i % n_q of GQA group
// i / n_q (the TPU kernel's folded row) and walks the KV tiles of the row's
// trimmed range [lo, hi] in the paper's order: step j visits
// lo + snake_pos(i, j, hi - lo + 1, group), group 1 (cyclic), hi - lo + 1
// (sawtooth) or min(snake_group, hi - lo + 1) (block_snake), the
// arithmetic of Traversal.kv_block_index at this kernel's tile sizes. Tiles
// outside [lo, hi] are skipped, not masked: the GPU form of the TPU's
// clamped-index elision, exact because such a tile adds p = 0. With
// `visit_out` (B*Hkv, G*n_q, n_kv) int32, the block records the tile ids it
// walked (-1 past the range), so the order can be checked on the card.
//
// Design: 4 warps, a 64-row Q tile (16 rows a warp) held as bf16 mma.sync
// A fragments in registers; 64-position K and V tiles through shared
// memory (row stride D + 8 bf16: conflict-free fragment loads at D 64, 80
// and 128; D 80, zamba2's shared attention, is 5 k-steps and 10 n-tiles); S = Q K^T and O += P V on the tensor cores
// (mma.sync.m16n8k16.bf16, f32 accumulate). Online softmax in f32 with
// p = 0 on masked entries: a reversed causal pass can visit the diagonal
// tile first, where early rows have no visible column yet. P is rounded to
// bf16 for the P V product, as the TPU kernel does.
//
// What bounds it on this card: at the static path's prefill shape (Sq = Skv
// = 700, D 128) the bytes of q, k, v and o (about 4 x 46 MB at B 8, 32
// heads) over 3.35 TB/s take longer than the causal flops at the bf16 peak,
// so bytes; K and V are re-read once per Q tile, from L2 mostly. No
// cp.async/TMA pipelining, no wgmma and no persistent tile scheduler yet:
// those are later work.

#include "flash_common.cuh"

namespace {

using namespace repro;

constexpr int kBM = kTile;  // Q rows per block
constexpr int kBN = kTile;  // KV positions per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* o;
  float* lse;  // may be null
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, n_q, n_kv;
  int causal, window, order, snake;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args p) {
  constexpr int S = D + 8;    // shared row stride (bf16): conflict-free fragment loads
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KK = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ks = Qs + kBM * S;
  uint16_t* Vs = Ks + kBN * S;

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int i = blockIdx.y;           // folded row: group * n_q + q tile
  const int q_tile = i % p.n_q;
  const int head = kvh * (p.Hq / p.Hkv) + i / p.n_q;
  const int row0 = q_tile * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;            // fragment row group
  const int tig = lane & 3;           // thread in group

  // Trimmed KV-tile range of this row (Traversal.kv_bounds_host).
  int lo, hi;
  kv_tile_range(q_tile, p.n_kv, p.causal, p.window, lo, hi);
  const int raw = hi - lo + 1;
  const int group = order_group(p.order, p.snake, raw);

  if (p.visit != nullptr) {
    int* vrow = p.visit + ((size_t)bh * gridDim.y + i) * p.n_kv;
    for (int j = tid; j < p.n_kv; j += kThreads)
      vrow[j] = j < raw ? lo + snake_pos(i, j, raw, group) : -1;
  }

  // Q tile -> shared memory (rows past Sq are zero).
  for (int e = tid; e < kBM * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.Sq)
      w = *reinterpret_cast<const uint4*>(
          p.q + ((size_t)(b * p.Sq + row0 + r) * p.Hq + head) * D + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * S + c * 8) = w;
  }
  __syncthreads();

  // This warp's 16 rows as A fragments.
  const int wr = warp * 16;
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint16_t* q0 = Qs + (wr + g) * S + kk * 16 + tig * 2;
    const uint16_t* q1 = q0 + 8 * S;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(q0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(q1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const int grow[2] = {row0 + wr + g, row0 + wr + g + 8};

  for (int j = 0; j < raw; ++j) {
    const int tile = lo + snake_pos(i, j, raw, group);
    const int col0 = tile * kBN;

    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBN * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vw = kw;
      if (col0 + r < p.Skv) {
        const size_t off = ((size_t)(b * p.Skv + col0 + r) * p.Hkv + kvh) * D + c * 8;
        kw = *reinterpret_cast<const uint4*>(p.k + off);
        vw = *reinterpret_cast<const uint4*>(p.v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * S + c * 8) = kw;
      *reinterpret_cast<uint4*>(Vs + r * S + c * 8) = vw;
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 positions.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint16_t* kp = Ks + (nt * 8 + g) * S + kk * 16 + tig * 2;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Mask and scale; masked entries become -inf so that p = 0 exactly.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = col0 + nt * 8 + tig * 2 + (e & 1);
        const bool ok = visible<false>(grow[h], col, p.Sq, p.Skv, p.causal, p.window);
        s[nt][e] = ok ? s[nt][e] * p.scale : -INFINITY;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: m starts at the mask value
      alpha[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[nt][e] = __expf(s[nt][e] - m[h]);  // exp(-inf) = 0 on masked entries
        l[h] += s[nt][e];
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V: P (16 x 64) as bf16 A fragments, V tile from shared memory.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const uint16_t* v0 = Vs + (kc * 16 + tig * 2) * S + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const uint16_t* vp = v0 + n * 8;
        const uint32_t b0 = pack_u16(vp[0], vp[S]);
        const uint32_t b1 = pack_u16(vp[8 * S], vp[9 * S]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // Finalise: full row sums across the 4 threads of a row group.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (l[h] == 0.f) l[h] = 1.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (grow[h] >= p.Sq) continue;
    const float inv = 1.f / l[h];
    uint16_t* orow = p.o + ((size_t)(b * p.Sq + grow[h]) * p.Hq + head) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (p.lse != nullptr && tig == 0)
      p.lse[(size_t)(b * p.Sq + grow[h]) * p.Hq + head] = m[h] + logf(l[h]);
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, int G, cudaStream_t stream) {
  constexpr size_t smem = sizeof(uint16_t) * 3 * 64 * (D + 8);
  auto kernel = flash_fwd_kernel<D>;
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
// tiles); `window` < 0 means none. `lse` and `visit` may be null. No
// synchronisation: the kernel runs on `stream`.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              void* visit, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                              int causal, int window, int order, int snake, float scale,
                              void* stream) {
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.o = static_cast<uint16_t*>(o);
  a.lse = static_cast<float*>(lse);
  a.visit = static_cast<int*>(visit);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.n_q = (Sq + kBM - 1) / kBM;
  a.n_kv = (Skv + kBN - 1) / kBN;
  a.causal = causal;
  a.window = window;
  a.order = order;
  a.snake = snake;
  a.scale = scale;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch<128>(a, B, G, st));
  if (D == 80) return static_cast<int>(launch<80>(a, B, G, st));
  if (D == 64) return static_cast<int>(launch<64>(a, B, G, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
