// One-token decode attention over a contiguous KV cache, for NVIDIA Hopper
// (sm_90a), CUDA C++.
//
// Replaces repro/kernels/flash_decode.py::_decode_kernel, the Pallas kernel
// of every decode step of the static serve path (LM.decode_step over the
// contiguous per-layer caches, SWA ring buffers included).
//
// What it computes: for each batch row b and query head, softmax over the
// cached positions pos of q . k[pos] * scale, times v: position pos is
// visible iff pos < lens[b] and, with a window, pos > lens[b] - 1 - window
// (the reference's (B, S_max) mask, derived here in-kernel from the
// per-row lengths; no mask operand exists). A row of length 0 gives exact
// zeros.
//
// Grid (B*Hkv, row tiles): block (bh, y) holds up to R query heads of kv
// head bh % Hkv (GQA group members y*R ..), so K and V of a (row, kv head)
// are read once for all its query heads. The cache is cut into n_chunks =
// ceil(S_max / chunk) chunks (chunk as the reference derives it), walked in
// kv_index(order, b*Hkv + h, j, n_chunks) order: the parity key is the
// grid row, as in the TPU kernel. Chunks wholly past the length or left of
// the window are skipped, which is exact.
//
// Design: 4 warps; inside a chunk, positions stream through shared memory
// in tiles of 128 (16-byte loads by the whole block), one position per
// thread for the scores. Each warp keeps its own online softmax (m, l,
// accumulator in f32) over its 32 positions of every tile; the four are
// merged once at the end. So no warp idles when a kv head has one query
// head (deepseek), unlike a warp-per-row layout. For P . V, lane l owns the
// bf16 pairs l, l + 32, ... of the head dim (32-bit shared loads, exact for
// D 64, 80 and 128; at D 80, zamba2's shared attention, lanes 8-31 hold one
// pair and lanes 0-7 two).
//
// What bounds it on this card: bytes. Each valid K/V element is read once
// and used for 2*G flops, far below the card's ~295 flops per byte. No
// split of one row's positions across blocks and no load/compute overlap
// yet: later work.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kT = 128;  // positions per shared tile: one per thread

struct Args {
  const uint16_t* q;  // (B, 1, Hq, D)
  const uint16_t* k;  // (B, S_max, Hkv, D)
  const uint16_t* v;
  const int* lens;    // (B,)
  uint16_t* out;      // (B, 1, Hq, D)
  int S_max, Hq, Hkv, window, chunk, order, snake;
  float scale;
};

template <int D, int R>
struct Smem {
  static constexpr int KS = D + 8;  // padded K row: conflict-free 16-byte reads
  static constexpr size_t k_bytes = sizeof(uint16_t) * kT * KS;
  static constexpr size_t v_bytes = sizeof(uint16_t) * kT * D;
  static constexpr size_t q_bytes = sizeof(float) * R * D;
  static constexpr size_t p_bytes = sizeof(float) * kWarps * R * 32;
  static constexpr size_t total = k_bytes + v_bytes + q_bytes + p_bytes;
  // The end-of-kernel merge (m, l, accumulator of every warp) reuses K/V.
  static_assert(sizeof(float) * kWarps * R * (D + 2) <= k_bytes + v_bytes, "merge area");
};

template <int D, int R>
__global__ void __launch_bounds__(kThreads) contig_decode_kernel(Args p) {
  using S = Smem<D, R>;
  constexpr int KS = S::KS;
  constexpr int CH = D / 8;
  constexpr int NP = D / 2;             // bf16 pairs of a row
  constexpr int PPL = (NP + 31) / 32;   // pairs a lane owns: lane, lane + 32, ...
  constexpr int DPL = 2 * PPL;          // accumulator dims per lane

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(smem + S::k_bytes);
  float* Qs = reinterpret_cast<float*>(smem + S::k_bytes + S::v_bytes);
  float* Ps = reinterpret_cast<float*>(smem + S::k_bytes + S::v_bytes + S::q_bytes);

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int head0 = kvh * G + blockIdx.y * R;
  const int nrows = min(R, G - (int)blockIdx.y * R);
  const int len = min(max(p.lens[b], 0), p.S_max);
  const int first = p.window >= 0 ? max(0, len - p.window) : 0;  // first visible position
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Query rows, pre-scaled, in float32; rows past nrows are zero.
  for (int e = tid; e < R * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nrows)
      unpack8(*reinterpret_cast<const uint4*>(p.q + ((size_t)b * p.Hq + head0 + r) * D + c * 8), f);
    float4* dst = reinterpret_cast<float4*>(Qs + r * D + c * 8);
    dst[0] = make_float4(f[0] * p.scale, f[1] * p.scale, f[2] * p.scale, f[3] * p.scale);
    dst[1] = make_float4(f[4] * p.scale, f[5] * p.scale, f[6] * p.scale, f[7] * p.scale);
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }

  const int n_chunks = (p.S_max + p.chunk - 1) / p.chunk;
  const int group = order_group(p.order, p.snake, n_chunks);
  for (int jc = 0; jc < n_chunks; ++jc) {
    const int c0 = snake_pos(bh, jc, n_chunks, group) * p.chunk;
    const int c1 = min(c0 + p.chunk, len);  // nothing at or past len is visible
    if (c0 >= c1 || c1 <= first) continue;
    for (int t0 = c0; t0 < c1; t0 += kT) {
      if (t0 + kT <= first) continue;
      __syncthreads();  // the previous tile is consumed (and the q rows written)
      for (int e = tid; e < kT * CH; e += kThreads) {
        const int pr = e / CH, c = e % CH;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u);
        uint4 vw = kw;
        if (t0 + pr < c1) {
          const size_t off = ((size_t)((size_t)b * p.S_max + t0 + pr) * p.Hkv + kvh) * D + c * 8;
          kw = *reinterpret_cast<const uint4*>(p.k + off);
          vw = *reinterpret_cast<const uint4*>(p.v + off);
        }
        *reinterpret_cast<uint4*>(Ks + pr * KS + c * 8) = kw;
        *reinterpret_cast<uint4*>(Vs + pr * D + c * 8) = vw;
      }
      __syncthreads();

      const int wpos0 = t0 + warp * 32;
      const int pos = wpos0 + lane;
      const bool ok = pos < c1 && pos >= first;
      if (!__any_sync(0xffffffffu, ok)) continue;  // warp-uniform

      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      const uint16_t* krow = Ks + (warp * 32 + lane) * KS;
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(krow + c * 8), kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qp = reinterpret_cast<const float4*>(Qs + r * D + c * 8);
          const float4 qa = qp[0], qb = qp[1];
          s[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                  qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
        }
      }

      float* pw = Ps + warp * R * 32;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sv = ok ? s[r] : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sv));  // finite: m starts at the mask value
        const float pr = ok ? __expf(sv - m_new) : 0.f;
        const float alpha = __expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(pr);
        m[r] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
        pw[r * 32 + lane] = pr;
      }
      __syncwarp();

      // acc += P . V; lane owns the dims 2 pi, 2 pi + 1 of its pairs pi
      // (a pair past the row adds zeros and is never stored).
      const int n_use = min(32, c1 - wpos0);
      for (int jj = 0; jj < n_use; ++jj) {
        float vf[DPL];
        const uint16_t* vrow = Vs + (warp * 32 + jj) * D;
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          const int pi = lane + 32 * k;
          const uint32_t w = pi < NP ? *reinterpret_cast<const uint32_t*>(vrow + 2 * pi) : 0u;
          vf[2 * k] = bf16_lo(w);
          vf[2 * k + 1] = bf16_hi(w);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = pw[r * 32 + jj];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] += pj * vf[d];
        }
      }
      __syncwarp();
    }
  }

  // Merge the four warps' partial softmax states.
  __syncthreads();
  float* Mm = reinterpret_cast<float*>(smem);
  float* Ml = Mm + kWarps * R;
  float* Ma = Ml + kWarps * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      Mm[warp * R + r] = m[r];
      Ml[warp * R + r] = l[r];
    }
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int pi = lane + 32 * k;
      if (pi < NP) {
        Ma[(warp * R + r) * D + 2 * pi] = acc[r][2 * k];
        Ma[(warp * R + r) * D + 2 * pi + 1] = acc[r][2 * k + 1];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Mm[w * R + r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(Mm[w * R + r] - mx);
      lt += Ml[w * R + r] * f;
      at += Ma[(w * R + r) * D + d] * f;
    }
    p.out[((size_t)b * p.Hq + head0 + r) * D + d] =
        static_cast<uint16_t>(f32_to_bf16(at / (lt == 0.f ? 1.f : lt)));
  }
}

template <int D, int R>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using S = Smem<D, R>;
  auto kernel = contig_decode_kernel<D, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  const dim3 grid(B * a.Hkv, (G + R - 1) / R);
  kernel<<<grid, kThreads, S::total, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(const Args& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<D, 1>(a, B, stream);
  if (G <= 2) return launch<D, 2>(a, B, stream);
  if (G <= 4) return launch<D, 4>(a, B, stream);
  return launch<D, 8>(a, B, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim.
// `order`: 0 cyclic, 1 sawtooth, 2 block_snake (reversal groups of `snake`
// chunks); `window` < 0 means none. No synchronisation: the kernel runs on
// `stream`.
extern "C" int contig_decode_bf16(const void* q, const void* k, const void* v, const void* lens,
                                  void* out, int B, int S_max, int Hq, int Hkv, int D,
                                  int window, int chunk, int order, int snake, float scale,
                                  void* stream) {
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<uint16_t*>(out);
  a.S_max = S_max;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.window = window;
  a.chunk = chunk;
  a.order = order;
  a.snake = snake;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch_rows<128>(a, B, st));
  if (D == 80) return static_cast<int>(launch_rows<80>(a, B, st));
  if (D == 64) return static_cast<int>(launch_rows<64>(a, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
