// Ragged paged attention for NVIDIA Hopper (sm_90a), plain CUDA C++.
//
// Replaces repro/kernels/flash_decode.py::_paged_decode_kernel, the Pallas
// kernel that runs every attention call of every mixed step of the
// continuous serve engine (decode rows and chunked-prefill rows alike).
//
// What it computes: for each (batch row b, kv head h) and each folded query
// row r = t * G + g (chunk position t, GQA member g), an online softmax over
// the row's KV pages, walked in the visit order the wrapper passes in
// (`logical` / `phys`, already gathered through the block table; the
// paper's sawtooth order keyed on the cache length after this step's
// write). Query t sits at position q_pos = len - q_len + t and sees column
// `col` iff col <= q_pos, col < len, t < q_len and, with a window,
// col > q_pos - window. Rows with nothing to see finalise to exact zeros
// (l == 0 -> 1). m, l and the accumulator stay in float32.
//
// What bounds it: bytes. Each (row, kv head, query-row tile) reads the K and
// V pages of its row once; a decode row does 4 flops per K/V element pair,
// far below the card's ~295 flops per byte. The design therefore:
//   * tiles the folded query rows across blocks (grid = B*Hkv x row tiles of
//     R = 4 warps * RPW rows). RPW grows with C*G, so a wide prefill chunk
//     re-reads K/V once per 32 rows, while a decode row (C*G small) gets a
//     block of its own and no idle rows beyond one warp's worth;
//   * streams K and V through shared memory in tiles of 64 positions with
//     16-byte loads, so a 512-row page never has to fit at once;
//   * skips pages and tiles that no row of the block can see (first column
//     >= len or > the block's largest q_pos, or wholly left of the window):
//     such a tile would add p = 0 and alpha = 1, so skipping is exact, and
//     the order of the tiles that are walked is kept;
//   * zero-fills K/V positions at or past len, so stale pool contents never
//     reach the accumulator.
// wgmma, TMA and a persistent tile scheduler are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // KV positions per shared-memory tile
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t f32_to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);                       // round to nearest even
  return u >> 16;
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

template <int D, int RPW>
struct Smem {
  static constexpr int R = kWarps * RPW;  // query rows per block
  static constexpr int KS = D + 8;        // padded K row (bf16): conflict-free 16-byte reads
  static constexpr size_t k_bytes = sizeof(uint16_t) * kTile * KS;
  static constexpr size_t v_bytes = sizeof(uint16_t) * kTile * D;
  static constexpr size_t q_bytes = sizeof(float) * R * D;
  static constexpr size_t p_bytes = sizeof(float) * kWarps * RPW * kTile;
  static constexpr size_t total = k_bytes + v_bytes + q_bytes + p_bytes;
};

template <int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const uint16_t* __restrict__ q,       // (B, C, Hq, D) bf16
                    const uint16_t* __restrict__ k_pool,  // (n_pages, page, Hkv, D) bf16
                    const uint16_t* __restrict__ v_pool,
                    const int* __restrict__ phys,         // (B, n_blocks) pool page ids, visit order
                    const int* __restrict__ logical,      // (B, n_blocks) logical page ids, visit order
                    const int* __restrict__ lens,         // (B,) valid KV length incl. this chunk
                    const int* __restrict__ q_lens,       // (B,) valid chunk rows
                    uint16_t* __restrict__ out,           // (B, C, Hq, D) bf16
                    int C, int Hq, int Hkv, int n_blocks, int page, int window, float scale) {
  using S = Smem<D, RPW>;
  constexpr int R = S::R;
  constexpr int KS = S::KS;
  constexpr int CH = D / 8;    // 16-byte chunks per K/V/q row
  constexpr int DPL = D / 32;  // accumulator dims per lane

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(smem + S::k_bytes);
  float* Qs = reinterpret_cast<float*>(smem + S::k_bytes + S::v_bytes);
  float* Ps = reinterpret_cast<float*>(smem + S::k_bytes + S::v_bytes + S::q_bytes);

  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int rows = C * G;
  const int row0 = blockIdx.y * R;
  const int row_end = min(row0 + R, rows);
  const int len = lens[b];
  const int q_len = q_lens[b];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Valid rows are a prefix of the folded axis: row < min(C, q_len) * G.
  int n_valid = min(C, max(q_len, 0)) * G - row0;
  n_valid = len > 0 ? max(0, min(n_valid, R)) : 0;

  if (n_valid == 0) {
    for (int row = row0 + warp; row < row_end; row += kWarps) {
      const int t = row / G, g = row % G;
      uint16_t* o = out + ((size_t)(b * C + t) * Hq + kvh * G + g) * D;
      for (int d = lane; d < D; d += 32) o[d] = 0;
    }
    return;
  }

  // Query tile, pre-scaled, in float32; rows past n_valid are zero.
  for (int i = tid; i < R * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n_valid) {
      const int row = row0 + r;
      const int t = row / G, g = row % G;
      const uint4 w = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * C + t) * Hq + kvh * G + g) * D + c * 8);
      unpack8(w, f);
    }
    float4* dst = reinterpret_cast<float4*>(Qs + r * D + c * 8);
    dst[0] = make_float4(f[0] * scale, f[1] * scale, f[2] * scale, f[3] * scale);
    dst[1] = make_float4(f[4] * scale, f[5] * scale, f[6] * scale, f[7] * scale);
  }

  const int qpos_base = len - q_len;
  const int qpos_min = qpos_base + row0 / G;
  const int qpos_max = qpos_base + (row0 + n_valid - 1) / G;
  const int col_limit = min(len - 1, qpos_max);  // last column any row can see

  const int wrow0 = warp * RPW;  // this warp's first row in the tile
  const bool warp_active = wrow0 < n_valid;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }

  for (int j = 0; j < n_blocks; ++j) {
    const int page_start = logical[b * n_blocks + j] * page;
    const int pid = phys[b * n_blocks + j];
    if (page_start > col_limit) continue;
    if (window >= 0 && page_start + page - 1 <= qpos_min - window) continue;
    for (int sub = 0; sub < page; sub += kTile) {
      const int col0 = page_start + sub;
      if (col0 > col_limit) break;
      const int n_cols = min(kTile, page - sub);
      if (window >= 0 && col0 + n_cols - 1 <= qpos_min - window) continue;

      __syncthreads();  // the previous tile is consumed (and the q tile written)
      for (int i = tid; i < kTile * CH; i += kThreads) {
        const int p = i / CH, c = i % CH;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u);
        uint4 vw = kw;
        if (p < n_cols && col0 + p < len) {
          const size_t off = ((size_t)((size_t)pid * page + sub + p) * Hkv + kvh) * D + c * 8;
          kw = *reinterpret_cast<const uint4*>(k_pool + off);
          vw = *reinterpret_cast<const uint4*>(v_pool + off);
        }
        *reinterpret_cast<uint4*>(Ks + p * KS + c * 8) = kw;
        *reinterpret_cast<uint4*>(Vs + p * D + c * 8) = vw;
      }
      __syncthreads();

      if (warp_active) {
        // Scores: lane owns tile positions `lane` and `lane + 32`.
        float s[RPW][2];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;
        const uint16_t* k0 = Ks + lane * KS;
        const uint16_t* k1 = Ks + (lane + 32) * KS;
#pragma unroll 2
        for (int c = 0; c < CH; ++c) {
          float ka[8], kb[8];
          unpack8(*reinterpret_cast<const uint4*>(k0 + c * 8), ka);
          unpack8(*reinterpret_cast<const uint4*>(k1 + c * 8), kb);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4* qp = reinterpret_cast<const float4*>(Qs + (wrow0 + r) * D + c * 8);
            const float4 qa = qp[0], qb = qp[1];
            s[r][0] += qa.x * ka[0] + qa.y * ka[1] + qa.z * ka[2] + qa.w * ka[3] +
                       qb.x * ka[4] + qb.y * ka[5] + qb.z * ka[6] + qb.w * ka[7];
            s[r][1] += qa.x * kb[0] + qa.y * kb[1] + qa.z * kb[2] + qa.w * kb[3] +
                       qb.x * kb[4] + qb.y * kb[5] + qb.z * kb[6] + qb.w * kb[7];
          }
        }

        // Online softmax update, one row at a time (warp-uniform loop).
        const int c0 = col0 + lane, c1 = col0 + lane + 32;
        const bool in0 = lane < n_cols && c0 < len;
        const bool in1 = lane + 32 < n_cols && c1 < len;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const bool row_ok = wrow0 + r < n_valid;
          const int qp = qpos_base + (row0 + wrow0 + r) / G;
          bool ok0 = row_ok && in0 && c0 <= qp;
          bool ok1 = row_ok && in1 && c1 <= qp;
          if (window >= 0) {
            ok0 = ok0 && c0 > qp - window;
            ok1 = ok1 && c1 > qp - window;
          }
          const float s0 = ok0 ? s[r][0] : kMaskValue;
          const float s1 = ok1 ? s[r][1] : kMaskValue;
          const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
          const float p0 = ok0 ? __expf(s0 - m_new) : 0.f;
          const float p1 = ok1 ? __expf(s1 - m_new) : 0.f;
          const float alpha = __expf(m[r] - m_new);
          l[r] = l[r] * alpha + warp_sum(p0 + p1);
          m[r] = m_new;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
          Ps[(warp * RPW + r) * kTile + lane] = p0;
          Ps[(warp * RPW + r) * kTile + lane + 32] = p1;
        }
        __syncwarp();

        // acc += P . V; lane owns output dims [lane * DPL, lane * DPL + DPL).
        const int n_use = min(n_cols, col_limit - col0 + 1);
        for (int jj = 0; jj < n_use; ++jj) {
          float v[DPL];
          const uint16_t* vrow = Vs + jj * D + lane * DPL;
          if constexpr (DPL == 4) {
            const uint2 w = *reinterpret_cast<const uint2*>(vrow);
            v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x);
            v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
          } else {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow);
            v[0] = bf16_lo(w); v[1] = bf16_hi(w);
          }
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float p = Ps[(warp * RPW + r) * kTile + jj];
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[r][d] += p * v[d];
          }
        }
        __syncwarp();
      }
    }
  }

  // Finalise: rows of this tile that exist in the output; invalid rows hold
  // acc = 0 and l = 0, so they store exact zeros.
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + wrow0 + r;
    if (row >= row_end) continue;
    const int t = row / G, g = row % G;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    uint16_t* o = out + ((size_t)(b * C + t) * Hq + kvh * G + g) * D + lane * DPL;
    if constexpr (DPL == 4) {
      uint2 w;
      w.x = f32_to_bf16(acc[r][0] * inv) | (f32_to_bf16(acc[r][1] * inv) << 16);
      w.y = f32_to_bf16(acc[r][2] * inv) | (f32_to_bf16(acc[r][3] * inv) << 16);
      *reinterpret_cast<uint2*>(o) = w;
    } else {
      *reinterpret_cast<uint32_t*>(o) =
          f32_to_bf16(acc[r][0] * inv) | (f32_to_bf16(acc[r][1] * inv) << 16);
    }
  }
}

template <int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v, const int* phys,
                   const int* logical, const int* lens, const int* q_lens, void* out, int B,
                   int C, int Hq, int Hkv, int n_blocks, int page, int window, float scale,
                   cudaStream_t stream) {
  using S = Smem<D, RPW>;
  auto kernel = paged_decode_kernel<D, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
  if (err != cudaSuccess) return err;
  const int rows = C * (Hq / Hkv);
  const dim3 grid(B * Hkv, (rows + S::R - 1) / S::R);
  kernel<<<grid, kThreads, S::total, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), phys, logical, lens, q_lens,
      static_cast<uint16_t*>(out), C, Hq, Hkv, n_blocks, page, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(int rpw, const void* q, const void* k, const void* v, const int* phys,
                        const int* logical, const int* lens, const int* q_lens, void* out,
                        int B, int C, int Hq, int Hkv, int n_blocks, int page, int window,
                        float scale, cudaStream_t stream) {
  switch (rpw) {
    case 1:
      return launch<D, 1>(q, k, v, phys, logical, lens, q_lens, out, B, C, Hq, Hkv, n_blocks,
                          page, window, scale, stream);
    case 2:
      return launch<D, 2>(q, k, v, phys, logical, lens, q_lens, out, B, C, Hq, Hkv, n_blocks,
                          page, window, scale, stream);
    case 4:
      return launch<D, 4>(q, k, v, phys, logical, lens, q_lens, out, B, C, Hq, Hkv, n_blocks,
                          page, window, scale, stream);
    default:
      return launch<D, 8>(q, k, v, phys, logical, lens, q_lens, out, B, C, Hq, Hkv, n_blocks,
                          page, window, scale, stream);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code:
// 0 on a successful launch. cudaErrorInvalidValue for an unsupported head
// dim. No synchronisation: the kernel runs on `stream`.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                 const void* phys, const void* logical, const void* lens,
                                 const void* q_lens, void* out, int B, int C, int Hq, int Hkv,
                                 int D, int n_blocks, int page, int window, float scale,
                                 void* stream) {
  const int rows = C * (Hq / Hkv);
  const int rpw = rows <= 4 ? 1 : rows <= 8 ? 2 : rows <= 16 ? 4 : 8;
  const int* ph = static_cast<const int*>(phys);
  const int* lg = static_cast<const int*>(logical);
  const int* ln = static_cast<const int*>(lens);
  const int* ql = static_cast<const int*>(q_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128) {
    err = launch_rows<128>(rpw, q, k_pool, v_pool, ph, lg, ln, ql, out, B, C, Hq, Hkv, n_blocks,
                           page, window, scale, st);
  } else if (D == 64) {
    err = launch_rows<64>(rpw, q, k_pool, v_pool, ph, lg, ln, ql, out, B, C, Hq, Hkv, n_blocks,
                          page, window, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
