// The decode core shared by the paged decode kernel (B1,
// csrc/paged_decode.cu) and the contiguous one (B3, csrc/contig_decode.cu),
// for sm_90a. Plain CUDA C++ with raw PTX from sm90.cuh.
//
// A CTA of 128 threads is one split of one (batch row, kv head, row tile).
// The S CTAs of a thread-block cluster (S in {1, 2, 4, 8}) walk contiguous
// segments of the row's visit order, each with its own online softmax, and
// merge their partial (m, l, acc) over distributed shared memory at the
// end, in split order: no scratch, no atomics, no second launch, and equal
// bits from launch to launch. K and V stream through a ring of tiles of kT
// positions, filled with 16-byte cp.async copies that write
// zeros for every position at or past the row's length, so stale cache rows
// (0 x NaN is NaN) never reach a sum; the copies of the next tile are in
// flight while the CTA computes on the current one.
//
// This header holds what both kernels run: the ring, the CUDA-core path for
// a few query rows (the decode rows: each warp takes 16 of a tile's 64
// positions for every row, a lane pair splitting the head dim, so no warp
// idles at one row; the four warps' states are merged at the end), and the
// cluster merge and store. m and l are kept in the log2 domain (q is
// pre-scaled by scale * log2 e), the accumulator in float32.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace decode {

namespace hw = repro::sm90;

constexpr int kThreads = 128;  // four warps
constexpr int kT = 64;         // positions of a ring tile
// Ring depth. Two stages, the next tile in flight while one is computed:
// three or four at D 80 and 64 measured no faster on the H100 (PERF.md, §6).
constexpr int kStages = 2;
// CTAs an SM: the CUDA-core kernels (their registers and shared memory at
// D 128 fit three), B1's kernel with the tensor-core path (two).
constexpr int kRowCtasPerSm = 3;
constexpr int kChunkCtasPerSm = 2;
constexpr int kMaxRows = 64;   // query rows of a row tile (one wgmma M)
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// The CUDA-core path's ring stage: K rows padded by 16 bytes, so 8 lanes
// reading 16 bytes each of 8 positions hit 32 distinct banks; V rows dense.
// Its f32 query rows: half h of row r at r * QS + h * QH (the second half 16
// bytes late, so the two halves a warp reads fall in different banks).
template <int D>
struct RowsTile {
  static constexpr int KS = D + 8;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kT * KS * 2;
  static constexpr uint32_t kBytes = kV + kT * D * 2;
  static constexpr int QS = D + 8;
  static constexpr int QH = D / 2 + 4;
  static constexpr uint32_t q_bytes(int rows) { return rows * QS * 4; }
  // Bytes of the end-of-walk areas (reusing the ring): the export of `nx`
  // rows and the four warps' states of `r` rows.
  static constexpr uint32_t export_bytes(int nx) { return nx * (D + 2) * 4; }
  static constexpr uint32_t warps_bytes(int r) { return 4 * r * (D + 2) * 4; }
};

// The partial state a CTA exports to its cluster, at shared address `ex`
// for `nx` rows: m[nx], l[nx], then acc[nx][D], all float32.
__device__ __forceinline__ uint32_t ex_m(uint32_t ex, int r) { return ex + 4 * r; }
__device__ __forceinline__ uint32_t ex_l(uint32_t ex, int nx, int r) { return ex + 4 * (nx + r); }
template <int D>
__device__ __forceinline__ uint32_t ex_acc(uint32_t ex, int nx, int r, int c) {
  return ex + 4 * (2 * nx + r * D + c);
}

// The copies of one CUDA-core ring tile: position pp (< kT) of K and V at
// element offset off(pp) of k and v, or zeros where off(pp) < 0.
template <int D, class Off>
__device__ __forceinline__ void load_rows_tile(uint32_t stage, const uint16_t* k,
                                               const uint16_t* v, Off off) {
  using L = RowsTile<D>;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < kT * CH; i += kThreads) {
    const int pp = i / CH, c = i % CH;
    const long long o = off(pp);
    const bool ok = o >= 0;
    const size_t e = ok ? (size_t)o + c * 8 : 0;
    hw::cp_async_16(stage + L::kK + (pp * L::KS + c * 8) * 2, k + e, ok);
    hw::cp_async_16(stage + L::kV + (pp * D + c * 8) * 2, v + e, ok);
  }
}

// Query rows [0, R) in f32, scaled by `scale_log2`, from row(r) (rows at or
// past n_valid are zeros).
template <int D, int R, class Row>
__device__ __forceinline__ void load_rows_q(float* Qs, int n_valid, float scale_log2, Row row) {
  using L = RowsTile<D>;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n_valid) unpack8(*reinterpret_cast<const uint4*>(row(r) + c * 8), f);
    const int e = c * 8 < D / 2 ? c * 8 : L::QH + c * 8 - D / 2;
    float4* dst = reinterpret_cast<float4*>(Qs + r * L::QS + e);
    dst[0] = make_float4(f[0] * scale_log2, f[1] * scale_log2, f[2] * scale_log2,
                         f[3] * scale_log2);
    dst[1] = make_float4(f[4] * scale_log2, f[5] * scale_log2, f[6] * scale_log2,
                         f[7] * scale_log2);
  }
}

// The CUDA-core path's online softmax for R query rows: warp w owns tile
// positions [16 w, 16 w + 16); lane l takes position 16 w + l % 16 and half
// l / 16 of the head dim for the scores, and for P V the bf16 pairs l,
// l + 32, ... of the head dim.
template <int D, int R>
struct Rows {
  static constexpr int NP = D / 2;
  static constexpr int PPL = (NP + 31) / 32;
  static constexpr int DPL = 2 * PPL;
  float m[R], l[R], acc[R][DPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kMaskValue;
      l[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
    }
  }

  // One ring tile of n_cols positions at `tile` (shared); vis(r, pp): row r
  // sees tile position pp.
  template <class Vis>
  __device__ __forceinline__ void step(const unsigned char* tile, const float* Qs, int n_cols,
                                       Vis vis) {
    using L = RowsTile<D>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nc = n_cols - warp * 16;
    if (nc <= 0) return;  // warp-uniform
    const int h = lane >> 4;
    const int pp = warp * 16 + (lane & 15);
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(tile + L::kK);
    const uint16_t* Vs = reinterpret_cast<const uint16_t*>(tile + L::kV);

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const uint16_t* krow = Ks + pp * L::KS + h * (D / 2);
    const float* qh = Qs + h * L::QH;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(krow + c * 8), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qp = reinterpret_cast<const float4*>(qh + r * L::QS + c * 8);
        const float4 a = qp[0], b = qp[1];
        s[r] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] + b.x * kf[4] +
                b.y * kf[5] + b.z * kf[6] + b.w * kf[7];
      }
    }

    const bool in = (lane & 15) < nc;
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 16);
      const float sv = in && vis(r, pp) ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));  // finite: m starts at the mask value
      pr[r] = hw::exp2_approx(sv - m_new);            // 0 where masked
      const float alpha = hw::exp2_approx(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(h == 0 ? pr[r] : 0.f);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
    }

    const int n_use = min(16, nc);
    for (int jj = 0; jj < n_use; ++jj) {
      const uint16_t* vrow = Vs + (warp * 16 + jj) * D;
      float vf[DPL];
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int pi = lane + 32 * k;
        const uint32_t w = pi < NP ? *reinterpret_cast<const uint32_t*>(vrow + 2 * pi) : 0u;
        vf[2 * k] = bf16_lo(w);
        vf[2 * k + 1] = bf16_hi(w);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pr[r], jj);  // lane jj: position jj, half 0
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] += pj * vf[d];
      }
    }
  }

  // The four warps' states, through `wa` (shared, warps_bytes(R)), merged
  // in warp order into export rows [0, R) of `ex` (nx rows). Call after the
  // ring is drained; ends with a barrier.
  __device__ __forceinline__ void export_state(float* wa, float* ex, int nx) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* Wm = wa;
    float* Wl = wa + 4 * R;
    float* Wa = wa + 8 * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        Wm[warp * R + r] = m[r];
        Wl[warp * R + r] = l[r];
      }
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int pi = lane + 32 * k;
        if (pi < NP) {
          Wa[(warp * R + r) * D + 2 * pi] = acc[r][2 * k];
          Wa[(warp * R + r) * D + 2 * pi + 1] = acc[r][2 * k + 1];
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float mx = kMaskValue;
#pragma unroll
      for (int w = 0; w < 4; ++w) mx = fmaxf(mx, Wm[w * R + r]);
      float lt = 0.f, at = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float f = hw::exp2_approx(Wm[w * R + r] - mx);
        lt += Wl[w * R + r] * f;
        at += Wa[(w * R + r) * D + d] * f;
      }
      ex[2 * nx + r * D + d] = at;
      if (d == 0) {
        ex[r] = mx;
        ex[nx + r] = lt;
      }
    }
  }
};

// Runs the ring over the tiles from `first` on (next(t) the tile after t;
// t.valid() false past the last): the copies of tile i + kStages - 1 are
// issued before tile i is computed, so they are in flight meanwhile.
// issue(t, stage) issues a tile's copies, compute(t, stage) consumes it;
// started() runs once the first copies are issued (work that need not wait
// for them). kAsyncProxy: the tiles are read by wgmma (the async proxy).
template <bool kAsyncProxy, class Tile, class Next, class Issue, class Started, class Compute>
__device__ __forceinline__ void run_ring(Tile first, Next next, Issue issue, Started started,
                                         Compute compute) {
  Tile ld = first;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ld.valid()) {
      issue(ld, st);
      ld = next(ld);
    }
    hw::cp_async_commit();
  }
  started();
  int st = 0;
  for (Tile cu = first; cu.valid(); cu = next(cu)) {
    hw::cp_async_wait<kStages - 2>();
    if (kAsyncProxy) hw::fence_proxy_async();
    __syncthreads();  // tile `cu` landed for every thread; the stage of the one before is free
    if (ld.valid()) {
      issue(ld, (st + kStages - 1) % kStages);
      ld = next(ld);
    }
    hw::cp_async_commit();
    compute(cu, st);
    st = (st + 1) % kStages;
  }
  hw::cp_async_wait<0>();
  __syncthreads();
}

// Zeros for output rows [r0, n_out) (row r at out_row(r), bf16) in this
// rank's columns [k D / S, (k + 1) D / S): 16-byte stores where the share
// allows (a C-token step writes zeros for every row past q_len).
template <int D, class OutRow>
__device__ __forceinline__ void store_zeros(int S, int r0, int n_out, OutRow out_row) {
  const int cw = D / S;
  const int c0 = (int)hw::cluster_rank() * cw;
  if (cw % 8 == 0) {
    const int n = cw / 8;
    for (int e = threadIdx.x; e < (n_out - r0) * n; e += kThreads)
      *reinterpret_cast<uint4*>(out_row(r0 + e / n) + c0 + 8 * (e % n)) = make_uint4(0, 0, 0, 0);
  } else {
    const int n = cw / 2;
    for (int e = threadIdx.x; e < (n_out - r0) * n; e += kThreads)
      *reinterpret_cast<uint32_t*>(out_row(r0 + e / n) + c0 + 2 * (e % n)) = 0u;
  }
}

// No lse output: merge_store's default, under which it compiles to the
// store alone.
struct NoLse {
  __device__ __forceinline__ void operator()(int, float) const {}
};

// The natural log-sum-exp of a row from its merged log2-domain state: m2 +
// log2 l, over log2 e; kMaskValue where the row saw nothing (l == 0).
__device__ __forceinline__ float lse_of(float m2, float l) {
  return l > 0.f ? (m2 + __log2f(l)) * 0.6931471805599453f : kMaskValue;
}

// The cluster's merge: rank k of S stores output columns [k D / S, (k + 1)
// D / S) of rows [0, n_out) (row r at out_row(r), bf16), merging the S
// exports at `ex` (nx rows each) in split order; rows at or past n_valid
// are zeros. With an `lse` writer (anything but NoLse), rank 0 also calls
// lse(r, value) once for each of rows [0, n_out): the merged state's
// log-sum-exp (lse_of), kMaskValue past n_valid. Every thread of every CTA
// of the cluster calls it.
template <int D, class OutRow, class Lse = NoLse>
__device__ __forceinline__ void merge_store(uint32_t ex, int nx, int S, int n_valid, int n_out,
                                            OutRow out_row, Lse lse = Lse{}) {
  constexpr bool kLse = !std::is_same<Lse, NoLse>::value;
  hw::cluster_sync();  // every split's export is written
  const int cw = D / S;
  const int c0 = (int)hw::cluster_rank() * cw;
  const int pairs = cw / 2;
  for (int e = threadIdx.x; e < n_valid * pairs; e += kThreads) {
    const int r = e / pairs, c = c0 + 2 * (e % pairs);
    float mx = kMaskValue;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, hw::ld_cluster_f32(hw::map_rank(ex_m(ex, r), s)));
    float lt = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float f = hw::exp2_approx(hw::ld_cluster_f32(hw::map_rank(ex_m(ex, r), s)) - mx);
      lt += hw::ld_cluster_f32(hw::map_rank(ex_l(ex, nx, r), s)) * f;
      const float2 a = hw::ld_cluster_f32x2(hw::map_rank(ex_acc<D>(ex, nx, r, c), s));
      a0 += a.x * f;
      a1 += a.y * f;
    }
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    *reinterpret_cast<uint32_t*>(out_row(r) + c) = pack_bf16(a0 * inv, a1 * inv);
    if constexpr (kLse) {
      if (c == 0) lse(r, lse_of(mx, lt));  // rank 0's first pair of the row
    }
  }
  store_zeros<D>(S, n_valid, n_out, out_row);
  if constexpr (kLse) {
    if (hw::cluster_rank() == 0)
      for (int r = n_valid + (int)threadIdx.x; r < n_out; r += kThreads) lse(r, kMaskValue);
  }
  hw::cluster_sync();  // no split leaves while another still reads its export
}

// Splits a row's walk S ways: the largest S in {1, 2, 4, 8} whose items x
// S CTAs (`items` (row, kv head, row tile) items) all fit on the card at
// once at `per_sm` CTAs an SM, so no CTA waits for a second wave; no more
// splits than the row's `units` (pages or tiles); at least 1.
// repro_torch.kernels.flash_decode.decode_splits is its host model.
inline int pick_splits(int items, int units, int sms, int per_sm) {
  int s = 1;
  while (s < 8 && items * 2 * s <= per_sm * sms && 2 * s <= units) s *= 2;
  return s;
}

// The current device's SM count (once per device) and its index.
inline cudaError_t device_sms(int* sms, int* dev) {
  static int sms_of[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (sms_of[*dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sms_of[*dev];
  return cudaSuccess;
}

// Launches `kernel` over `grid` CTAs of kThreads in clusters of `splits`
// along x, with `smem` bytes of dynamic shared memory (opting the kernel in
// once per device and size).
template <class Kernel, class A>
cudaError_t launch_clusters(Kernel kernel, int* opted, int dev, dim3 grid, int splits, int smem,
                            const A& args, cudaStream_t stream) {
  if (smem > opted[dev]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace repro
