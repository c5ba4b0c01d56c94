// Flash attention backward, step 3 of 3 (dK and dV): persistent and
// warp-specialised for NVIDIA Hopper (sm_90a), CUDA C++ with raw PTX: TMA
// loads and stores, wgmma products, mbarriers.
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
// Masked entries are selected to 0, never computed as exp(S - lse): a row
// that sees nothing carries lse = the mask value, where that exp overflows.
//
// Work items and their order (the paper's persistent wavefront on the
// transposed grid, Alg. 2/4). An item is one (slice bh = b * Hkv + kv head,
// KV tile jkv of 128 positions). Items are grouped into units of equal causal
// cost: KV tile j sees the Q tiles from about j upward, so unit p of a slice
// pairs the heavy tile p with the light tile n_kv - 1 - p (one item when they
// coincide), ceil(n_kv / 2) units a slice. Units are numbered slice-major
// (u = bh * ceil(n_kv / 2) + p) and dealt round-robin: the grid is one CTA per
// SM (at most one per unit), CTA w takes units w, w + grid, ..., each unit's
// heavy item first. The k-th item a CTA processes streams every (GQA group, Q
// tile of 64 rows) that sees its KV tile as one sweep,
// Traversal.stream_sweep(jkv, local_iter=k) at 64 x 128 tiles: the G groups x
// the trimmed Q range [lo, hi] linearised into G * (hi - lo + 1) positions,
// position j visiting snake_pos(k, j, n, group); the parity key is the
// worker-local pass counter. kernels/flash_attention.py::dkv_schedule is the
// host model of this order. Each item owns its tile's dK and dV over all
// groups, so there are no atomics and two runs give equal bits. A KV tile no
// row sees (causal with Skv > Sq, a window past the Q length) streams nothing
// and writes exact zeros. With `visit_out` (B*Hkv, n_kv, G*n_q) int32 each
// item records its sweep as group * n_q + q tile, -1 past its end.
//
// Roles: three warpgroups a CTA. Two warps of the last are the producer
// (setmaxnreg gives their registers away). In the first, one thread loads
// per item the K and V tiles (128 x D each) by TMA once, as soon as the
// item before has read them for the last time, then the sweep's Q and dO
// tiles (64 x D each) into a ring of kStages stages with full/empty
// mbarriers. In the second, 32 lanes copy each tile's 64 lse and delta into
// its stage with 4-byte cp.async copies (both are (B, Sq, Hq) float32,
// strided by Hq: a box of one 4-byte element is below TMA's 16-byte
// minimum), each lane's landing one arrival on the stage's full barrier.
// The first two warpgroups are consumers, 64 KV rows each. Per streamed
// tile a consumer computes S^T = K Q^T and dP^T = V dO^T as wgmma from
// shared memory (both operands K-major, 128-byte swizzle as TMA writes
// it), P^T and dS^T in f32 in registers, and rounds them to bf16 as the A
// operands of dV += P^T dO and dK += dS^T Q, with dO and Q read through a
// transposed (MN-major) descriptor of the same swizzled tile: four
// products, S^T once. Both f32 accumulators live in the warpgroup (64 + 64
// registers at D 128, plus 32 + 32 for S^T and dP^T, under setmaxnreg 232;
// the producer keeps 40, which its two roles need without spilling). Named
// barriers alternate the two consumers' issues (ping-pong), so one's
// elementwise work overlaps the other's products. Only tiles that cross the
// causal diagonal, the window's edge, Sq or Skv are masked, in their own
// copy of the elementwise code: interior tiles run one with no test at all.
// The epilogue writes dK and dV in bf16 into shared memory and stores them
// by TMA (positions past Skv left out), which runs on while the next item
// starts.
//
// Head dims: 64 (one 128-byte panel a row) and 128 (two panels). D 80
// (zamba2's shared attention) and 96 (phi-3-vision's) run the D 128
// layout, as the forward (B2) does, in the same shared memory: the tensor
// maps' innermost extent is D, so TMA writes zeros into columns D-127 of
// every K, V, Q and dO tile; S^T = K Q^T and dP^T = V dO^T take only the D
// / 16 k-steps that hold data (5 and 6, each its own instantiation: the
// k-step count is a template parameter, since a wgmma issued under a
// runtime condition makes ptxas serialise every product); dV = P^T dO and
// dK = dS^T Q compute 128 columns, of which the TMA stores write D. Its
// cost: 3/8 (D 80) and 1/4 (D 96) of those two products is spent on
// zeros.
//
// What bounds it on this card: at the training shape (B 4, S 1024, 32 heads
// of 128, causal) the four products over the visible (query, key) pairs take
// 68.8 GFLOP, 0.070 ms at the bf16 peak, and the bytes (q, k, v, dO, dk, dv
// in bf16, lse and delta in f32; 202 MB) 0.060 ms, so operations by a
// little. K and V are read once per item; each Q and dO tile once per KV
// tile that it sees, from L2, where the slice-major order keeps them.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;
namespace hw = repro::sm90;

constexpr int kBN = 128;  // KV positions per item (two consumer warpgroups of 64)
constexpr int kBM = 64;   // Q rows per streamed tile
constexpr int kStages = 3;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr uint32_t kKVPanel = kBN * 128;  // bytes of one 64-column panel of a K or V tile
constexpr uint32_t kQPanel = kBM * 128;   // ... of a streamed Q or dO tile
constexpr uint32_t kRowBytes = 2 * kBM * 4;  // a stage's lse and delta
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kNS = kBM / 2;  // S^T, dP^T accumulator registers (64 x 64 over 128 threads)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the instantiation for head dim DP, from a 1024-byte
// aligned base (the 128-byte swizzle's repeat).
template <int DP>
struct Layout {
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kKVBytes = kBN * DP * 2;
  static constexpr uint32_t kQBytes = kBM * DP * 2;
  static constexpr uint32_t kOutBytes = 64 * DP * 2;  // one consumer's 64 rows of dK or dV
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKVBytes;
  static constexpr uint32_t kQ = kV + kKVBytes;
  static constexpr uint32_t kDO = kQ + kStages * kQBytes;
  static constexpr uint32_t kOut = kDO + kStages * kQBytes;  // per consumer: dK, then dV
  static constexpr uint32_t kRows = kOut + kConsumers * 2 * kOutBytes;
  static constexpr uint32_t kBar = kRows + kStages * kRowBytes;
  // mbarriers: kv_full, kv_empty, then qd_full and qd_empty of each stage.
  static constexpr uint32_t kBytes = kBar + 8 * (2 + 2 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;  // slack for aligning the base
};

__device__ __forceinline__ uint32_t kv_full(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t kv_empty(uint32_t bar) { return bar + 8; }
__device__ __forceinline__ uint32_t qd_full(uint32_t bar, int st) { return bar + 16 + 8 * st; }
__device__ __forceinline__ uint32_t qd_empty(uint32_t bar, int st) {
  return bar + 16 + 8 * (kStages + st);
}

struct Args {
  const float* lse;
  const float* delta;
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, G, n_q, n_kv;
  int half;     // ceil(n_kv / 2): units per slice
  int n_units;  // B * Hkv * half
  int causal, window, order, snake;
  float scale, scale_log2;  // scale_log2 = scale * log2(e)
};

// Unit u's items: its heavy KV tile (m = 0), then its light one (m = 1),
// which is the same tile when the two coincide; items(u) says how many.
__device__ __forceinline__ int unit_items(const Args& p, int u) {
  return 2 * (u % p.half) + 1 == p.n_kv ? 1 : 2;
}
__device__ __forceinline__ int unit_tile(const Args& p, int u, int m) {
  return m == 0 ? u % p.half : p.n_kv - 1 - u % p.half;
}

// Inclusive [lo, hi] Q tiles that see KV tile `jkv` (Traversal.q_bounds_host
// at kBM x kBN tiles); hi < lo when no row sees it.
__device__ __forceinline__ void q_range(const Args& p, int jkv, int& lo, int& hi) {
  lo = p.causal ? jkv * kBN / kBM : 0;
  hi = p.window >= 0 ? min(p.n_q - 1, ((jkv + 1) * kBN + p.window - 2) / kBM) : p.n_q - 1;
}

// The producer's two roles, each run by its own warp of the last warpgroup
// over the same items and tiles: kRows false, one thread issues the TMA
// loads (and writes the walk record); kRows true, 32 lanes copy each tile's
// lse and delta.
template <int DP, bool kRows>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const Args& p, uint32_t base, int lane) {
  using L = Layout<DP>;
  const uint32_t bar = base + L::kBar;
  if (!kRows) {
    hw::tma_prefetch_desc(tq);
    hw::tma_prefetch_desc(tk);
    hw::tma_prefetch_desc(tv);
    hw::tma_prefetch_desc(tdo);
  }
  int k = 0, kv = 0, c = 0;  // items, K/V loads and streamed tiles this CTA has issued
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int nm = unit_items(p, u);
    for (int m = 0; m < nm; ++m, ++k) {
      const int jkv = unit_tile(p, u, m);
      const int b = u / p.half / p.Hkv, kvh = u / p.half % p.Hkv;
      int lo, hi;
      q_range(p, jkv, lo, hi);
      const int steps = hi - lo + 1;
      const int total = p.G * max(steps, 0);
      const int group = order_group(p.order, p.snake, total);
      if (!kRows && total > 0) {
        hw::mbar_wait(kv_empty(bar), (kv & 1) ^ 1);
        hw::mbar_expect_tx(kv_full(bar), 2 * L::kKVBytes);
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn) {
          hw::tma_load_4d(base + L::kK + pn * kKVPanel, tk, kv_full(bar), pn * 64, kvh, jkv * kBN,
                          b);
          hw::tma_load_4d(base + L::kV + pn * kKVPanel, tv, kv_full(bar), pn * 64, kvh, jkv * kBN,
                          b);
        }
      }
      if (total > 0) ++kv;
      for (int j = 0; j < total; ++j, ++c) {
        const int uu = snake_pos(k, j, total, group);
        const int head = kvh * p.G + uu / steps;
        const int row0 = (lo + uu % steps) * kBM;
        const int st = c % kStages;
        hw::mbar_wait(qd_empty(bar, st), ((c / kStages) & 1) ^ 1);
        if (kRows) {
          // lse and delta of the tile's rows lane and lane + 32; zeros past Sq
          // (those rows are masked).
          const uint32_t rows = base + L::kRows + st * kRowBytes + 4 * lane;
#pragma unroll
          for (int r = 0; r < kBM; r += 32) {
            const bool in = row0 + r + lane < p.Sq;
            const size_t at = in ? (size_t)(b * p.Sq + row0 + r + lane) * p.Hq + head : 0;
            hw::cp_async_4(rows + 4 * r, p.lse + at, in);
            hw::cp_async_4(rows + 4 * (kBM + r), p.delta + at, in);
          }
          hw::cp_async_mbar_arrive(qd_full(bar, st));
        } else {
          hw::mbar_expect_tx(qd_full(bar, st), 2 * L::kQBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn) {
            hw::tma_load_4d(base + L::kQ + st * L::kQBytes + pn * kQPanel, tq, qd_full(bar, st),
                            pn * 64, head, row0, b);
            hw::tma_load_4d(base + L::kDO + st * L::kQBytes + pn * kQPanel, tdo, qd_full(bar, st),
                            pn * 64, head, row0, b);
          }
          if (p.visit != nullptr)
            p.visit[((size_t)(u / p.half) * p.n_kv + jkv) * p.G * p.n_q + j] =
                (uu / steps) * p.n_q + lo + uu % steps;
        }
      }
      if (!kRows && p.visit != nullptr)
        for (int j = total; j < p.G * p.n_q; ++j)
          p.visit[((size_t)(u / p.half) * p.n_kv + jkv) * p.G * p.n_q + j] = -1;
    }
  }
}

// Named barriers: 1 and 2 order the two consumer warpgroups' product
// issues (ping-pong); 3 and 4 are each consumer's own, around its epilogue.
constexpr int kBarTurn = 1, kBarEpilogue = 3;

// S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 KV rows against the
// Q and dO tiles of stage st, over the KS k-steps of 16 columns that hold
// data. The first k-step writes the accumulators without reading them, so
// they hold no live values between products.
template <int DP, int KS>
__device__ __forceinline__ void issue_sdp(float (&s)[kNS], float (&dp)[kNS], uint32_t base, int st,
                                          int wg) {
  using L = Layout<DP>;
  auto kv_desc = [&](uint32_t tile, int kk) {
    return hw::desc_sw128(base + tile + (kk / 4) * kKVPanel + wg * 64 * 128 + (kk % 4) * 32, 16,
                          1024);
  };
  auto q_desc = [&](uint32_t tile, int kk) {
    return hw::desc_sw128(base + tile + st * L::kQBytes + (kk / 4) * kQPanel + (kk % 4) * 32, 16,
                          1024);
  };
  hw::wgmma_ss_m64n64_set(s, kv_desc(L::kK, 0), q_desc(L::kQ, 0));
#pragma unroll
  for (int kk = 1; kk < KS; ++kk)
    hw::wgmma_ss_m64n64(s, kv_desc(L::kK, kk), q_desc(L::kQ, kk), 1);
  hw::wgmma_ss_m64n64_set(dp, kv_desc(L::kV, 0), q_desc(L::kDO, 0));
#pragma unroll
  for (int kk = 1; kk < KS; ++kk)
    hw::wgmma_ss_m64n64(dp, kv_desc(L::kV, kk), q_desc(L::kDO, kk), 1);
}

// dV += P^T dO and dK += dS^T Q, dO and Q of stage st through transposed
// descriptors (their 64-column panels LBO apart).
template <int DP>
__device__ __forceinline__ void issue_dkv(float (&dv)[DP / 2], float (&dk)[DP / 2],
                                          const uint32_t (&pa)[kBM / 16][4],
                                          const uint32_t (&da)[kBM / 16][4], uint32_t base,
                                          int st) {
  using L = Layout<DP>;
#pragma unroll
  for (int kc = 0; kc < kBM / 16; ++kc) {
    const uint64_t od =
        hw::desc_sw128(base + L::kDO + st * L::kQBytes + kc * 16 * 128, kQPanel, 1024);
    if constexpr (DP == 128)
      hw::wgmma_rs_m64n128_tb(dv, pa[kc], od);
    else
      hw::wgmma_rs_m64n64_tb(dv, pa[kc], od);
  }
#pragma unroll
  for (int kc = 0; kc < kBM / 16; ++kc) {
    const uint64_t qd =
        hw::desc_sw128(base + L::kQ + st * L::kQBytes + kc * 16 * 128, kQPanel, 1024);
    if constexpr (DP == 128)
      hw::wgmma_rs_m64n128_tb(dk, da[kc], qd);
    else
      hw::wgmma_rs_m64n64_tb(dk, da[kc], qd);
  }
}

// P^T = 2^(s * scale_log2 - lse * log2(e)) and dS^T = P^T (dP^T - delta) scale of
// this thread's entries (KV rows kv0 and kv0 + 8, Q columns 8 n + 2 t + {0,
// 1} of the tile at row0), rounded to bf16 A fragments. On edge tiles
// (kEdge) masked entries are selected to 0; interior tiles get a copy with
// no test at all.
template <bool kEdge>
__device__ __forceinline__ void grads_tile(const float (&s)[kNS], const float (&dp)[kNS],
                                           uint32_t (&pa)[kBM / 16][4],
                                           uint32_t (&da)[kBM / 16][4], const float* rows,
                                           const Args& p, int kv0, int row0, int t) {
#pragma unroll
  for (int kc = 0; kc < kBM / 16; ++kc) {
    float pr[8], ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = 8 * kc + e;
      const int qc = 8 * (x >> 2) + 2 * t + (x & 1);
      float v = hw::exp2_approx(fmaf(s[x], p.scale_log2, -kLog2e * rows[qc]));
      if (kEdge && !visible<true>(row0 + qc, kv0 + 8 * ((x >> 1) & 1), p.Sq, p.Skv, p.causal,
                                  p.window))
        v = 0.f;
      pr[e] = v;
      ds[e] = v * (dp[x] - rows[kBM + qc]) * p.scale;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kc][r] = hw::cvt_bf16x2(pr[2 * r], pr[2 * r + 1]);
      da[kc][r] = hw::cvt_bf16x2(ds[2 * r], ds[2 * r + 1]);
    }
  }
}

// This warpgroup's 64 rows of one accumulator in bf16 into shared memory at
// `so`, in the 128-byte swizzle of the output's tensor map.
template <int DP>
__device__ __forceinline__ void stage_out(uint32_t so, const float (&acc)[DP / 2], int r0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn)
      hw::st_shared_u32(so + (jn / 8) * 64 * 128 + r * 128 + (((jn % 8) ^ (r % 8)) * 16) + 4 * t,
                        hw::cvt_bf16x2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]));
  }
}

// A consumer warpgroup: 64 KV rows of every item this CTA takes.
template <int DP, int KS>
__device__ __forceinline__ void consumer(const CUtensorMap* tdk, const CUtensorMap* tdv,
                                         const Args& p, uint32_t base, const float* rows_smem,
                                         int wg) {
  using L = Layout<DP>;
  constexpr int NO = DP / 2;  // dK, dV accumulator registers each
  const uint32_t bar = base + L::kBar;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (tid >> 5) * 16 + g;  // this thread's first row of the warpgroup's 64
  auto turn = [&]() { hw::named_sync(kBarTurn + wg, 256); };
  auto pass = [&]() { hw::named_arrive(kBarTurn + 1 - wg, 256); };

  float s[kNS], dp[kNS];
  float dv[NO], dk[NO];
  uint32_t pa[kBM / 16][4], da[kBM / 16][4];
  if (wg == 1) hw::named_arrive(kBarTurn, 256);  // the first warpgroup issues first

  int k = 0, kv = 0, c = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int bh = u / p.half;
    const int b = bh / p.Hkv, kvh = bh % p.Hkv;
    const int nm = unit_items(p, u);
    for (int m = 0; m < nm; ++m, ++k) {
      const int jkv = unit_tile(p, u, m);
      const int col0 = jkv * kBN + wg * 64;  // this warpgroup's first KV position
      int lo, hi;
      q_range(p, jkv, lo, hi);
      const int steps = hi - lo + 1;
      const int total = p.G * max(steps, 0);
      const int group = order_group(p.order, p.snake, total);
#pragma unroll
      for (int x = 0; x < NO; ++x) dv[x] = dk[x] = 0.f;
      if (total > 0) hw::mbar_wait(kv_full(bar), kv & 1);
      for (int j = 0; j < total; ++j, ++c) {
        const int uu = snake_pos(k, j, total, group);
        const int row0 = (lo + uu % steps) * kBM;
        const int st = c % kStages;
        hw::mbar_wait(qd_full(bar, st), (c / kStages) & 1);
        turn();
        hw::wgmma_fence();
        issue_sdp<DP, KS>(s, dp, base, st, wg);
        hw::wgmma_commit();
        pass();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < kNS; ++x) {
          hw::fence_reg(s[x]);
          hw::fence_reg(dp[x]);
        }
        if (j == total - 1 && lane == 0) hw::mbar_arrive(kv_empty(bar));  // K, V read
        const bool edge = col0 + 64 > p.Skv || row0 + kBM > p.Sq ||
                          (p.causal && col0 + 63 > row0) ||
                          (p.window >= 0 && col0 <= row0 + kBM - 1 - p.window);
        const float* rows = rows_smem + st * (kRowBytes / 4);
        if (edge)
          grads_tile<true>(s, dp, pa, da, rows, p, col0 + wrow, row0, t);
        else
          grads_tile<false>(s, dp, pa, da, rows, p, col0 + wrow, row0, t);
        turn();
#pragma unroll
        for (int x = 0; x < NO; ++x) {
          hw::fence_reg(dv[x]);
          hw::fence_reg(dk[x]);
        }
#pragma unroll
        for (int kc = 0; kc < kBM / 16; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hw::fence_reg(pa[kc][r]);
            hw::fence_reg(da[kc][r]);
          }
        hw::wgmma_fence();
        issue_dkv<DP>(dv, dk, pa, da, base, st);
        hw::wgmma_commit();
        pass();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NO; ++x) {
          hw::fence_reg(dv[x]);
          hw::fence_reg(dk[x]);
        }
        if (lane == 0) hw::mbar_arrive(qd_empty(bar, st));
      }
      if (total > 0) ++kv;

      // Epilogue: dK and dV in bf16 into this warpgroup's buffers, stored by
      // TMA (positions past Skv left out). The stores run on while the next
      // item starts; the buffers are rewritten only after they have been read.
      const uint32_t so = base + L::kOut + wg * 2 * L::kOutBytes;
      if (tid == 0) hw::bulk_wait_read<0>();
      hw::named_sync(kBarEpilogue + wg, 128);
      stage_out<DP>(so, dk, wrow, t);
      stage_out<DP>(so + L::kOutBytes, dv, wrow, t);
      hw::fence_proxy_async();
      hw::named_sync(kBarEpilogue + wg, 128);
      if (tid == 0 && col0 < p.Skv) {
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn) {
          hw::tma_store_4d(tdk, so + pn * 64 * 128, pn * 64, kvh, col0, b);
          hw::tma_store_4d(tdv, so + L::kOutBytes + pn * 64 * 128, pn * 64, kvh, col0, b);
        }
        hw::bulk_commit();
      }
    }
  }
  if (wg == 0) hw::named_sync(kBarTurn, 256);  // the second warpgroup's last pass
  if (tid == 0) hw::bulk_wait<0>();
}

template <int DP, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tdk,
                         const __grid_constant__ CUtensorMap tdv, const Args p) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* rows_smem = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t bar = base + L::kBar;
  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full(bar), 1);                // the producer's expect_tx
    hw::mbar_init(kv_empty(bar), kConsumerWarps);  // one arrival a consumer warp
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(qd_full(bar, st), 33);  // one expect_tx and 32 lanes' lse/delta copies
      hw::mbar_init(qd_empty(bar, st), kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    hw::setmaxnreg_dec<kProducerRegs>();
    const int ptid = threadIdx.x % 128;
    if (ptid == 0) producer<DP, false>(&tq, &tk, &tv, &tdo, p, base, 0);
    else if (ptid >= 32 && ptid < 64) producer<DP, true>(&tq, &tk, &tv, &tdo, p, base, ptid - 32);
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    consumer<DP, KS>(&tdk, &tdv, p, base, rows_smem, wg);
  }
}

// The instantiation for padded head dim DP and KS k-steps over head dim D
// (the tensors' own, which the tensor maps take as their innermost extent).
template <int DP, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dO, void* dk,
                   void* dv, const Args& a, int B, int D, cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!hw::tensor_map_bshd(&tq, q, B, a.Sq, a.Hq, D, kBM) ||
      !hw::tensor_map_bshd(&tdo, dO, B, a.Sq, a.Hq, D, kBM) ||
      !hw::tensor_map_bshd(&tk, k, B, a.Skv, a.Hkv, D, kBN) ||
      !hw::tensor_map_bshd(&tv, v, B, a.Skv, a.Hkv, D, kBN) ||
      !hw::tensor_map_bshd(&tdk, dk, B, a.Skv, a.Hkv, D, 64) ||
      !hw::tensor_map_bshd(&tdv, dv, B, a.Skv, a.Hkv, D, 64))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err =
      hw::persistent_setup<flash_bwd_dkv_kernel<DP, KS>>((int)L::kAlloc, &sms);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP, KS><<<min(sms, a.n_units), kThreads, L::kAlloc, stream>>>
      (tq, tk, tv, tdo, tdk, tdv, a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim or
// a tensor map the driver refuses. `order`: 0 cyclic, 1 sawtooth, 2
// block_snake (reversal groups of `snake` tiles); `window` < 0 means none;
// `visit` may be null. No synchronisation: the kernel runs on `stream`.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* visit, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                  int causal, int window, int order, int snake, float scale,
                                  void* stream) {
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.visit = static_cast<int*>(visit);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.n_q = (Sq + kBM - 1) / kBM;
  a.n_kv = (Skv + kBN - 1) / kBN;
  a.half = (a.n_kv + 1) / 2;
  a.n_units = B * Hkv * a.half;
  a.causal = causal;
  a.window = window;
  a.order = order;
  a.snake = snake;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.n_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) return static_cast<int>(launch<128, 8>(q, k, v, dO, dk, dv, a, B, D, st));
  if (D == 80) return static_cast<int>(launch<128, 5>(q, k, v, dO, dk, dv, a, B, D, st));
  if (D == 96) return static_cast<int>(launch<128, 6>(q, k, v, dO, dk, dv, a, B, D, st));
  if (D == 64) return static_cast<int>(launch<64, 4>(q, k, v, dO, dk, dv, a, B, D, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation that serves head dim D: out[0] registers a thread (at
// launch, before setmaxnreg moves them), out[1] dynamic shared memory bytes,
// out[2] threads a CTA, out[3] local (spill) bytes a thread, out[4] Q rows
// of a streamed tile, out[5] KV positions of an item. Returns a cudaError_t
// code.
extern "C" int flash_bwd_dkv_attr(int D, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (D == 128 || D == 80 || D == 96) {
    err = cudaFuncGetAttributes(&fa, D == 128  ? flash_bwd_dkv_kernel<128, 8>
                                     : D == 96 ? flash_bwd_dkv_kernel<128, 6>
                                               : flash_bwd_dkv_kernel<128, 5>);
    out[1] = (int)Layout<128>::kAlloc;
  } else if (D == 64) {
    err = cudaFuncGetAttributes(&fa, flash_bwd_dkv_kernel<64, 4>);
    out[1] = (int)Layout<64>::kAlloc;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[2] = kThreads;
  out[3] = (int)fa.localSizeBytes;
  out[4] = kBM;
  out[5] = kBN;
  return 0;
}
