// Flash attention backward, step 2 of 3 (dQ): persistent and
// warp-specialised for NVIDIA Hopper (sm_90a), CUDA C++ with raw PTX: TMA
// loads and stores, wgmma products, mbarriers.
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
// Work items and their order: the forward kernel's (B2, csrc/flash_fwd.cu)
// at the same 128 x 128 tiles. An item is one (slice bh = b * Hkv + kv head,
// folded row i), the folded row being GQA group i / n_q and Q tile i % n_q.
// Units of equal causal cost pair the heavy Q tile n_q - 1 - p with the light
// tile p of a group; they are numbered slice-major and dealt round-robin to
// one CTA per SM (at most one per unit), each unit's heavy item first. The
// k-th item a CTA processes walks the KV tiles of its trimmed range [lo, hi]
// as Traversal.kv_order(q_tile, local_iter=k): the parity key is the
// worker-local pass counter. kernels/flash_attention.py::fwd_schedule is the
// host model of this order. Tiles outside the range are skipped. Each item
// owns its dQ rows, so there are no atomics and two runs give equal bits.
// With `visit_out` (B*Hkv, G*n_q, n_kv) int32 each item records the tiles it
// walked, -1 past its range.
//
// Roles: three warpgroups a CTA. The last is the producer (one thread
// issues everything; setmaxnreg gives its registers away): per item it
// loads the Q and dO tiles (128 x D each) by TMA once, as soon as the last
// products of the item before have read them, then the K and V tiles
// (kBN x D each) into a ring of kStages stages with full/empty mbarriers.
// The first two are consumers, 64 Q rows each, with their rows' lse (in the
// log2 domain) and delta in registers, read once an item with plain loads.
// Per KV tile a consumer computes S = Q K^T and dP = dO V^T as wgmma from
// shared memory (both operands K-major, 128-byte swizzle as TMA writes it),
// dS in f32 in registers, rounds it to bf16 as the A operand of dQ += dS K,
// with K read through a transposed (MN-major) descriptor. Named barriers
// alternate the two consumers' issues (ping-pong), so one's elementwise work
// overlaps the other's products. Only tiles that cross the causal diagonal,
// the window's edge, Sq or Skv are masked, in their own copy of the
// elementwise code: interior tiles run one with no test at all. The
// epilogue writes dQ in bf16
// into shared memory and stores it by TMA (rows past Sq left out), which runs
// on while the next item starts.
//
// Head dims: 64 (one 128-byte panel a row) and 128 (two panels). D 80
// (zamba2's shared attention) and 96 (phi-3-vision's) run the D 128
// layout, as the forward (B2) does: the tensor maps' innermost extent is
// D, so TMA writes zeros into columns D-127 of every Q, dO, K and V tile;
// S = Q K^T and dP = dO V^T take only the D / 16 k-steps that hold data (5
// and 6, each its own instantiation: the k-step count is a template
// parameter, since a wgmma issued under a runtime condition makes ptxas
// serialise every product); dQ = dS K computes 128 columns, of which the
// TMA store writes D. Its cost: 3/8 (D 80) and 1/4 (D 96) of the dQ
// product is spent on zeros, and each tile takes the shared memory of D
// 128.
//
// What bounds it on this card: at the training shape (B 4, S 1024, 32 heads
// of 128, causal) the three products over the visible (query, key) pairs
// take 51.6 GFLOP, 0.052 ms at the bf16 peak, and the bytes (q, k, v, dO, dq
// in bf16, lse and delta in f32; 169 MB) 0.050 ms, so operations by a
// little. Q and dO are read once per item; K and V once per Q tile that sees
// them, from L2, where the slice-major order keeps them.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;
namespace hw = repro::sm90;

constexpr int kBM = 128;  // Q rows per item (two consumer warpgroups of 64)
constexpr int kBN = 128;  // KV positions per tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr uint32_t kQPanel = kBM * 128;   // bytes of one 64-column panel of a Q or dO tile
constexpr uint32_t kKVPanel = kBN * 128;  // ... of a K or V tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kNS = kBN / 2;  // S, dP accumulator registers (64 x kBN over 128 threads)

// Shared memory of the instantiation for head dim DP, from a 1024-byte
// aligned base (the 128-byte swizzle's repeat).
template <int DP>
struct Layout {
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kQBytes = kBM * DP * 2;
  static constexpr uint32_t kKVBytes = kBN * DP * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kQBytes;
  static constexpr uint32_t kK = kDO + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kO = kV + kStages * kKVBytes;  // each consumer's 64 rows of dQ
  static constexpr uint32_t kOBytes = 64 * DP * 2;
  static constexpr uint32_t kBar = kO + kConsumers * kOBytes;
  // mbarriers: q_full, q_empty (Q and dO), then kv_full and kv_empty of each
  // stage.
  static constexpr uint32_t kBytes = kBar + 8 * (2 + 2 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;  // slack for aligning the base
};

__device__ __forceinline__ uint32_t q_full(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t q_empty(uint32_t bar) { return bar + 8; }
__device__ __forceinline__ uint32_t kv_full(uint32_t bar, int st) { return bar + 16 + 8 * st; }
__device__ __forceinline__ uint32_t kv_empty(uint32_t bar, int st) {
  return bar + 16 + 8 * (kStages + st);
}

struct Args {
  const float* lse;
  const float* delta;
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, G, n_q, n_kv;
  int half;             // ceil(n_q / 2): units per GQA group
  int units_per_slice;  // G * half
  int n_units;          // B * Hkv * units_per_slice
  int causal, window, order, snake;
  float scale, scale_log2;  // scale_log2 = scale * log2(e)
};

// Unit u's items: the folded row of its heavy Q tile (m = 0), then of its
// light one (m = 1), which is the same tile when the two coincide;
// unit_items(u) says how many.
__device__ __forceinline__ int unit_items(const Args& p, int u) {
  return 2 * (u % p.units_per_slice % p.half) + 1 == p.n_q ? 1 : 2;
}
__device__ __forceinline__ int unit_row(const Args& p, int u, int m) {
  const int r = u % p.units_per_slice;
  const int pair = r % p.half;
  return r / p.half * p.n_q + (m == 0 ? p.n_q - 1 - pair : pair);
}

// Inclusive [lo, hi] KV tiles seen by Q tile `q_tile` (Traversal.kv_bounds_host
// at kBM x kBN tiles); hi < lo when a window leaves nothing.
__device__ __forceinline__ void kv_range(const Args& p, int q_tile, int& lo, int& hi) {
  const int row0 = q_tile * kBM;
  hi = p.causal ? min(p.n_kv - 1, (row0 + kBM - 1) / kBN) : p.n_kv - 1;
  lo = p.window >= 0 ? max(row0 - (p.window - 1), 0) / kBN : 0;
}

template <int DP>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const Args& p, uint32_t base) {
  using L = Layout<DP>;
  const uint32_t bar = base + L::kBar;
  hw::tma_prefetch_desc(tq);
  hw::tma_prefetch_desc(tdo);
  hw::tma_prefetch_desc(tk);
  hw::tma_prefetch_desc(tv);
  int k = 0, c = 0;  // items and KV tiles this CTA has issued
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int bh = u / p.units_per_slice;
    const int b = bh / p.Hkv, kvh = bh % p.Hkv;
    const int nm = unit_items(p, u);
    for (int m = 0; m < nm; ++m, ++k) {
      const int i = unit_row(p, u, m);
      const int q_tile = i % p.n_q;
      const int head = kvh * p.G + i / p.n_q;
      hw::mbar_wait(q_empty(bar), (k & 1) ^ 1);
      hw::mbar_expect_tx(q_full(bar), 2 * L::kQBytes);
#pragma unroll
      for (int pn = 0; pn < L::kPanels; ++pn) {
        hw::tma_load_4d(base + L::kQ + pn * kQPanel, tq, q_full(bar), pn * 64, head,
                        q_tile * kBM, b);
        hw::tma_load_4d(base + L::kDO + pn * kQPanel, tdo, q_full(bar), pn * 64, head,
                        q_tile * kBM, b);
      }
      int lo, hi;
      kv_range(p, q_tile, lo, hi);
      const int raw = hi - lo + 1;
      const int group = order_group(p.order, p.snake, raw);
      int* vrow = p.visit == nullptr
                      ? nullptr
                      : p.visit + ((size_t)bh * p.G * p.n_q + i) * p.n_kv;
      for (int j = 0; j < raw; ++j) {
        const int tile = lo + snake_pos(k, j, raw, group);
        const int st = (c + j) % kStages;
        hw::mbar_wait(kv_empty(bar, st), (((c + j) / kStages) & 1) ^ 1);
        hw::mbar_expect_tx(kv_full(bar, st), 2 * L::kKVBytes);
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn) {
          hw::tma_load_4d(base + L::kK + st * L::kKVBytes + pn * kKVPanel, tk, kv_full(bar, st),
                          pn * 64, kvh, tile * kBN, b);
          hw::tma_load_4d(base + L::kV + st * L::kKVBytes + pn * kKVPanel, tv, kv_full(bar, st),
                          pn * 64, kvh, tile * kBN, b);
        }
        if (vrow != nullptr) vrow[j] = tile;
      }
      c += max(raw, 0);
      if (vrow != nullptr)
        for (int j = max(raw, 0); j < p.n_kv; ++j) vrow[j] = -1;
    }
  }
}

// Named barriers: 1 and 2 order the two consumer warpgroups' product
// issues (ping-pong); 3 and 4 are each consumer's own, around its epilogue.
constexpr int kBarTurn = 1, kBarEpilogue = 3;

// S = Q K^T and dP = dO V^T for this warpgroup's 64 rows against the K and V
// tiles of stage st, over the KS k-steps of 16 columns that hold data. The
// first k-step writes the accumulators without reading them, so they hold
// no live values between products.
template <int DP, int KS>
__device__ __forceinline__ void issue_sdp(float (&s)[kNS], float (&dp)[kNS], uint32_t base, int st,
                                          int wg) {
  using L = Layout<DP>;
  auto q_desc = [&](uint32_t tile, int kk) {
    return hw::desc_sw128(base + tile + (kk / 4) * kQPanel + wg * 64 * 128 + (kk % 4) * 32, 16,
                          1024);
  };
  auto kv_desc = [&](uint32_t tile, int kk) {
    return hw::desc_sw128(base + tile + st * L::kKVBytes + (kk / 4) * kKVPanel + (kk % 4) * 32,
                          16, 1024);
  };
  auto product = [&](float (&acc)[kNS], uint32_t a, uint32_t b) {
    if constexpr (kBN == 128) {
      hw::wgmma_ss_m64n128_set(acc, q_desc(a, 0), kv_desc(b, 0));
#pragma unroll
      for (int kk = 1; kk < KS; ++kk)
        hw::wgmma_ss_m64n128(acc, q_desc(a, kk), kv_desc(b, kk), 1);
    } else {
      hw::wgmma_ss_m64n64_set(acc, q_desc(a, 0), kv_desc(b, 0));
#pragma unroll
      for (int kk = 1; kk < KS; ++kk)
        hw::wgmma_ss_m64n64(acc, q_desc(a, kk), kv_desc(b, kk), 1);
    }
  };
  product(s, L::kQ, L::kK);
  product(dp, L::kDO, L::kV);
}

// dQ += dS K against the K tile of stage st, K through a transposed
// descriptor (its 64-column panels LBO apart).
template <int DP>
__device__ __forceinline__ void issue_dq(float (&dq)[DP / 2], const uint32_t (&da)[kBN / 16][4],
                                         uint32_t base, int st) {
  using L = Layout<DP>;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    const uint64_t kd =
        hw::desc_sw128(base + L::kK + st * L::kKVBytes + kc * 16 * 128, kKVPanel, 1024);
    if constexpr (DP == 128)
      hw::wgmma_rs_m64n128_tb(dq, da[kc], kd);
    else
      hw::wgmma_rs_m64n64_tb(dq, da[kc], kd);
  }
}

// dS = P (dP - delta) scale with P = 2^(s * scale_log2 - lse_log2), for this
// thread's entries (rows `row` and row + 8 of the item, columns 8 n + 2 t +
// {0, 1} of the tile at col0), rounded to bf16 A fragments. On edge tiles
// (kEdge) masked entries are selected to 0; interior tiles get a copy with
// no test at all.
template <bool kEdge>
__device__ __forceinline__ void ds_tile(const float (&s)[kNS], const float (&dp)[kNS],
                                        uint32_t (&da)[kBN / 16][4], const float (&lse2)[2],
                                        const float (&dl)[2], const Args& p, int row, int col0,
                                        int t) {
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    float ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = 8 * kc + e;
      const int h = (x >> 1) & 1;
      float v = hw::exp2_approx(fmaf(s[x], p.scale_log2, -lse2[h]));
      if (kEdge && !visible<true>(row + 8 * h, col0 + 8 * (x >> 2) + 2 * t + (x & 1), p.Sq,
                                  p.Skv, p.causal, p.window))
        v = 0.f;
      ds[e] = v * (dp[x] - dl[h]) * p.scale;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) da[kc][r] = hw::cvt_bf16x2(ds[2 * r], ds[2 * r + 1]);
  }
}

// A consumer warpgroup: 64 rows of every item this CTA takes.
template <int DP, int KS>
__device__ __forceinline__ void consumer(const CUtensorMap* tdq, const Args& p, uint32_t base,
                                         int wg) {
  using L = Layout<DP>;
  constexpr int NO = DP / 2;  // dQ accumulator registers
  const uint32_t bar = base + L::kBar;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + (tid >> 5) * 16 + g;  // tile row of this thread's first rows
  auto turn = [&]() { hw::named_sync(kBarTurn + wg, 256); };
  auto pass = [&]() { hw::named_arrive(kBarTurn + 1 - wg, 256); };

  float s[kNS], dp[kNS];
  float dq[NO];
  uint32_t da[kBN / 16][4];
  if (wg == 1) hw::named_arrive(kBarTurn, 256);  // the first warpgroup issues first

  int k = 0, c = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int bh = u / p.units_per_slice;
    const int b = bh / p.Hkv, kvh = bh % p.Hkv;
    const int nm = unit_items(p, u);
    for (int m = 0; m < nm; ++m, ++k) {
      const int i = unit_row(p, u, m);
      const int q_tile = i % p.n_q;
      const int head = kvh * p.G + i / p.n_q;
      const int row0 = q_tile * kBM;
      const int row = row0 + wrow;  // this thread's first row; the second is row + 8
      int lo, hi;
      kv_range(p, q_tile, lo, hi);
      const int raw = hi - lo + 1;
      const int group = order_group(p.order, p.snake, raw);
      // Rows past Sq get lse = +inf (P = 0) and delta 0; they are masked too.
      float lse2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h < p.Sq) {
          const size_t at = (size_t)(b * p.Sq + row + 8 * h) * p.Hq + head;
          lse2[h] = p.lse[at] * 1.4426950408889634f;
          dl[h] = p.delta[at];
        }
      }
#pragma unroll
      for (int x = 0; x < NO; ++x) dq[x] = 0.f;

      hw::mbar_wait(q_full(bar), k & 1);
      if (raw <= 0 && lane == 0) hw::mbar_arrive(q_empty(bar));
      for (int j = 0; j < raw; ++j, ++c) {
        const int col0 = (lo + snake_pos(k, j, raw, group)) * kBN;
        const int st = c % kStages;
        hw::mbar_wait(kv_full(bar, st), (c / kStages) & 1);
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
        if (j == raw - 1 && lane == 0) hw::mbar_arrive(q_empty(bar));  // Q, dO read
        const bool edge = col0 + kBN > p.Skv || row0 + wg * 64 + 64 > p.Sq ||
                          (p.causal && col0 + kBN - 1 > row0 + wg * 64) ||
                          (p.window >= 0 && col0 <= row0 + wg * 64 + 63 - p.window);
        if (edge)
          ds_tile<true>(s, dp, da, lse2, dl, p, row, col0, t);
        else
          ds_tile<false>(s, dp, da, lse2, dl, p, row, col0, t);
        turn();
#pragma unroll
        for (int x = 0; x < NO; ++x) hw::fence_reg(dq[x]);
#pragma unroll
        for (int kc = 0; kc < kBN / 16; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r) hw::fence_reg(da[kc][r]);
        hw::wgmma_fence();
        issue_dq<DP>(dq, da, base, st);
        hw::wgmma_commit();
        pass();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NO; ++x) hw::fence_reg(dq[x]);
        if (lane == 0) hw::mbar_arrive(kv_empty(bar, st));
      }

      // Epilogue: dQ in bf16 into this warpgroup's shared buffer (the
      // 128-byte swizzle of the output's tensor map), stored by TMA, which
      // leaves out rows past Sq. The store runs on while the next item
      // starts; the buffer is rewritten only after it has been read.
      const uint32_t so = base + L::kO + wg * L::kOBytes;
      if (tid == 0) hw::bulk_wait_read<0>();
      hw::named_sync(kBarEpilogue + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow - wg * 64 + 8 * h;  // row of this warpgroup's 64
#pragma unroll
        for (int jn = 0; jn < DP / 8; ++jn)
          hw::st_shared_u32(
              so + (jn / 8) * 64 * 128 + r * 128 + (((jn % 8) ^ (r % 8)) * 16) + 4 * t,
              hw::cvt_bf16x2(dq[4 * jn + 2 * h], dq[4 * jn + 2 * h + 1]));
      }
      hw::fence_proxy_async();
      hw::named_sync(kBarEpilogue + wg, 128);
      if (tid == 0 && row0 + wg * 64 < p.Sq) {
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn)
          hw::tma_store_4d(tdq, so + pn * 64 * 128, pn * 64, head, row0 + wg * 64, b);
        hw::bulk_commit();
      }
    }
  }
  if (wg == 0) hw::named_sync(kBarTurn, 256);  // the second warpgroup's last pass
  if (tid == 0) hw::bulk_wait<0>();
}

template <int DP, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdq, const Args p) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  if (threadIdx.x == 0) {
    hw::mbar_init(q_full(bar), 1);                // the producer's expect_tx
    hw::mbar_init(q_empty(bar), kConsumerWarps);  // one arrival a consumer warp
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(kv_full(bar, st), 1);
      hw::mbar_init(kv_empty(bar, st), kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    hw::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) producer<DP>(&tq, &tdo, &tk, &tv, p, base);
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    consumer<DP, KS>(&tdq, p, base, wg);
  }
}

// The instantiation for padded head dim DP and KS k-steps over head dim D
// (the tensors' own, which the tensor maps take as their innermost extent).
template <int DP, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dO, void* dq,
                   const Args& a, int B, int D, cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!hw::tensor_map_bshd(&tq, q, B, a.Sq, a.Hq, D, kBM) ||
      !hw::tensor_map_bshd(&tdo, dO, B, a.Sq, a.Hq, D, kBM) ||
      !hw::tensor_map_bshd(&tk, k, B, a.Skv, a.Hkv, D, kBN) ||
      !hw::tensor_map_bshd(&tv, v, B, a.Skv, a.Hkv, D, kBN) ||
      !hw::tensor_map_bshd(&tdq, dq, B, a.Sq, a.Hq, D, 64))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err =
      hw::persistent_setup<flash_bwd_dq_kernel<DP, KS>>((int)L::kAlloc, &sms);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, KS><<<min(sms, a.n_units), kThreads, L::kAlloc, stream>>>
      (tq, tdo, tk, tv, tdq, a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim or
// a tensor map the driver refuses. `order`: 0 cyclic, 1 sawtooth, 2
// block_snake (reversal groups of `snake` tiles); `window` < 0 means none;
// `visit` may be null. No synchronisation: the kernel runs on `stream`.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dq, void* visit, int B,
                                 int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                                 int order, int snake, float scale, void* stream) {
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
  a.half = (a.n_q + 1) / 2;
  a.units_per_slice = a.G * a.half;
  a.n_units = B * Hkv * a.units_per_slice;
  a.causal = causal;
  a.window = window;
  a.order = order;
  a.snake = snake;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.n_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) return static_cast<int>(launch<128, 8>(q, k, v, dO, dq, a, B, D, st));
  if (D == 80) return static_cast<int>(launch<128, 5>(q, k, v, dO, dq, a, B, D, st));
  if (D == 96) return static_cast<int>(launch<128, 6>(q, k, v, dO, dq, a, B, D, st));
  if (D == 64) return static_cast<int>(launch<64, 4>(q, k, v, dO, dq, a, B, D, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation that serves head dim D: out[0] registers a thread (at
// launch, before setmaxnreg moves them), out[1] dynamic shared memory bytes,
// out[2] threads a CTA, out[3] local (spill) bytes a thread, out[4] Q rows
// of an item, out[5] KV positions of a tile. Returns a cudaError_t code.
extern "C" int flash_bwd_dq_attr(int D, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (D == 128 || D == 80 || D == 96) {
    err = cudaFuncGetAttributes(&fa, D == 128  ? flash_bwd_dq_kernel<128, 8>
                                     : D == 96 ? flash_bwd_dq_kernel<128, 6>
                                               : flash_bwd_dq_kernel<128, 5>);
    out[1] = (int)Layout<128>::kAlloc;
  } else if (D == 64) {
    err = cudaFuncGetAttributes(&fa, flash_bwd_dq_kernel<64, 4>);
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
