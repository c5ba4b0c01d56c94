// Persistent, warp-specialised flash attention forward for NVIDIA Hopper
// (sm_90a), CUDA C++ with raw PTX: TMA loads, wgmma products, mbarriers.
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
// visible column finalise to exact zeros with lse = the mask value.
//
// Work items and their order (the paper's persistent wavefront, Alg. 2/4).
// An item is one (slice bh = b * Hkv + kv head, folded row i), the folded
// row being GQA group i / n_q and Q tile i % n_q of 128 rows. Items are
// grouped into units of equal causal cost: unit p of GQA group grp pairs
// the heavy Q tile n_q - 1 - p with the light tile p (one item when they
// coincide), ceil(n_q / 2) units a group. Units are numbered slice-major
// (u = bh * G * ceil(n_q / 2) + grp * ceil(n_q / 2) + p), so the CTAs in
// flight at once share a few slices and their K/V stays in L2. The grid is
// one CTA per SM (at most one per unit); CTA w takes units w, w + grid,
// w + 2 grid, ..., each unit's heavy item first. The k-th item a CTA
// processes walks the KV tiles of its trimmed range [lo, hi]
// (Traversal.kv_bounds_host at 128 x 128 tiles) as
// Traversal.kv_order(q_tile, local_iter=k): the parity key is the
// worker-local pass counter. kernels/flash_attention.py::fwd_schedule is
// the host model of this order. With `visit_out` (B*Hkv, G*n_q, n_kv)
// int32, each item records the tile ids it walked (-1 past its range).
//
// Roles: three warpgroups a CTA. The last is the producer (one thread
// issues everything; setmaxnreg gives its registers away): per item it
// loads the Q tile (128 x D) by TMA once (as soon as the last S of the
// item before is done), then the K and V tiles (128 x D each) into rings
// of kStages stages with full/empty mbarriers, K_j ahead of V_{j-1}; K and
// V are released apart (K once S is done, V once P V is). The first two
// are consumers, 64 Q rows each: S = Q K^T as wgmma from shared memory
// (both operands K-major, 128-byte swizzle as TMA writes it), online
// softmax in f32 in registers (log2 domain), P rounded to bf16 and kept in
// registers as the A operand of O += P V, with V read through a transposed
// (MN-major) descriptor. A consumer issues S_j and P_{j-1} V_{j-1}
// together and runs the softmax of S_j while P_{j-1} V_{j-1} is on the
// tensor cores; named barriers alternate the two consumers' issues
// (ping-pong), so one's softmax overlaps the other's products. Only tiles
// that cross the causal diagonal, the window's edge or Skv are masked
// (masked entries -inf, so p = 0 exactly: a reversed causal pass can meet
// the diagonal first); m starts at the finite mask value. Tiles outside
// [lo, hi] are skipped: the GPU form of the TPU's clamped-index elision.
// The epilogue writes normalised O in bf16 into shared memory and stores
// it by TMA (rows past Sq and columns past D left out), which runs on
// while the next item starts; lse goes out by row.
//
// Head dims: 64 (one 128-byte panel a row) and 128 (two panels). D 80
// (zamba2's shared attention) and 96 (phi-3-vision's) run the D 128
// layout: the tensor maps' innermost extent is D, so TMA writes zeros into
// columns D-127; S takes only the D / 16 k-steps that hold data (5 and 6;
// each its own instantiation: the k-step count is a template parameter,
// since a wgmma issued under a runtime condition makes ptxas serialise
// every product), P V computes 128 columns of which the TMA store writes
// D. Its cost: 3/8 (D 80) and 1/4 (D 96) of the P V product is spent on
// zeros, and each tile takes the shared memory of D 128.
//
// What bounds it on this card: at the training shape (B 4, S 1024, 32
// heads of 128, causal) the causal flops (34.4 GFLOP) at the bf16 peak take
// 0.035 ms and the bytes of q, k, v, o 0.040 ms, so bytes by a little;
// K and V are re-read once per Q tile, from L2 where the slice-major order
// keeps them.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

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
constexpr uint32_t kQPanel = kBM * 128;   // bytes of one 64-column panel of a Q tile
constexpr uint32_t kKVPanel = kBN * 128;  // ... of a K or V tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of the instantiation for padded head dim DP, from a
// 1024-byte aligned base (the 128-byte swizzle's repeat).
template <int DP>
struct Layout {
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kQBytes = kBM * DP * 2;
  static constexpr uint32_t kKVBytes = kBN * DP * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kO = kV + kStages * kKVBytes;  // each consumer's 64 rows of O
  static constexpr uint32_t kOBytes = 64 * DP * 2;
  static constexpr uint32_t kBar = kO + kConsumers * kOBytes;
  // mbarriers: q_full, q_empty, then k_full, v_full, k_empty and v_empty of
  // each stage. K and V are released apart: K after S, V after P V.
  static constexpr uint32_t kBytes = kBar + 8 * (2 + 4 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;  // slack for aligning the base
};

__device__ __forceinline__ uint32_t q_full(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t q_empty(uint32_t bar) { return bar + 8; }
__device__ __forceinline__ uint32_t k_full(uint32_t bar, int st) { return bar + 16 + 8 * st; }
__device__ __forceinline__ uint32_t v_full(uint32_t bar, int st) {
  return bar + 16 + 8 * (kStages + st);
}
__device__ __forceinline__ uint32_t k_empty(uint32_t bar, int st) {
  return bar + 16 + 8 * (2 * kStages + st);
}
__device__ __forceinline__ uint32_t v_empty(uint32_t bar, int st) {
  return bar + 16 + 8 * (3 * kStages + st);
}

struct Args {
  float* lse;  // may be null
  int* visit;  // may be null
  int Sq, Skv, Hq, Hkv, D, G, n_q, n_kv;
  int half;             // ceil(n_q / 2): units per GQA group
  int units_per_slice;  // G * half
  int n_units;          // B * Hkv * units_per_slice
  int causal, window, order, snake;
  float scale_log2;  // scale * log2(e)
};

// The folded rows of unit u, heavy first; returns how many (1 or 2).
__device__ __forceinline__ int unit_rows(const Args& p, int u, int* rows) {
  const int r = u % p.units_per_slice;
  const int grp = r / p.half, pair = r % p.half;
  const int heavy = p.n_q - 1 - pair;
  rows[0] = grp * p.n_q + heavy;
  rows[1] = grp * p.n_q + pair;
  return heavy == pair ? 1 : 2;
}

// Inclusive [lo, hi] KV tiles seen by Q tile `q_tile` (Traversal.kv_bounds_host
// at kBM x kBN tiles); hi < lo when a window leaves nothing.
__device__ __forceinline__ void kv_range(const Args& p, int q_tile, int& lo, int& hi) {
  const int row0 = q_tile * kBM;
  hi = p.causal ? min(p.n_kv - 1, (row0 + kBM - 1) / kBN) : p.n_kv - 1;
  lo = p.window >= 0 ? max(row0 - (p.window - 1), 0) / kBN : 0;
}

template <int DP>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Args& p, uint32_t base) {
  using L = Layout<DP>;
  const uint32_t bar = base + L::kBar;
  hw::tma_prefetch_desc(tq);
  hw::tma_prefetch_desc(tk);
  hw::tma_prefetch_desc(tv);
  int k = 0, c = 0;  // items and KV tiles this CTA has issued
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int bh = u / p.units_per_slice;
    const int b = bh / p.Hkv, kvh = bh % p.Hkv;
    int rows[2];
    const int nm = unit_rows(p, u, rows);
    for (int m = 0; m < nm; ++m, ++k) {
      const int i = rows[m];
      const int q_tile = i % p.n_q;
      const int head = kvh * p.G + i / p.n_q;
      hw::mbar_wait(q_empty(bar), (k & 1) ^ 1);
      hw::mbar_expect_tx(q_full(bar), L::kQBytes);
#pragma unroll
      for (int pn = 0; pn < L::kPanels; ++pn)
        hw::tma_load_4d(base + L::kQ + pn * kQPanel, tq, q_full(bar), pn * 64, head,
                        q_tile * kBM, b);
      int lo, hi;
      kv_range(p, q_tile, lo, hi);
      const int raw = hi - lo + 1;
      const int group = order_group(p.order, p.snake, raw);
      int* vrow = p.visit == nullptr
                      ? nullptr
                      : p.visit + ((size_t)bh * p.G * p.n_q + i) * p.n_kv;
      // K_0, then K_j ahead of V_{j-1}, then the last V: each K as early
      // as its stage frees.
      int prev_tile = 0;
      for (int j = 0; j <= raw; ++j) {
        if (j < raw) {
          const int tile = lo + snake_pos(k, j, raw, group);
          const int st = (c + j) % kStages;
          hw::mbar_wait(k_empty(bar, st), (((c + j) / kStages) & 1) ^ 1);
          hw::mbar_expect_tx(k_full(bar, st), L::kKVBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn)
            hw::tma_load_4d(base + L::kK + st * L::kKVBytes + pn * kKVPanel, tk, k_full(bar, st),
                            pn * 64, kvh, tile * kBN, b);
          if (vrow != nullptr) vrow[j] = tile;
          if (j > 0) {
            const int pst = (c + j - 1) % kStages;
            hw::mbar_wait(v_empty(bar, pst), (((c + j - 1) / kStages) & 1) ^ 1);
            hw::mbar_expect_tx(v_full(bar, pst), L::kKVBytes);
#pragma unroll
            for (int pn = 0; pn < L::kPanels; ++pn)
              hw::tma_load_4d(base + L::kV + pst * L::kKVBytes + pn * kKVPanel, tv,
                              v_full(bar, pst), pn * 64, kvh, prev_tile * kBN, b);
          }
          prev_tile = tile;
        } else if (raw > 0) {
          const int pst = (c + j - 1) % kStages;
          hw::mbar_wait(v_empty(bar, pst), (((c + j - 1) / kStages) & 1) ^ 1);
          hw::mbar_expect_tx(v_full(bar, pst), L::kKVBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn)
            hw::tma_load_4d(base + L::kV + pst * L::kKVBytes + pn * kKVPanel, tv, v_full(bar, pst),
                            pn * 64, kvh, prev_tile * kBN, b);
        }
      }
      c += max(raw, 0);
      if (vrow != nullptr)
        for (int j = max(raw, 0); j < p.n_kv; ++j) vrow[j] = -1;
    }
  }
}

// Named barriers: 1 and 2 order the two consumer warpgroups' product
// issues (ping-pong: while one issues its products the other runs its
// softmax); 3 and 4 are each consumer's own, around its epilogue.
constexpr int kBarTurn = 1, kBarEpilogue = 3;

// S = Q K^T for this warpgroup's 64 rows against the K tile of stage st, in
// KS k-steps of 16 columns (the ones that hold data).
template <int DP, int KS>
__device__ __forceinline__ void issue_s(float (&s)[kBN / 2], uint32_t base, int st, int wg) {
  using L = Layout<DP>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t qa = base + L::kQ + (kk / 4) * kQPanel + wg * 64 * 128 + (kk % 4) * 32;
    const uint32_t ka = base + L::kK + st * L::kKVBytes + (kk / 4) * kKVPanel + (kk % 4) * 32;
    hw::wgmma_ss_m64n128(s, hw::desc_sw128(qa, 16, 1024), hw::desc_sw128(ka, 16, 1024), kk > 0);
  }
}

// O += P V against the V tile of stage st, V through a transposed
// descriptor (its 64-column panels LBO apart).
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t base, int st) {
  using L = Layout<DP>;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    const uint64_t vd =
        hw::desc_sw128(base + L::kV + st * L::kKVBytes + kc * 16 * 128, kKVPanel, 1024);
    if constexpr (DP == 128)
      hw::wgmma_rs_m64n128_tb(o, pa[kc], vd);
    else
      hw::wgmma_rs_m64n64_tb(o, pa[kc], vd);
  }
}

// Online softmax of one S tile in place (p = 2^(s * scale_log2 - m), 0 where
// masked), rows g and g + 8 of this warp's 16; returns the factors alpha
// by which O must be rescaled. Only tiles that cross the diagonal, the
// window's edge or Skv are masked.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&mrow)[2], float (&l)[2],
                                             float (&alpha)[2], const Args& p, int row0, int wrow,
                                             int t, int tile) {
  constexpr int NS = kBN / 2;
  const int col0 = tile * kBN;
  const bool edge = col0 + kBN > p.Skv || (p.causal && col0 + kBN - 1 > row0) ||
                    (p.window >= 0 && col0 <= row0 + kBM - 1 - p.window);
  if (edge) {
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      const int row = row0 + wrow + 8 * ((x >> 1) & 1);
      const int col = col0 + 8 * (x >> 2) + 2 * t + (x & 1);
      if (!visible<false>(row, col, p.Sq, p.Skv, p.causal, p.window)) s[x] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < NS; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(mrow[h], mx[h] * p.scale_log2);  // finite
    alpha[h] = hw::exp2_approx(mrow[h] - m_new);
    mrow[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int x = 0; x < NS; ++x) {
    const int h = (x >> 1) & 1;
    s[x] = hw::exp2_approx(fmaf(s[x], p.scale_log2, -mrow[h]));
    l[h] += s[x];
  }
}

// O *= alpha, then P (bf16 A fragments of O += P V) from the softmax'd S.
template <int NO>
__device__ __forceinline__ void rescale_pack(float (&o)[NO], uint32_t (&pa)[kBN / 16][4],
                                             const float (&s)[kBN / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    pa[kc][0] = hw::cvt_bf16x2(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = hw::cvt_bf16x2(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = hw::cvt_bf16x2(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = hw::cvt_bf16x2(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// A consumer warpgroup: 64 rows of every item this CTA takes. Within an
// item, the products of tile j (S_j, then P_{j-1} V_{j-1}) are issued
// together; the softmax of S_j runs while P_{j-1} V_{j-1} is on the tensor
// cores.
template <int DP, int KS>
__device__ __forceinline__ void consumer(const CUtensorMap* to, const Args& p, uint32_t base,
                                         int wg) {
  using L = Layout<DP>;
  constexpr int NS = kBN / 2;  // S accumulator registers (64 x kBN over 128 threads)
  constexpr int NO = DP / 2;   // O accumulator registers
  const uint32_t bar = base + L::kBar;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + (tid >> 5) * 16 + g;  // tile row of this thread's first rows
  auto turn = [&]() { hw::named_sync(kBarTurn + wg, 256); };
  auto pass = [&]() { hw::named_arrive(kBarTurn + 1 - wg, 256); };

  float s[NS];
  float o[NO];
  uint32_t pa[kBN / 16][4];
  // Pins the register operands of the products before wgmma_fence.
  auto pin = [&]() {
#pragma unroll
    for (int x = 0; x < NS; ++x) hw::fence_reg(s[x]);
#pragma unroll
    for (int x = 0; x < NO; ++x) hw::fence_reg(o[x]);
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) hw::fence_reg(pa[kc][r]);
  };
#pragma unroll
  for (int x = 0; x < NS; ++x) s[x] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) pa[kc][0] = pa[kc][1] = pa[kc][2] = pa[kc][3] = 0u;
  if (wg == 1) hw::named_arrive(kBarTurn, 256);  // the first warpgroup issues first

  int k = 0, c = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int bh = u / p.units_per_slice;
    const int b = bh / p.Hkv, kvh = bh % p.Hkv;
    int rows[2];
    const int nm = unit_rows(p, u, rows);
    for (int m = 0; m < nm; ++m, ++k) {
      const int i = rows[m];
      const int q_tile = i % p.n_q;
      const int head = kvh * p.G + i / p.n_q;
      const int row0 = q_tile * kBM;
      int lo, hi;
      kv_range(p, q_tile, lo, hi);
      const int raw = hi - lo + 1;
      const int group = order_group(p.order, p.snake, raw);
#pragma unroll
      for (int x = 0; x < NO; ++x) o[x] = 0.f;
      float mrow[2] = {kMaskValue, kMaskValue};  // running max, log2 domain
      float l[2] = {0.f, 0.f};                   // this thread's partial row sums
      float alpha[2];

      hw::mbar_wait(q_full(bar), k & 1);
      if (raw <= 0) {
        if (lane == 0) hw::mbar_arrive(q_empty(bar));
      } else {
        int tile = lo + snake_pos(k, 0, raw, group);
        int st = c % kStages;
        uint32_t ph = (c / kStages) & 1;
        hw::mbar_wait(k_full(bar, st), ph);
        turn();
        pin();
        hw::wgmma_fence();
        issue_s<DP, KS>(s, base, st, wg);
        hw::wgmma_commit();
        pass();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NS; ++x) hw::fence_reg(s[x]);
        if (lane == 0) {
          hw::mbar_arrive(k_empty(bar, st));
          if (raw == 1) hw::mbar_arrive(q_empty(bar));
        }
        softmax_tile(s, mrow, l, alpha, p, row0, wrow, t, tile);
        rescale_pack(o, pa, s, alpha);
        for (int j = 1; j < raw; ++j) {
          const int pst = st;
          const uint32_t pph = ph;
          ++c;
          tile = lo + snake_pos(k, j, raw, group);
          st = c % kStages;
          ph = (c / kStages) & 1;
          hw::mbar_wait(k_full(bar, st), ph);
          hw::mbar_wait(v_full(bar, pst), pph);
          turn();
          pin();
          hw::wgmma_fence();
          issue_s<DP, KS>(s, base, st, wg);
          hw::wgmma_commit();
          issue_pv<DP>(o, pa, base, pst);
          hw::wgmma_commit();
          pass();
          hw::wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
#pragma unroll
          for (int x = 0; x < NS; ++x) hw::fence_reg(s[x]);
          if (lane == 0) {
            hw::mbar_arrive(k_empty(bar, st));
            if (j == raw - 1) hw::mbar_arrive(q_empty(bar));
          }
          softmax_tile(s, mrow, l, alpha, p, row0, wrow, t, tile);
          hw::wgmma_wait<0>();
#pragma unroll
          for (int x = 0; x < NO; ++x) hw::fence_reg(o[x]);
          if (lane == 0) hw::mbar_arrive(v_empty(bar, pst));
          rescale_pack(o, pa, s, alpha);
        }
        hw::mbar_wait(v_full(bar, st), ph);
        pin();
        hw::wgmma_fence();
        issue_pv<DP>(o, pa, base, st);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NO; ++x) hw::fence_reg(o[x]);
        if (lane == 0) hw::mbar_arrive(v_empty(bar, st));
        ++c;
      }

      // Epilogue: full row sums across the quad; lse by row; normalised O
      // in bf16 into this warpgroup's shared buffer (the 128-byte swizzle
      // of the output's tensor map), stored by TMA, which leaves out rows
      // past Sq and columns past D. The store runs on while the next item
      // starts; the buffer is rewritten only after it has been read.
      const uint32_t so = base + L::kO + wg * L::kOBytes;
      if (tid == 0) hw::bulk_wait_read<0>();
      hw::named_sync(kBarEpilogue + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const bool seen = l[h] > 0.f;
        const float inv = seen ? 1.f / l[h] : 1.f;
        const int r = wrow - wg * 64 + 8 * h;  // row of this warpgroup's 64
#pragma unroll
        for (int jn = 0; jn < DP / 8; ++jn)
          hw::st_shared_u32(
              so + (jn / 8) * 64 * 128 + r * 128 + (((jn % 8) ^ (r % 8)) * 16) + 4 * t,
              hw::cvt_bf16x2(o[4 * jn + 2 * h] * inv, o[4 * jn + 2 * h + 1] * inv));
        const int row = row0 + wrow + 8 * h;
        if (p.lse != nullptr && t == 0 && row < p.Sq)
          p.lse[(size_t)(b * p.Sq + row) * p.Hq + head] =
              seen ? mrow[h] * 0.69314718055994531f + logf(l[h]) : kMaskValue;
      }
      hw::fence_proxy_async();
      hw::named_sync(kBarEpilogue + wg, 128);
      if (tid == 0 && row0 + wg * 64 < p.Sq) {
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn)
          hw::tma_store_4d(to, so + pn * 64 * 128, pn * 64, head, row0 + wg * 64, b);
        hw::bulk_commit();
      }
    }
  }
  if (wg == 0) hw::named_sync(kBarTurn, 256);  // the second warpgroup's last pass
  if (tid == 0) hw::bulk_wait<0>();
}

template <int DP, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const Args p) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  if (threadIdx.x == 0) {
    hw::mbar_init(q_full(bar), 1);                // the producer's expect_tx
    hw::mbar_init(q_empty(bar), kConsumerWarps);  // one arrival a consumer warp
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(k_full(bar, st), 1);
      hw::mbar_init(v_full(bar, st), 1);
      hw::mbar_init(k_empty(bar, st), kConsumerWarps);
      hw::mbar_init(v_empty(bar, st), kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    hw::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) producer<DP>(&tq, &tk, &tv, p, base);
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    consumer<DP, KS>(&to, p, base, wg);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, H, D) bf16 tensor as a 4-D map (innermost first), read in boxes
// of 64 columns x 1 head x `rows` positions with the 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Args& a, int B,
                   cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, B, a.Sq, a.Hq, a.D, kBM) ||
      !tensor_map(&tk, k, B, a.Skv, a.Hkv, a.D, kBN) ||
      !tensor_map(&tv, v, B, a.Skv, a.Hkv, a.D, kBN) ||
      !tensor_map(&to, o, B, a.Sq, a.Hq, a.D, 64))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<DP, KS>;
  // The shared-memory opt-in and the SM count, once per device.
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (sms_of[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kAlloc);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms_of[dev] = sms;
  }
  const int grid = min(sms_of[dev], a.n_units);
  kernel<<<grid, kThreads, L::kAlloc, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for an unsupported head dim or
// a tensor map the driver refuses. `order`: 0 cyclic, 1 sawtooth, 2
// block_snake (reversal groups of `snake` tiles); `window` < 0 means none.
// `lse` and `visit` may be null. No synchronisation: the kernel runs on
// `stream`.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              void* visit, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                              int causal, int window, int order, int snake, float scale,
                              void* stream) {
  Args a;
  a.lse = static_cast<float*>(lse);
  a.visit = static_cast<int*>(visit);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
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
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.n_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) return static_cast<int>(launch<128, 8>(q, k, v, o, a, B, st));
  if (D == 80) return static_cast<int>(launch<128, 5>(q, k, v, o, a, B, st));
  if (D == 96) return static_cast<int>(launch<128, 6>(q, k, v, o, a, B, st));
  if (D == 64) return static_cast<int>(launch<64, 4>(q, k, v, o, a, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation that serves head dim D: out[0] registers a thread (at
// launch, before setmaxnreg moves them), out[1] dynamic shared memory bytes,
// out[2] threads a CTA, out[3] local (spill) bytes a thread. Returns a
// cudaError_t code.
extern "C" int flash_fwd_attr(int D, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (D == 128 || D == 80 || D == 96) {
    err = cudaFuncGetAttributes(&fa, D == 128  ? flash_fwd_kernel<128, 8>
                                     : D == 96 ? flash_fwd_kernel<128, 6>
                                               : flash_fwd_kernel<128, 5>);
    out[1] = (int)Layout<128>::kAlloc;
  } else if (D == 64) {
    err = cudaFuncGetAttributes(&fa, flash_fwd_kernel<64, 4>);
    out[1] = (int)Layout<64>::kAlloc;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[2] = kThreads;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}
