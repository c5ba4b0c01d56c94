// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a), CUDA C++
// with raw PTX: TMA loads and stores, cp.async, mbarriers, wgmma.
//
// Replaces repro/kernels/ssd.py::_ssd_kernel (called from ssd_fwd at
// ssd.py:155), the Pallas kernel of every Mamba layer of LM.prefill and
// LM.loss for the SSM (mamba2-130m) and hybrid (zamba2-2.7b) families.
//
// What it computes, for x (B, S, H, P) bf16, dt (B, S, H) f32 (post
// softplus), a (H,) f32 (<= 0), b, c (B, S, N) bf16 shared by all heads
// (Mamba-2's G = 1) and an initial state (B, H, P, N) f32 (or a null
// pointer for zeros, as ops.ssd passes it on the serve path), chunk
// by chunk of L = 128 positions:
//   cum   = cumsum(dt * a) within the chunk (inclusive; <= 0, decreasing)
//   W_ij  = (c_i . b_j) * exp(cum_i - cum_j) * dt_j  for j <= i, else 0
//   y_i   = sum_j W_ij x_j + exp(cum_i) * (S c_i)
//   S    <- exp(cum_last) * S + sum_j dt_j * exp(cum_last - cum_j) * x_j b_j^T
// then y (B, S, H, P) bf16 and the final state (B, H, P, N) f32. exp is only
// ever taken of cum_i - cum_j with j <= i and of cum itself, all <= 0: never
// exp(cum_i) * exp(-cum_j), whose second factor overflows float32 once cum
// passes about -88 (A down to -16 reaches -100 inside one chunk). exp(cum)
// may underflow to 0 on the inter-chunk term, which is exact enough. The
// sums are kept in the log2 domain (cum * log2 e) for ex2.
//
// Within a chunk the SSD is the flash forward's loop with a decay mask in
// place of the softmax: C B^T is S = Q K^T, W = f(C B^T) is P, W X is P V.
// So the operands take B2's layouts: TMA writes x, b and c with the
// 128-byte swizzle that wgmma reads (c as the K-major A operand, b as the
// K-major B operand of C B^T and the MN-major B operand of the state
// update, x as the MN-major B operand of W X; rows of N bf16 in 64-column
// panels).
//
// Every product runs on the tensor cores (wgmma, bf16 in, f32 accumulate)
// at float32 accuracy. C B^T takes bf16 inputs, exact. The float32 operands
// W, S and the scaled x (dt_j exp(cum_last - cum_j) x_j) are each split into
// hi = bf16(v) and lo = bf16(v - hi), two products where there was one,
// which keeps about 16 bits of each (bf16 alone misses the 1e-4 state limit
// by 14-30x; tests/test_torch_ssd_split.py models both):
//   W X       W built in registers from the C B^T accumulator, its hi and
//             lo as register-A fragments against X;
//   C S^T     S's hi and lo in shared memory (K-major, swizzled), the
//             result scaled by exp(cum_i) row by row in the accumulator
//             before W X adds into it;
//   S update  the scaled x's transpose read by ldmatrix.trans from the x
//             tile into register-A fragments (hi, lo) against b (MN-major);
//             the state stays in f32 accumulator registers across the
//             chunks of an item (on chip, as the TPU keeps it in VMEM).
// No wgmma is issued under a runtime condition (ptxas would serialise all
// of them, C7515): the warpgroups' differing work is a template parameter.
//
// Work items and their order. An item is one (batch row, head), u = b * H +
// h: its chunks carry the state in order, so the item is the unit of
// parallelism. The grid is persistent, min(SMs, B * H) CTAs (one an SM:
// the ring and the state take 213 KB at N 128); CTA w takes items w, w +
// grid, ... Consecutive items are the heads of one batch row, so the CTAs
// in flight at once share b and c, which come from L2 after the first
// fetch: the counterpart of the TPU kernel's elided B/C fetch. Both grids
// run the same rounds; against one CTA an item the loop starts each later
// item warm (its first chunk loads while the item before computes), 9%
// faster at zamba2-2.7b's prefill group (640 items) on an H100.
// kernels/ssd.py::ssd_walks is the host model of the order; with `visit`
// (grid, ceil(items / grid)) int32 each CTA records the items it took (-1
// past its last).
//
// Roles: four warpgroups. The last is the producer (one warp; setmaxnreg
// gives the others' registers away): per chunk, into a ring of two stages
// with full/empty mbarriers, x (128 x 64), b and c (128 x N) by TMA, which
// zero-fills the positions past S of the ragged last chunk (no padded
// copy), and dt (4 bytes at a stride of H, under TMA's 16-byte box) by
// cp.async, zeros past S (so no update and no decay there). Once dt lands
// the producer warp scans it (cum, exp(cum), dt_j exp(cum_last - cum_j))
// into the stage. The first two are row warpgroups of 64 chunk rows each:
// C B^T (wg 0 only its 64 columns j <= i), then C S^T behind it, W built
// while C S^T runs, W X, and y in bf16 through shared memory and a TMA
// store (rows past S left out). The third carries the state: per chunk it
// publishes S (hi, lo) into shared memory, then runs the state update;
// two named barriers hand S to the row warpgroups and back (S_READY once
// published, S_FREE once both have read it). So the chain that carries the
// state from chunk to chunk holds only the update and the publish; the
// row warpgroups' work of one chunk runs beside the state's of the next.
// The update runs in two halves of 64 positions, each waited before the
// next half's fragments are built, which keeps the state warpgroup within
// its registers. (In development, the update on row warpgroup 0, and the
// update issued whole, which spilled at N 128, both ran slower.)
//
// What bounds it on this card: bytes. x, dt, b and c read once, y and the
// final state written once (a zero initial state is a null pointer and is
// not read) come to 44 MB at mamba2-130m's prefill group (8, 700, 24
// heads, N 128), 13 us at 3.35 TB/s, and 128 MB at zamba2-2.7b's (80
// heads, N 64), 38 us; their 5.6 and 10.9 GFLOP (twice that with the split
// products) take 6 and 11 us at the dense bf16 peak (989 TFLOP/s). Each
// chunk's state update waits for the previous one, so an item's chunks run
// in order; at mamba2's 192 items on 132 SMs the last 60 run a second
// round (one item is 64 state rows, wgmma's least M, so it cannot be cut
// smaller without splitting the state).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;
namespace hw = repro::sm90;

constexpr int kL = 128;  // positions per chunk
constexpr int kP = 64;   // head dim P
constexpr int kStages = 2;
constexpr int kRowWgs = 2;                // warpgroups 0, 1: 64 chunk rows each
constexpr int kStateWg = 2, kProducerWg = 3;
constexpr int kThreads = 128 * 4;
constexpr int kConsumerWarps = 4 * 3;     // the stage's readers: row and state warpgroups
constexpr int kSyncThreads = 128 * 3;     // the S hand-off's barriers: the same three
// setmaxnreg: 128 a thread at launch; the sum over the four warpgroups stays 4 x 128.
constexpr int kProducerRegs = 32, kStateRegs = 168, kRow0Regs = 128, kRow1Regs = 184;
static_assert(kProducerRegs + kStateRegs + kRow0Regs + kRow1Regs == 4 * 128, "register budget");
constexpr uint32_t kTilePanel = kL * 128;  // one 64-column panel of a 128-row tile
constexpr uint32_t kStatePanel = kP * 128;  // ... of the 64-row state
constexpr uint32_t kVecBytes = 4 * kL * 4;  // dt, cum, exp(cum), scale of a stage
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory for state dim N, from a 1024-byte aligned base (the
// 128-byte swizzle's repeat).
template <int N>
struct Layout {
  static constexpr int kPanels = N / 64;
  static constexpr uint32_t kXBytes = kTilePanel;
  static constexpr uint32_t kBCBytes = kPanels * kTilePanel;
  static constexpr uint32_t kStageBytes = kXBytes + 2 * kBCBytes;
  static constexpr uint32_t kSBytes = kPanels * kStatePanel;  // one of hi, lo
  static constexpr uint32_t kS = kStages * kStageBytes;       // S hi, then S lo
  static constexpr uint32_t kY = kS + 2 * kSBytes;            // each consumer's 64 rows of y
  static constexpr uint32_t kYBytes = 64 * 128;
  static constexpr uint32_t kVec = kY + kRowWgs * kYBytes;
  static constexpr uint32_t kBar = kVec + kStages * kVecBytes;
  static constexpr uint32_t kBytes = kBar + 8 * 2 * kStages;  // full, empty of each stage
  static constexpr uint32_t kAlloc = kBytes + 1024;  // slack for aligning the base
  static_assert(kAlloc <= 232448, "over the 227 KB a block can use");

  __device__ static uint32_t x(int st) { return st * kStageBytes; }
  __device__ static uint32_t b(int st) { return st * kStageBytes + kXBytes; }
  __device__ static uint32_t c(int st) { return st * kStageBytes + kXBytes + kBCBytes; }
};

// The four vectors of a stage: dt, cum (log2 domain), exp(cum), and the
// state update's scale dt_j exp(cum_last - cum_j).
enum Vec { kDt = 0, kCum = 1, kECum = 2, kScale = 3 };

__device__ __forceinline__ uint32_t full_bar(uint32_t bar, int st) { return bar + 8 * st; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bar, int st) {
  return bar + 8 * (kStages + st);
}

struct Args {
  const float* dt;     // (B, S, H)
  const float* a;      // (H,)
  const float* init;   // (B, H, P, N), or null for zeros
  float* final_state;  // (B, H, P, N)
  int* visit;          // (grid, max_k), or null
  int S, H, n_items, n_chunks, max_k;
};

// Named barriers: S published by the state warpgroup (the row warpgroups
// wait), S free again (both row warpgroups have read it; the state
// warpgroup waits before the next publish), and each row warpgroup's
// around its epilogue.
constexpr int kBarSReady = 1, kBarSFree = 2, kBarEpilogue = 3;

// Four 8 x 8 bf16 matrices from shared memory, each transposed: lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// v as hi = bf16(v) and lo = bf16(v - hi), two values a register each.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = hw::cvt_bf16x2(v0, v1);
  lo = hw::cvt_bf16x2(v0 - bf16_lo(hi), v1 - bf16_hi(hi));
}

template <int N>
__device__ __forceinline__ void producer(const CUtensorMap* tx, const CUtensorMap* tb,
                                         const CUtensorMap* tc, const Args& p, uint32_t base,
                                         float* gvec) {
  using Lt = Layout<N>;
  const uint32_t bar = base + Lt::kBar;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hw::tma_prefetch_desc(tx);
    hw::tma_prefetch_desc(tb);
    hw::tma_prefetch_desc(tc);
  }
  int c = 0, k = 0;  // chunks and items this CTA has issued
  for (int u = blockIdx.x; u < p.n_items; u += gridDim.x, ++k) {
    const int b = u / p.H, h = u % p.H;
    const float a2 = p.a[h] * kLog2e;
    if (lane == 0 && p.visit != nullptr) p.visit[(size_t)blockIdx.x * p.max_k + k] = u;
    for (int z = 0; z < p.n_chunks; ++z, ++c) {
      const int st = c % kStages;
      const int s0 = z * kL;
      hw::mbar_wait(empty_bar(bar, st), ((c / kStages) & 1) ^ 1);
      if (lane == 0) {
        hw::mbar_expect_tx(full_bar(bar, st), Lt::kXBytes + 2 * Lt::kBCBytes);
        hw::tma_load_4d(base + Lt::x(st), tx, full_bar(bar, st), 0, h, s0, b);
#pragma unroll
        for (int pn = 0; pn < Lt::kPanels; ++pn) {
          hw::tma_load_4d(base + Lt::b(st) + pn * kTilePanel, tb, full_bar(bar, st), pn * 64, 0,
                          s0, b);
          hw::tma_load_4d(base + Lt::c(st) + pn * kTilePanel, tc, full_bar(bar, st), pn * 64, 0,
                          s0, b);
        }
      }
      // dt of positions 4 lane .. 4 lane + 3; zeros past S.
      float* vec = gvec + st * 4 * kL;
      const uint32_t dts = base + Lt::kVec + st * kVecBytes;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const bool in = s0 + j < p.S;
        const size_t at = in ? ((size_t)b * p.S + s0 + j) * p.H + h : 0;
        hw::cp_async_4(dts + 4 * j, p.dt + at, in);
      }
      hw::cp_async_commit();
      hw::cp_async_wait<0>();
      __syncwarp();
      // cum = inclusive cumsum of dt * a (log2 domain): 4 positions a lane,
      // then a warp scan.
      float d[4], v[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = vec[kDt * kL + 4 * lane + e];
        run += d[e] * a2;
        v[e] = run;
      }
      float inc = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      const float off = inc - run;
      const float last = __shfl_sync(0xffffffffu, off + v[3], 31);  // cum at position 127
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float cum = off + v[e];
        vec[kCum * kL + j] = cum;
        vec[kECum * kL + j] = hw::exp2_approx(cum);
        vec[kScale * kL + j] = d[e] * hw::exp2_approx(last - cum);
      }
      hw::mbar_arrive(full_bar(bar, st));  // each lane: its copies and its scan
    }
  }
  if (lane == 0 && p.visit != nullptr)
    for (; k < p.max_k; ++k) p.visit[(size_t)blockIdx.x * p.max_k + k] = -1;
}

// y = C S^T for warpgroup WG's 64 rows against the published state, S as
// hi then lo (K-major, 64 rows p); the first k-step overwrites y.
template <int N, int WG>
__device__ __forceinline__ void issue_cs(float (&y)[kP / 2], uint32_t base, int st) {
  using Lt = Layout<N>;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t ca =
          base + Lt::c(st) + (kk / 4) * kTilePanel + WG * 64 * 128 + (kk % 4) * 32;
      const uint32_t sa =
          base + Lt::kS + half * Lt::kSBytes + (kk / 4) * kStatePanel + (kk % 4) * 32;
      hw::wgmma_ss_m64n64(y, hw::desc_sw128(ca, 16, 1024), hw::desc_sw128(sa, 16, 1024),
                          half > 0 || kk > 0);
    }
}

// The scaled x's transpose as A fragments of the state update: ldmatrix.trans
// of the x tile (rows j, columns p) gives lane (g, t) x[j = 2t, 2t + 1][p =
// g] of each 8 x 8 block, scaled by dt_j exp(cum_last - cum_j) and split.
__device__ __forceinline__ void scaled_x_frags(uint32_t (&xh)[kL / 32][4],
                                               uint32_t (&xl)[kL / 32][4], uint32_t xtile,
                                               const float* scale, int warp, int lane, int hf) {
  const int t = lane & 3, m = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kq = 0; kq < kL / 32; ++kq) {
    const int kc = hf * (kL / 32) + kq;
    const int j = 16 * kc + 8 * (m >> 1) + rr;
    const int ch = 2 * warp + (m & 1);
    uint32_t raw[4];
    ldsm_x4_trans(xtile + j * 128 + ((ch ^ (j & 7)) << 4), raw);
    const float2 sa = *reinterpret_cast<const float2*>(scale + 16 * kc + 2 * t);
    const float2 sb = *reinterpret_cast<const float2*>(scale + 16 * kc + 8 + 2 * t);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 sc = r < 2 ? sa : sb;
      split2(bf16_lo(raw[r]) * sc.x, bf16_hi(raw[r]) * sc.y, xh[kq][r], xl[kq][r]);
    }
  }
}

// The state warpgroup: the state S (64 rows p x N) of every item this CTA
// takes, in f32 accumulator registers. Per chunk it publishes S (hi, lo) in
// the 128-byte swizzle of a K-major operand once both row warpgroups have
// read the last one, then runs S <- exp(cum_last) S + (x scaled)^T B in two
// halves of 64 positions.
template <int N>
__device__ __forceinline__ void state_wg(const Args& p, uint32_t base, const float* gvec) {
  using Lt = Layout<N>;
  const uint32_t bar = base + Lt::kBar;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's first state row (then r0 + 8)
  float S[N / 2];
  uint32_t xh[kL / 32][4], xl[kL / 32][4];
  int c = 0;
  for (int u = blockIdx.x; u < p.n_items; u += gridDim.x) {
    const size_t state_off = (size_t)u * kP * N;
    // The initial state into the accumulator layout: row p = r0 (+ 8),
    // columns 8 nt + 2 t (+ 1).
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 v = make_float2(0.f, 0.f);
        if (p.init != nullptr)
          v = *reinterpret_cast<const float2*>(p.init + state_off + (size_t)(r0 + 8 * hh) * N +
                                               8 * nt + 2 * t);
        S[4 * nt + 2 * hh] = v.x;
        S[4 * nt + 2 * hh + 1] = v.y;
      }
    for (int z = 0; z < p.n_chunks; ++z, ++c) {
      const int st = c % kStages;
      const float* vec = gvec + st * 4 * kL;
      hw::named_sync(kBarSFree, kSyncThreads);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh;
          uint32_t hi, lo;
          split2(S[4 * nt + 2 * hh], S[4 * nt + 2 * hh + 1], hi, lo);
          const uint32_t at =
              (nt / 8) * kStatePanel + r * 128 + (((nt % 8) ^ (r % 8)) * 16) + 4 * t;
          hw::st_shared_u32(base + Lt::kS + at, hi);
          hw::st_shared_u32(base + Lt::kS + Lt::kSBytes + at, lo);
        }
      hw::fence_proxy_async();
      hw::named_arrive(kBarSReady, kSyncThreads);

      hw::mbar_wait(full_bar(bar, st), (c / kStages) & 1);
      const float decay = vec[kECum * kL + kL - 1];
#pragma unroll
      for (int x = 0; x < N / 2; ++x) S[x] *= decay;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        scaled_x_frags(xh, xl, base + Lt::x(st), vec + kScale * kL, warp, lane, hf);
#pragma unroll
        for (int x = 0; x < N / 2; ++x) hw::fence_reg(S[x]);
#pragma unroll
        for (int kc = 0; kc < kL / 32; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hw::fence_reg(xh[kc][r]);
            hw::fence_reg(xl[kc][r]);
          }
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kL / 32; ++kc) {
          const uint64_t bd = hw::desc_sw128(base + Lt::b(st) + (hf * kL / 32 + kc) * 16 * 128,
                                             kTilePanel, 1024);
          if constexpr (N == 128) {
            hw::wgmma_rs_m64n128_tb(S, xh[kc], bd);
            hw::wgmma_rs_m64n128_tb(S, xl[kc], bd);
          } else {
            hw::wgmma_rs_m64n64_tb(S, xh[kc], bd);
            hw::wgmma_rs_m64n64_tb(S, xl[kc], bd);
          }
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
      }
#pragma unroll
      for (int x = 0; x < N / 2; ++x) hw::fence_reg(S[x]);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty_bar(bar, st));
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(p.final_state + state_off + (size_t)(r0 + 8 * hh) * N +
                                   8 * nt + 2 * t) =
            make_float2(S[4 * nt + 2 * hh], S[4 * nt + 2 * hh + 1]);
  }
  hw::named_sync(kBarSFree, kSyncThreads);  // the row warpgroups' last release
}

// A row warpgroup: chunk rows 64 WG .. 64 WG + 63 of every chunk of every
// item this CTA takes. C B^T, then (once S is published) C S^T behind it,
// W built while C S^T runs, W X, the epilogue.
template <int N, int WG>
__device__ __forceinline__ void row_wg(const CUtensorMap* ty, const Args& p, uint32_t base,
                                       const float* gvec) {
  using Lt = Layout<N>;
  constexpr int NG = WG == 1 ? 64 : 32;  // C B^T accumulator: 64 x 128 (wg 1) or 64 x 64
  constexpr int KC = NG / 8;             // 16-column k-steps of W X
  constexpr int NY = kP / 2;             // y accumulator (64 x 64)
  const uint32_t bar = base + Lt::kBar;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's first row of the warpgroup's 64 (then r0 + 8)
  const int i0 = 64 * WG + r0;   // ... as a row of the chunk

  float G[NG];
  float y[NY];
  uint32_t wh[KC][4], wl[KC][4];
  auto pin = [&](auto& arr) {
#pragma unroll
    for (int x = 0; x < (int)(sizeof(arr) / sizeof(arr[0])); ++x) hw::fence_reg(arr[x]);
  };
#pragma unroll
  for (int x = 0; x < NG; ++x) G[x] = 0.f;
#pragma unroll
  for (int x = 0; x < NY; ++x) y[x] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) wh[kc][r] = wl[kc][r] = 0u;
  hw::named_arrive(kBarSFree, kSyncThreads);  // S is free for the first publish

  int c = 0;
  for (int u = blockIdx.x; u < p.n_items; u += gridDim.x) {
    const int b = u / p.H, h = u % p.H;
    for (int z = 0; z < p.n_chunks; ++z, ++c) {
      const int st = c % kStages;
      const int s0 = z * kL;
      const float* vec = gvec + st * 4 * kL;
      hw::mbar_wait(full_bar(bar, st), (c / kStages) & 1);

      // G = C B^T for this warpgroup's rows (wg 0: the columns j < 64 only),
      // then y = C S^T (S as hi + lo) once S is published.
      pin(G);
      pin(y);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t ca =
            base + Lt::c(st) + (kk / 4) * kTilePanel + WG * 64 * 128 + (kk % 4) * 32;
        const uint32_t ba = base + Lt::b(st) + (kk / 4) * kTilePanel + (kk % 4) * 32;
        if constexpr (WG == 1)
          hw::wgmma_ss_m64n128(G, hw::desc_sw128(ca, 16, 1024), hw::desc_sw128(ba, 16, 1024),
                               kk > 0);
        else
          hw::wgmma_ss_m64n64(G, hw::desc_sw128(ca, 16, 1024), hw::desc_sw128(ba, 16, 1024),
                              kk > 0);
      }
      hw::wgmma_commit();
      hw::named_sync(kBarSReady, kSyncThreads);
      issue_cs<N, WG>(y, base, st);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();
      pin(G);

      // W = G * exp(cum_i - cum_j) * dt_j on j <= i, as hi and lo A fragments.
      {
        const float ci[2] = {vec[kCum * kL + i0], vec[kCum * kL + i0 + 8]};
#pragma unroll
        for (int nt = 0; nt < NG / 4; ++nt) {
          const int j0 = 8 * nt + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(vec + kCum * kL + j0);
          const float2 dj = *reinterpret_cast<const float2*>(vec + kDt * kL + j0);
          // Column tiles that may cross the diagonal: all of wg 0's, the
          // second half of wg 1's (its rows are >= 64).
          const bool edge = WG == 0 || nt >= 8;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const float cjv = (e & 1) ? cj.y : cj.x;
            const float djv = (e & 1) ? dj.y : dj.x;
            float wv = G[4 * nt + e] * hw::exp2_approx(ci[hh] - cjv) * djv;
            if (edge) wv = j0 + (e & 1) <= i0 + 8 * hh ? wv : 0.f;
            G[4 * nt + e] = wv;
          }
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split2(G[8 * kc + 2 * r], G[8 * kc + 2 * r + 1], wh[kc][r], wl[kc][r]);
      }
      hw::wgmma_wait<0>();
      pin(y);
      hw::named_arrive(kBarSFree, kSyncThreads);
      {
        const float e0 = vec[kECum * kL + i0], e1 = vec[kECum * kL + i0 + 8];
#pragma unroll
        for (int x = 0; x < NY; ++x) y[x] *= ((x >> 1) & 1) ? e1 : e0;
      }

      // y = exp(cum_i) (C S^T) + W X, W as hi + lo; X through a transposed
      // descriptor.
      pin(y);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hw::fence_reg(wh[kc][r]);
          hw::fence_reg(wl[kc][r]);
        }
      hw::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint64_t xd = hw::desc_sw128(base + Lt::x(st) + kc * 16 * 128, kTilePanel, 1024);
        hw::wgmma_rs_m64n64_tb(y, wh[kc], xd);
        hw::wgmma_rs_m64n64_tb(y, wl[kc], xd);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      pin(y);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty_bar(bar, st));

      // Epilogue: y in bf16 into this warpgroup's shared buffer (the 128-byte
      // swizzle of y's tensor map), stored by TMA, which leaves out rows past
      // S. The store runs on while the next chunk starts; the buffer is
      // rewritten only after it has been read.
      const uint32_t so = base + Lt::kY + WG * Lt::kYBytes;
      if (tid == 0) hw::bulk_wait_read<0>();
      hw::named_sync(kBarEpilogue + WG, 128);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
#pragma unroll
        for (int jn = 0; jn < kP / 8; ++jn)
          hw::st_shared_u32(so + r * 128 + ((jn ^ (r % 8)) * 16) + 4 * t,
                            hw::cvt_bf16x2(y[4 * jn + 2 * hh], y[4 * jn + 2 * hh + 1]));
      }
      hw::fence_proxy_async();
      hw::named_sync(kBarEpilogue + WG, 128);
      if (tid == 0 && s0 + WG * 64 < p.S) {
        hw::tma_store_4d(ty, so, 0, h, s0 + WG * 64, b);
        hw::bulk_commit();
      }
    }
  }
  if (tid == 0) hw::bulk_wait<0>();
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap ty,
               const Args p) {
  using Lt = Layout<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* gvec = reinterpret_cast<float*>(smem_raw + (base - raw) + Lt::kVec);
  const uint32_t bar = base + Lt::kBar;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(full_bar(bar, st), 1 + 32);  // one expect_tx and 32 lanes' dt and scan
      hw::mbar_init(empty_bar(bar, st), kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kProducerWg) {
    hw::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 < 32) producer<N>(&tx, &tb, &tc, p, base, gvec);
  } else if (wg == kStateWg) {
    hw::setmaxnreg_inc<kStateRegs>();
    state_wg<N>(p, base, gvec);
  } else if (wg == 0) {
    row_wg<N, 0>(&ty, p, base, gvec);  // keeps its 128 (kRow0Regs)
  } else {
    hw::setmaxnreg_inc<kRow1Regs>();
    row_wg<N, 1>(&ty, p, base, gvec);
  }
}

template <int N>
cudaError_t launch(const void* x, const void* b, const void* c, void* y, Args a, int B,
                   cudaStream_t stream) {
  using Lt = Layout<N>;
  CUtensorMap tx, tb, tc, ty;
  if (!hw::tensor_map_bshd(&tx, x, B, a.S, a.H, kP, kL) ||
      !hw::tensor_map_bshd(&tb, b, B, a.S, 1, N, kL) ||
      !hw::tensor_map_bshd(&tc, c, B, a.S, 1, N, kL) ||
      !hw::tensor_map_bshd(&ty, y, B, a.S, a.H, kP, 64))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = hw::persistent_setup<ssd_kernel<N>>((int)Lt::kAlloc, &sms);
  if (err != cudaSuccess) return err;
  const int grid = min(sms, a.n_items);
  a.max_k = (a.n_items + grid - 1) / grid;
  ssd_kernel<N><<<grid, kThreads, Lt::kAlloc, stream>>>(tx, tb, tc, ty, a);
  return cudaGetLastError();
}

int run(const void* x, const void* dt, const void* a, const void* b, const void* c,
        const void* init, void* y, void* final_state, int B, int S, int H, int P, int N,
        void* stream, void* visit) {
  if (P != kP || S < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.init = static_cast<const float*>(init);
  args.final_state = static_cast<float*>(final_state);
  args.visit = static_cast<int*>(visit);
  args.S = S;
  args.H = H;
  args.n_items = B * H;
  args.n_chunks = (S + kL - 1) / kL;
  args.max_k = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 128) return static_cast<int>(launch<128>(x, b, c, y, args, B, st));
  if (N == 64) return static_cast<int>(launch<64>(x, b, c, y, args, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for a head dim other than 64,
// a state dim other than 64 and 128, or a tensor map the driver refuses.
// `init` may be null (zeros). S >= 1. No synchronisation: the kernel runs
// on `stream`.
extern "C" int ssd_fwd_bf16(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* init, void* y, void* final_state, int B,
                            int S, int H, int P, int N, void* stream) {
  return run(x, dt, a, b, c, init, y, final_state, B, S, H, P, N, stream, nullptr);
}

// The same launch recording each CTA's items into `visit` (grid,
// ceil(B H / grid)) int32, -1 past a CTA's last; the grid is min(SMs, B H).
extern "C" int ssd_fwd_bf16_visit(const void* x, const void* dt, const void* a, const void* b,
                                  const void* c, const void* init, void* y, void* final_state,
                                  int B, int S, int H, int P, int N, void* stream, void* visit) {
  return run(x, dt, a, b, c, init, y, final_state, B, S, H, P, N, stream, visit);
}

// What the launch at (B, H, N) runs: out[0] registers a thread (at launch,
// before setmaxnreg moves them), out[1] dynamic shared memory bytes, out[2]
// threads a CTA, out[3] local (spill) bytes a thread, out[4] the cluster
// size (1), out[5] the grid's CTAs. Returns a cudaError_t code.
extern "C" int ssd_attr(int B, int H, int N, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  int sms = 0;
  if (N == 128) {
    err = cudaFuncGetAttributes(&fa, ssd_kernel<128>);
    if (err == cudaSuccess) err = hw::persistent_setup<ssd_kernel<128>>(Layout<128>::kAlloc, &sms);
    out[1] = (int)Layout<128>::kAlloc;
  } else if (N == 64) {
    err = cudaFuncGetAttributes(&fa, ssd_kernel<64>);
    if (err == cudaSuccess) err = hw::persistent_setup<ssd_kernel<64>>(Layout<64>::kAlloc, &sms);
    out[1] = (int)Layout<64>::kAlloc;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[2] = kThreads;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 1;
  out[5] = min(sms, B * H);
  return 0;
}
