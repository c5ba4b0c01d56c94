// Ragged paged attention for NVIDIA Hopper (sm_90a), CUDA C++ with raw PTX.
//
// Replaces repro/kernels/flash_decode.py::_paged_decode_kernel (:122), the
// Pallas kernel that runs every attention call of every mixed step of the
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
// What bounds it: bytes. A decode row does 4 flops per K/V element pair,
// far below the card's ~295 flops per byte; a 256-token chunk row does 64
// times that, still below it, but only on the tensor cores. The design
// (the decode core, csrc/decode_core.cuh):
//   * Work items are (b, h, row tile of 64 folded rows), numbered so a
//     row's tiles are neighbours (its K/V is re-read from L2). Each item is
//     a cluster of S CTAs (S from pick_splits, no host copy of lens): the
//     pages the item's rows can see, in visit order (the first column at
//     most min(len - 1, the tile's last q_pos), not wholly left of the
//     window), are cut into S contiguous segments, split s walking segment
//     s in order; skipping unseen pages and 64-position sub-tiles is exact,
//     as an unseen tile would add p = 0 and alpha = 1. The S partial
//     states merge over distributed shared memory in split order.
//   * K and V stream through a two-stage ring of 64-position tiles filled
//     with 16-byte cp.async, the next tile's copies in flight while the
//     current one is computed. cp.async rather than TMA: a copy per row
//     writes zeros for every position at or past len (stale pool rows,
//     where 0 x NaN would poison P V, K too on the tensor-core path), and
//     pages of any size (8 to 512 positions) cut into tiles the same way.
//   * A tile with at most 8 valid rows (the decode rows) runs on the CUDA
//     cores, every warp on 16 of the tile's positions for all the rows
//     (R in {1, 2, 4, 8} rows a CTA, by instantiation). A tile with more
//     (chunked prefill) runs S = Q K^T and O += P V as wgmma (64 x 64 x D
//     and 64 x D x 64), operands in the 128-byte swizzle, P rounded to
//     bf16, the mask applied only on boundary tiles (a template
//     parameter). The CTA reads q_lens[b] and takes one path or the other.
// With `visit`, each CTA records the logical pages it walked (-1 past its
// segment): kernels/flash_decode.py::paged_decode_walks is the host model.

#include <type_traits>

#include "decode_core.cuh"

namespace {

using namespace repro;
using namespace repro::decode;
namespace hw = repro::sm90;

struct Args {
  const uint16_t* q;      // (B, C, Hq, D) bf16
  const uint16_t* k;      // (n_pages, page, Hkv, D) bf16
  const uint16_t* v;
  const int* phys;        // (B, n_blocks) pool page ids, visit order
  const int* logical;     // (B, n_blocks) logical page ids, visit order
  const int* lens;        // (B,) valid KV length incl. this chunk
  const int* q_lens;      // (B,) valid chunk rows
  uint16_t* out;          // (B, C, Hq, D) bf16
  int* visit;             // (B * Hkv, n_rt, S, n_blocks) int32, or null
  int C, Hq, Hkv, G, n_blocks, page, window, splits, n_rt;
  float scale_log2;
};

// Shared memory from a 1024-byte aligned base: the query rows (bf16 Q tile
// in the swizzle for wgmma, or R f32 rows), the ring, the seen-page list.
// The export and the warps' states reuse the ring once it is drained.
constexpr uint32_t align1k(uint32_t x) { return (x + 1023u) & ~1023u; }

template <int D, int R, bool kChunk>
struct Layout {
  using RT = RowsTile<D>;
  static constexpr uint32_t kSwzTile = kT * D * 2;  // K or V tile in the swizzle
  static constexpr uint32_t kQBytes =
      kChunk ? (kMaxRows * D * 2 > RT::q_bytes(8) ? kMaxRows * D * 2 : RT::q_bytes(8))
             : RT::q_bytes(R);
  static constexpr uint32_t kStage =
      kChunk ? align1k(RT::kBytes > 2 * kSwzTile ? RT::kBytes : 2 * kSwzTile) : RT::kBytes;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kRing = align1k(kQBytes);
  static constexpr uint32_t kList = kRing + kStages * kStage;
  static constexpr int kExportRows = kChunk ? kMaxRows : R;
  static constexpr uint32_t kWarpArea = kRing + RT::export_bytes(kExportRows);
  static_assert(RT::export_bytes(kExportRows) + RT::warps_bytes(kChunk ? 8 : R) <=
                    kStages * kStage,
                "end-of-walk areas must fit the ring");
  // The seen-page list: (first column, pool page) pairs.
  static constexpr uint32_t bytes(int n_blocks) { return kList + 8 * n_blocks + 1024; }
};

// Where a CTA is in its walk: the seen-list index k of its page and the
// sub-tile start `sub` in that page; k == end past the last.
struct Tile {
  int k, sub, end;
  __device__ __forceinline__ bool valid() const { return k < end; }
};

// ---- the tensor-core path (chunk rows) ----------------------------------------

// Online softmax of one 64 x 64 S tile in place (log2 domain), rows g and
// g + 8 of this warp's 16; only boundary tiles are masked (-inf, so p = 0).
template <bool kEdge>
__device__ __forceinline__ void chunk_softmax(float (&s)[32], float (&mrow)[2], float (&l)[2],
                                              float (&alpha)[2], float scale_log2,
                                              const int (&qp)[2], int col0, int n_cols, int len,
                                              int window, int tq) {
  if (kEdge) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int h = (x >> 1) & 1;
      const int cl = 8 * (x >> 2) + 2 * tq + (x & 1);
      const int col = col0 + cl;
      bool ok = cl < n_cols && col <= qp[h] && col < len;
      if (window >= 0) ok = ok && col > qp[h] - window;
      if (!ok) s[x] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(mrow[h], mx[h] * scale_log2);  // finite
    alpha[h] = hw::exp2_approx(mrow[h] - m_new);
    mrow[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1;
    s[x] = hw::exp2_approx(fmaf(s[x], scale_log2, -mrow[h]));
    l[h] += s[x];
  }
}

// Swizzled shared address of 16-byte chunk cc of row r in a tile of `rows`
// rows, D wide (64-column panels of rows x 128 bytes).
__device__ __forceinline__ uint32_t swz(uint32_t base, int rows, int r, int cc) {
  return base + (cc >> 3) * rows * 128 + r * 128 + ((((cc & 7) ^ (r & 7))) << 4);
}

// ---- the kernel -----------------------------------------------------------------

template <int D, int R, bool kChunk>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Args p) {
  using L = Layout<D, R, kChunk>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_seen_s;
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);

  const int bh = blockIdx.y, b = bh / p.Hkv, kvh = bh % p.Hkv;
  const int S = p.splits;
  const int rt = blockIdx.x / S;
  const int split = (int)hw::cluster_rank();
  const int rows = p.C * p.G;
  const int row0 = rt * kMaxRows;
  const int n_out = min(kChunk ? kMaxRows : R, rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* lg = p.logical + (size_t)b * p.n_blocks;
  const int* ph = p.phys + (size_t)b * p.n_blocks;
  // Warp 0 reads the first 32 pages of the visit order with the lengths,
  // before it knows which it needs.
  int lg0 = 0, ph0 = 0;
  if (warp == 0 && lane < p.n_blocks) {
    lg0 = lg[lane];
    ph0 = ph[lane];
  }
  const int len = p.lens[b];
  const int q_len = p.q_lens[b];
  int n_valid = min(p.C, max(q_len, 0)) * p.G - row0;  // valid rows: a prefix of the folded axis
  n_valid = len > 0 ? max(0, min(n_valid, n_out)) : 0;
  auto q_row = [&](int r) {
    const int row = row0 + r, t = row / p.G, g = row % p.G;
    return p.q + ((size_t)(b * p.C + t) * p.Hq + kvh * p.G + g) * D;
  };
  auto out_row = [&](int r) {
    const int row = row0 + r, t = row / p.G, g = row % p.G;
    return p.out + ((size_t)(b * p.C + t) * p.Hq + kvh * p.G + g) * D;
  };
  int* vrec = p.visit == nullptr
                  ? nullptr
                  : p.visit + (((size_t)bh * p.n_rt + rt) * S + split) * p.n_blocks;

  if (n_valid == 0) {
    store_zeros<D>(S, 0, n_out, out_row);
    if (vrec != nullptr)
      for (int j = tid; j < p.n_blocks; j += kThreads) vrec[j] = -1;
    return;
  }

  const int qbase = len - q_len;
  const int qpos_min = qbase + row0 / p.G;
  const int qpos_max = qbase + (row0 + n_valid - 1) / p.G;
  const int col_limit = min(len - 1, qpos_max);  // the last column any row sees

  // The pages some row of the tile sees, in visit order, as (first column,
  // pool page) pairs (warp 0, by ballot).
  int2* seen = reinterpret_cast<int2*>(sb + L::kList);
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < p.n_blocks; j0 += 32) {
      const int j = j0 + lane;
      int ps = lg0 * p.page, pid = ph0;
      if (j0 > 0 && j < p.n_blocks) {
        ps = lg[j] * p.page;
        pid = ph[j];
      }
      const bool ok = j < p.n_blocks && ps <= col_limit &&
                      !(p.window >= 0 && ps + p.page - 1 <= qpos_min - p.window);
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) seen[n + __popc(m & ((1u << lane) - 1u))] = make_int2(ps, pid);
      n += __popc(m);
    }
    if (lane == 0) n_seen_s = n;
  }
  __syncthreads();
  const int n_seen = n_seen_s;
  const int seg_lo = n_seen * split / S, seg_hi = n_seen * (split + 1) / S;

  // The first walked sub-tile at or after `t` (skips are exact).
  auto settle = [&](Tile t) {
    while (t.k < t.end) {
      const int ps = seen[t.k].x;
      if (t.sub < p.page && ps + t.sub <= col_limit) {
        const int n = min(kT, p.page - t.sub);
        if (p.window >= 0 && ps + t.sub + n - 1 <= qpos_min - p.window) {
          t.sub += kT;
          continue;
        }
        return t;
      }
      ++t.k;
      t.sub = 0;
    }
    return t;
  };
  auto next = [&](Tile t) {
    t.sub += kT;
    return settle(t);
  };
  const Tile first = settle(Tile{seg_lo, 0, seg_hi});
  // Position pp of tile t: element offset in the pool, or -1 (zeros).
  auto tile_off = [&](const Tile& t) {
    const int2 e = seen[t.k];
    const int col0 = e.x + t.sub;
    const int n = min(kT, min(p.page - t.sub, len - col0));
    const size_t row = (size_t)e.y * p.page + t.sub;
    return [=](int pp) -> long long {
      return pp < n ? (long long)(((row + pp) * p.Hkv + kvh) * D) : -1;
    };
  };
  int n_rec = 0, last_k = -1;
  auto record = [&](const Tile& t) {
    if (vrec != nullptr && tid == 0 && t.k != last_k) vrec[n_rec++] = seen[t.k].x / p.page;
    last_k = t.k;
  };

  float* ex = reinterpret_cast<float*>(sb + L::kRing);
  const uint32_t ex_addr = base + L::kRing;

  // The CUDA-core path for RR rows.
  auto rows_path = [&](auto rr) {
    constexpr int RR = decltype(rr)::value;
    float* Qs = reinterpret_cast<float*>(sb + L::kQ);
    int qp[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r)  // -1: a row past n_valid sees nothing
      qp[r] = r < n_valid ? qbase + (row0 + r) / p.G : -1;
    Rows<D, RR> st;
    st.init();
    run_ring<false>(
        first, next,
        [&](const Tile& t, int stage) {
          load_rows_tile<D>(base + L::kRing + stage * L::kStage, p.k, p.v, tile_off(t));
        },
        [&]() { load_rows_q<D, RR>(Qs, n_valid, p.scale_log2, q_row); },
        [&](const Tile& t, int stage) {
          record(t);
          const int col0 = seen[t.k].x + t.sub;
          const int n = min(kT, p.page - t.sub);
          st.step(sb + L::kRing + stage * L::kStage, Qs, n, [&](int r, int pp) {
            const int col = col0 + pp;
            bool ok = col <= qp[r] && col < len;
            if (p.window >= 0) ok = ok && col > qp[r] - p.window;
            return ok;
          });
        });
    st.export_state(reinterpret_cast<float*>(sb + L::kWarpArea), ex, L::kExportRows);
  };

  if constexpr (kChunk) {
    if (n_valid > 8) {
      // The tensor-core path: one warpgroup, 64 rows.
      const uint32_t qa = base + L::kQ;
      constexpr int CH = D / 8;
      for (int i = tid; i < kMaxRows * CH; i += kThreads) {
        const int r = i / CH, cc = i % CH;
        const bool ok = r < n_valid;
        hw::cp_async_16(swz(qa, kMaxRows, r, cc), ok ? q_row(r) + cc * 8 : p.q, ok);
      }
      const int g = lane >> 2, tq = lane & 3;
      const int wrow = warp * 16 + g;
      const int qp[2] = {qbase + (row0 + wrow) / p.G, qbase + (row0 + wrow + 8) / p.G};
      float s[32], o[D / 2];
      uint32_t pa[kT / 16][4];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc) pa[kc][0] = pa[kc][1] = pa[kc][2] = pa[kc][3] = 0u;
      float mrow[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f}, alpha[2];
      auto pin = [&]() {
#pragma unroll
        for (int x = 0; x < 32; ++x) hw::fence_reg(s[x]);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) hw::fence_reg(o[x]);
#pragma unroll
        for (int kc = 0; kc < kT / 16; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) hw::fence_reg(pa[kc][e]);
      };
      run_ring<true>(
          first, next,
          [&](const Tile& t, int stage) {
            const uint32_t ka = base + L::kRing + stage * L::kStage;
            const uint32_t va = ka + L::kSwzTile;
            auto off = tile_off(t);
            for (int i = tid; i < kT * CH; i += kThreads) {
              const int pp = i / CH, cc = i % CH;
              const long long e = off(pp);
              const bool ok = e >= 0;
              const size_t at = ok ? (size_t)e + cc * 8 : 0;
              hw::cp_async_16(swz(ka, kT, pp, cc), p.k + at, ok);
              hw::cp_async_16(swz(va, kT, pp, cc), p.v + at, ok);
            }
          },
          [&]() {},
          [&](const Tile& t, int stage) {
            record(t);
            const uint32_t ka = base + L::kRing + stage * L::kStage;
            const uint32_t va = ka + L::kSwzTile;
            const int col0 = seen[t.k].x + t.sub;
            const int n = min(kT, p.page - t.sub);
            pin();
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const uint32_t a = qa + (kk / 4) * kMaxRows * 128 + (kk % 4) * 32;
              const uint32_t bb = ka + (kk / 4) * kT * 128 + (kk % 4) * 32;
              hw::wgmma_ss_m64n64(s, hw::desc_sw128(a, 16, 1024), hw::desc_sw128(bb, 16, 1024),
                                  kk > 0);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
#pragma unroll
            for (int x = 0; x < 32; ++x) hw::fence_reg(s[x]);
            const bool edge = n < kT || col0 + kT - 1 > qpos_min ||
                              (p.window >= 0 && col0 <= qpos_max - p.window);
            if (edge)
              chunk_softmax<true>(s, mrow, l, alpha, p.scale_log2, qp, col0, n, len, p.window, tq);
            else
              chunk_softmax<false>(s, mrow, l, alpha, p.scale_log2, qp, col0, n, len, p.window,
                                   tq);
#pragma unroll
            for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
            for (int kc = 0; kc < kT / 16; ++kc) {
              pa[kc][0] = hw::cvt_bf16x2(s[8 * kc + 0], s[8 * kc + 1]);
              pa[kc][1] = hw::cvt_bf16x2(s[8 * kc + 2], s[8 * kc + 3]);
              pa[kc][2] = hw::cvt_bf16x2(s[8 * kc + 4], s[8 * kc + 5]);
              pa[kc][3] = hw::cvt_bf16x2(s[8 * kc + 6], s[8 * kc + 7]);
            }
            pin();
            hw::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < kT / 16; ++kc) {
              const uint64_t vd = hw::desc_sw128(va + kc * 16 * 128, kT * 128, 1024);
              if constexpr (D == 128)
                hw::wgmma_rs_m64n128_tb(o, pa[kc], vd);
              else
                hw::wgmma_rs_m64n64_tb(o, pa[kc], vd);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
#pragma unroll
            for (int x = 0; x < D / 2; ++x) hw::fence_reg(o[x]);
          });
      // Export: full row sums across the quad, m and l by row, acc by column.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = wrow + 8 * h;
        if (tq == 0) {
          ex[r] = mrow[h];
          ex[kMaxRows + r] = l[h];
        }
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn)
          *reinterpret_cast<float2*>(ex + 2 * kMaxRows + r * D + 8 * jn + 2 * tq) =
              make_float2(o[4 * jn + 2 * h], o[4 * jn + 2 * h + 1]);
      }
    } else if (n_valid > 4) {
      rows_path(std::integral_constant<int, 8>{});
    } else if (n_valid > 2) {
      rows_path(std::integral_constant<int, 4>{});
    } else if (n_valid > 1) {
      rows_path(std::integral_constant<int, 2>{});
    } else {
      rows_path(std::integral_constant<int, 1>{});
    }
  } else {
    rows_path(std::integral_constant<int, R>{});
  }
  if (vrec != nullptr && tid == 0)
    for (int j = n_rec; j < p.n_blocks; ++j) vrec[j] = -1;
  merge_store<D>(ex_addr, L::kExportRows, S, n_valid, n_out, out_row);
}

template <int D, int R, bool kChunk>
cudaError_t launch(const Args& a, int B, int dev, cudaStream_t stream) {
  static int opted[kMaxDevices];
  const dim3 grid(a.splits * a.n_rt, B * a.Hkv);
  return launch_clusters(paged_decode_kernel<D, R, kChunk>, opted, dev, grid, a.splits,
                         (int)Layout<D, R, kChunk>::bytes(a.n_blocks), a, stream);
}

// The instantiation for `rows` = C * G folded rows: up to 8 rows, the
// CUDA-core path alone with R rows; more, row tiles of 64 with both paths.
template <int D>
cudaError_t launch_rows(const Args& a, int B, int rows, int dev, cudaStream_t stream) {
  if (rows <= 1) return launch<D, 1, false>(a, B, dev, stream);
  if (rows <= 2) return launch<D, 2, false>(a, B, dev, stream);
  if (rows <= 4) return launch<D, 4, false>(a, B, dev, stream);
  if (rows <= 8) return launch<D, 8, false>(a, B, dev, stream);
  return launch<D, 8, true>(a, B, dev, stream);
}

// Fills `a` for a call; splits <= 0 picks them (pick_splits over B * Hkv
// items: the host does not know which row tiles past the first hold rows).
cudaError_t make_args(Args* a, const void* q, const void* k_pool, const void* v_pool,
                      const void* phys, const void* logical, const void* lens,
                      const void* q_lens, void* out, int* visit, int B, int C, int Hq, int Hkv,
                      int D, int n_blocks, int page, int window, float scale, int splits,
                      int* dev) {
  if ((D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || C <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(&sms, dev);
  if (err != cudaSuccess) return err;
  const int per_sm = C * (Hq / Hkv) > 8 ? kChunkCtasPerSm : kRowCtasPerSm;
  if (splits <= 0) splits = pick_splits(B * Hkv, n_blocks, sms, per_sm);
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return cudaErrorInvalidValue;
  a->q = static_cast<const uint16_t*>(q);
  a->k = static_cast<const uint16_t*>(k_pool);
  a->v = static_cast<const uint16_t*>(v_pool);
  a->phys = static_cast<const int*>(phys);
  a->logical = static_cast<const int*>(logical);
  a->lens = static_cast<const int*>(lens);
  a->q_lens = static_cast<const int*>(q_lens);
  a->out = static_cast<uint16_t*>(out);
  a->visit = visit;
  a->C = C;
  a->Hq = Hq;
  a->Hkv = Hkv;
  a->G = Hq / Hkv;
  a->n_blocks = n_blocks;
  a->page = page;
  a->window = window;
  a->splits = splits;
  a->n_rt = (C * a->G + kMaxRows - 1) / kMaxRows;
  a->scale_log2 = scale * kLog2e;
  return cudaSuccess;
}

cudaError_t run(const Args& a, int B, int D, int dev, cudaStream_t st) {
  const int rows = a.C * a.G;
  return D == 128 ? launch_rows<128>(a, B, rows, dev, st) : launch_rows<64>(a, B, rows, dev, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code:
// 0 on a successful launch, cudaErrorInvalidValue for an unsupported head
// dim. No synchronisation: the kernel runs on `stream`.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                 const void* phys, const void* logical, const void* lens,
                                 const void* q_lens, void* out, int B, int C, int Hq, int Hkv,
                                 int D, int n_blocks, int page, int window, float scale,
                                 void* stream) {
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, q, k_pool, v_pool, phys, logical, lens, q_lens, out, nullptr,
                              B, C, Hq, Hkv, D, n_blocks, page, window, scale, 0, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(a, B, D, dev, static_cast<cudaStream_t>(stream)));
}

// paged_decode_bf16 that also records each CTA's walk into `visit` (B * Hkv,
// n_rt, splits, n_blocks) int32: the logical pages it walked in order, -1
// after. `splits` in {1, 2, 4, 8} overrides the split count; 0 keeps the
// kernel's own choice (paged_decode_attr reports it).
extern "C" int paged_decode_bf16_visit(const void* q, const void* k_pool, const void* v_pool,
                                       const void* phys, const void* logical, const void* lens,
                                       const void* q_lens, void* out, int B, int C, int Hq,
                                       int Hkv, int D, int n_blocks, int page, int window,
                                       float scale, void* stream, void* visit, int splits) {
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, q, k_pool, v_pool, phys, logical, lens, q_lens, out,
                              static_cast<int*>(visit), B, C, Hq, Hkv, D, n_blocks, page, window,
                              scale, splits, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(a, B, D, dev, static_cast<cudaStream_t>(stream)));
}

// The launch paged_decode_bf16 makes at this shape: out[0] registers a
// thread, out[1] dynamic shared memory bytes a CTA, out[2] threads a CTA,
// out[3] local (spill) bytes a thread, out[4] the split (cluster) size,
// out[5] CTAs in the grid. Returns a cudaError_t code.
extern "C" int paged_decode_attr(int B, int C, int Hq, int Hkv, int D, int n_blocks, int page,
                                 int* out) {
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, B, C, Hq, Hkv, D, n_blocks, page, -1, 1.f, 0,
                              &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = C * a.G;
  cudaFuncAttributes fa;
  int smem = 0;
#define REPRO_ATTR(DD, RR, CK)                                              \
  do {                                                                       \
    err = cudaFuncGetAttributes(&fa, paged_decode_kernel<DD, RR, CK>);       \
    smem = (int)Layout<DD, RR, CK>::bytes(n_blocks);                         \
  } while (0)
  if (D == 128) {
    if (rows <= 1) REPRO_ATTR(128, 1, false);
    else if (rows <= 2) REPRO_ATTR(128, 2, false);
    else if (rows <= 4) REPRO_ATTR(128, 4, false);
    else if (rows <= 8) REPRO_ATTR(128, 8, false);
    else REPRO_ATTR(128, 8, true);
  } else {
    if (rows <= 1) REPRO_ATTR(64, 1, false);
    else if (rows <= 2) REPRO_ATTR(64, 2, false);
    else if (rows <= 4) REPRO_ATTR(64, 4, false);
    else if (rows <= 8) REPRO_ATTR(64, 8, false);
    else REPRO_ATTR(64, 8, true);
  }
#undef REPRO_ATTR
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = smem;
  out[2] = kThreads;
  out[3] = (int)fa.localSizeBytes;
  out[4] = a.splits;
  out[5] = a.splits * a.n_rt * B * Hkv;
  return 0;
}
