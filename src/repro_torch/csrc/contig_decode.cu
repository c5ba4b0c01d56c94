// One-token decode attention over a contiguous KV cache, for NVIDIA Hopper
// (sm_90a), CUDA C++ with raw PTX.
//
// Replaces repro/kernels/flash_decode.py::_decode_kernel (:94), the Pallas
// kernel of every decode step of the static serve path (LM.decode_step over
// the contiguous per-layer caches, SWA ring buffers included).
//
// What it computes: for each batch row b and query head, softmax over the
// cached positions pos of q . k[pos] * scale, times v: position pos is
// visible iff pos < lens[b] and, with a window, pos > lens[b] - 1 - window
// (the reference's (B, S_max) mask, derived here in-kernel from the
// per-row lengths; no mask operand exists). A row of length 0 gives exact
// zeros.
//
// The walk: the cache is cut into n_chunks = ceil(S_max / chunk) chunks
// (chunk as the reference derives it), visited in kv_index(order, b * Hkv
// + h, j, n_chunks) order (the parity key is the (row, kv head) index, as
// in the TPU kernel), each chunk cut into tiles of 64 positions in
// ascending order. Tiles wholly past the length or left of the window are
// skipped, which is exact.
//
// What bounds it on this card: bytes. Each valid K/V element is read once
// and used for 2 G flops, far below the card's ~295 flops per byte. The
// design (the decode core, csrc/decode_core.cuh): a work item is one (b,
// kv head, tile of R of its G query heads), so K and V of a (row, kv head)
// are read once for all its query heads; each item is a cluster of S CTAs
// (S from pick_splits over the items and the cache's tiles), split s
// walking the s-th contiguous segment of the item's seen tiles in walk
// order, and the S partial states merge over distributed shared memory in
// split order. K and V stream through a two-stage ring filled by 16-byte
// cp.async (zeros at and past the length), the next tile in flight while
// the current one is computed on the CUDA cores, every warp on 16 of the
// tile's positions for all R rows. Head dims 64, 80 (zamba2's shared
// attention), 96 (phi-3-vision) and 128. With `visit`, each CTA records the first position of
// every tile it walked (-1 past its segment):
// kernels/flash_decode.py::contig_decode_walks is the host model.
//
// With `lse` (the kLse instantiation; a separate entry point, so the launch
// without it runs the same code as before), each row's float32 log-sum-exp
// of its scaled scores, (B, Hq), is written beside the output: the merged
// state's m + log l (kept in the log2 domain, so (m2 + log2 l) ln 2), and
// kMaskValue for a row that sees nothing. A cache split along its sequence
// across ranks merges the ranks' partial outputs by it
// (core/attention.py::merge_decode_partials).

#include "decode_core.cuh"

namespace {

using namespace repro;
using namespace repro::decode;
namespace hw = repro::sm90;

struct Args {
  const uint16_t* q;  // (B, 1, Hq, D)
  const uint16_t* k;  // (B, S_max, Hkv, D)
  const uint16_t* v;
  const int* lens;    // (B,)
  uint16_t* out;      // (B, 1, Hq, D)
  float* lse;         // (B, Hq) float32 (the kLse instantiation), or null
  int* visit;         // (B * Hkv, n_rt, S, W) int32, or null
  int S_max, Hq, Hkv, G, window, chunk, order, snake, splits, n_rt, W;
  float scale_log2;
};

template <int D, int R>
struct Layout {
  using RT = RowsTile<D>;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kRing = (RT::q_bytes(R) + 15u) & ~15u;
  static constexpr uint32_t kBytes = kRing + kStages * RT::kBytes;
  static constexpr uint32_t kWarpArea = kRing + RT::export_bytes(R);
  static_assert(RT::export_bytes(R) + RT::warps_bytes(R) <= kStages * RT::kBytes,
                "end-of-walk areas must fit the ring");
};

// A tile of the walk: chunk jc of the visit order, offset `off` in it, and
// the tiles left in this CTA's segment (none: past the last).
struct Tile {
  int jc, off, left;
  __device__ __forceinline__ bool valid() const { return left > 0; }
};

template <int D, int R, bool kLse>
__global__ void __launch_bounds__(kThreads) contig_decode_kernel(const Args p) {
  using L = Layout<D, R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = hw::smem_u32(smem);

  const int bh = blockIdx.y, b = bh / p.Hkv, kvh = bh % p.Hkv;
  const int S = p.splits;
  const int rt = blockIdx.x / S;
  const int split = (int)hw::cluster_rank();
  const int head0 = kvh * p.G + rt * R;
  const int n_out = min(R, p.G - rt * R);
  const int len = min(max(p.lens[b], 0), p.S_max);
  const int n_valid = len > 0 ? n_out : 0;
  const int first = p.window >= 0 ? max(0, len - p.window) : 0;  // first visible position
  const int tid = threadIdx.x;
  auto out_row = [&](int r) { return p.out + ((size_t)b * p.Hq + head0 + r) * D; };
  // By value: a reference capture would give the row's indices an address
  // (local memory) in the kLse instantiation.
  [[maybe_unused]] auto lse_out = [lse_row = p.lse + (size_t)b * p.Hq + head0](int r, float v) {
    lse_row[r] = v;
  };
  int* vrec = p.visit == nullptr ? nullptr
                                 : p.visit + (((size_t)bh * p.n_rt + rt) * S + split) * p.W;

  if (n_valid == 0) {
    store_zeros<D>(S, 0, n_out, out_row);
    if constexpr (kLse) {
      if (split == 0 && tid < n_out) lse_out(tid, kMaskValue);
    }
    if (vrec != nullptr)
      for (int j = tid; j < p.W; j += kThreads) vrec[j] = -1;
    return;
  }

  const int n_chunks = (p.S_max + p.chunk - 1) / p.chunk;
  const int group = order_group(p.order, p.snake, n_chunks);
  auto chunk0 = [&](int jc) { return snake_pos(bh, jc, n_chunks, group) * p.chunk; };
  // The first seen tile at or after `t` (t.left is carried).
  auto settle = [&](Tile t) {
    while (t.jc < n_chunks) {
      const int c0 = chunk0(t.jc);
      const int c1 = min(c0 + p.chunk, len);  // nothing at or past len is visible
      if (c0 + t.off < c1) {
        if (min(c0 + t.off + kT, c1) > first) return t;
        t.off += kT;
        continue;
      }
      ++t.jc;
      t.off = 0;
    }
    t.left = 0;
    return t;
  };
  auto step = [&](Tile t) {
    t.off += kT;
    return settle(t);
  };
  // This split's segment of the seen tiles.
  int n_seen = 0;
  for (Tile t = settle(Tile{0, 0, 1}); t.jc < n_chunks; t = step(t)) ++n_seen;
  const int lo = n_seen * split / S, hi = n_seen * (split + 1) / S;
  Tile first_tile = settle(Tile{0, 0, hi - lo});
  for (int i = 0; i < lo; ++i) first_tile = step(first_tile);
  first_tile.left = hi - lo;
  auto next = [&](Tile t) {
    const int left = t.left - 1;
    t = step(t);
    t.left = left > 0 ? left : 0;
    return t;
  };

  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  Rows<D, R> st;
  st.init();
  int n_rec = 0;
  run_ring<false>(
      first_tile, next,
      [&](const Tile& t, int stage) {
        const int t0 = chunk0(t.jc) + t.off;
        const int n = min(kT, min(chunk0(t.jc) + p.chunk, len) - t0);
        load_rows_tile<D>(base + L::kRing + stage * RowsTile<D>::kBytes, p.k, p.v,
                          [&](int pp) -> long long {
                            return pp < n ? (long long)((((size_t)b * p.S_max + t0 + pp) * p.Hkv +
                                                         kvh) * D)
                                          : -1;
                          });
      },
      [&]() {
        load_rows_q<D, R>(Qs, n_valid, p.scale_log2,
                          [&](int r) { return p.q + ((size_t)b * p.Hq + head0 + r) * D; });
      },
      [&](const Tile& t, int stage) {
        const int t0 = chunk0(t.jc) + t.off;
        const int n = min(kT, min(chunk0(t.jc) + p.chunk, len) - t0);
        if (vrec != nullptr && tid == 0) vrec[n_rec] = t0;
        ++n_rec;
        st.step(smem + L::kRing + stage * RowsTile<D>::kBytes, Qs, n,
                [&](int, int pp) { return t0 + pp >= first; });
      });
  float* ex = reinterpret_cast<float*>(smem + L::kRing);
  st.export_state(reinterpret_cast<float*>(smem + L::kWarpArea), ex, R);
  if (vrec != nullptr && tid == 0)
    for (int j = n_rec; j < p.W; ++j) vrec[j] = -1;
  if constexpr (kLse)
    merge_store<D>(base + L::kRing, R, S, n_valid, n_out, out_row, lse_out);
  else
    merge_store<D>(base + L::kRing, R, S, n_valid, n_out, out_row);
}

template <int D, int R>
cudaError_t launch(const Args& a, int B, int dev, cudaStream_t stream) {
  static int opted[kMaxDevices];
  static int opted_lse[kMaxDevices];
  const dim3 grid(a.splits * a.n_rt, B * a.Hkv);
  if (a.lse != nullptr)
    return launch_clusters(contig_decode_kernel<D, R, true>, opted_lse, dev, grid, a.splits,
                           (int)Layout<D, R>::kBytes, a, stream);
  return launch_clusters(contig_decode_kernel<D, R, false>, opted, dev, grid, a.splits,
                         (int)Layout<D, R>::kBytes, a, stream);
}

// Query heads a CTA holds: the GQA group, rounded up to 1, 2, 4 or 8.
int rows_of(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <int D>
cudaError_t launch_rows(const Args& a, int B, int dev, cudaStream_t stream) {
  switch (rows_of(a.G)) {
    case 1: return launch<D, 1>(a, B, dev, stream);
    case 2: return launch<D, 2>(a, B, dev, stream);
    case 4: return launch<D, 4>(a, B, dev, stream);
    default: return launch<D, 8>(a, B, dev, stream);
  }
}

// Fills `a` for a call; splits <= 0 picks them (pick_splits over the
// items and the cache's 64-position tiles).
cudaError_t make_args(Args* a, const void* q, const void* k, const void* v, const void* lens,
                      void* out, float* lse, int* visit, int B, int S_max, int Hq, int Hkv,
                      int D, int window, int chunk, int order, int snake, float scale,
                      int splits, int* dev) {
  if ((D != 64 && D != 80 && D != 96 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || S_max <= 0 ||
      chunk <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(&sms, dev);
  if (err != cudaSuccess) return err;
  a->G = Hq / Hkv;
  a->n_rt = (a->G + rows_of(a->G) - 1) / rows_of(a->G);
  if (splits <= 0)
    splits = pick_splits(B * Hkv * a->n_rt, (S_max + kT - 1) / kT, sms, kRowCtasPerSm);
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return cudaErrorInvalidValue;
  a->q = static_cast<const uint16_t*>(q);
  a->k = static_cast<const uint16_t*>(k);
  a->v = static_cast<const uint16_t*>(v);
  a->lens = static_cast<const int*>(lens);
  a->out = static_cast<uint16_t*>(out);
  a->lse = lse;
  a->visit = visit;
  a->S_max = S_max;
  a->Hq = Hq;
  a->Hkv = Hkv;
  a->window = window;
  a->chunk = chunk;
  a->order = order;
  a->snake = snake;
  a->splits = splits;
  a->W = ((S_max + chunk - 1) / chunk) * ((chunk + kT - 1) / kT);
  a->scale_log2 = scale * kLog2e;
  return cudaSuccess;
}

cudaError_t run(const Args& a, int B, int D, int dev, cudaStream_t st) {
  if (D == 128) return launch_rows<128>(a, B, dev, st);
  if (D == 80) return launch_rows<80>(a, B, dev, st);
  if (D == 96) return launch_rows<96>(a, B, dev, st);
  return launch_rows<64>(a, B, dev, st);
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
  int dev = 0;
  cudaError_t err = make_args(&a, q, k, v, lens, out, nullptr, nullptr, B, S_max, Hq, Hkv, D,
                              window, chunk, order, snake, scale, 0, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(a, B, D, dev, static_cast<cudaStream_t>(stream)));
}

// contig_decode_bf16 that also records each CTA's walk into `visit` (B *
// Hkv, n_rt, splits, W) int32, W = n_chunks * ceil(chunk / 64): the first
// position of every tile it walked, in order, -1 after. `splits` in {1, 2,
// 4, 8} overrides the split count; 0 keeps the kernel's own choice.
extern "C" int contig_decode_bf16_visit(const void* q, const void* k, const void* v,
                                        const void* lens, void* out, int B, int S_max, int Hq,
                                        int Hkv, int D, int window, int chunk, int order,
                                        int snake, float scale, void* stream, void* visit,
                                        int splits) {
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, q, k, v, lens, out, nullptr, static_cast<int*>(visit), B,
                              S_max, Hq, Hkv, D, window, chunk, order, snake, scale, splits,
                              &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(a, B, D, dev, static_cast<cudaStream_t>(stream)));
}

// contig_decode_bf16 that also writes each row's log-sum-exp into `lse` (B,
// Hq) float32 (kMaskValue for a row that sees nothing), through the kernel's
// kLse instantiation. `splits` as in contig_decode_bf16_visit.
extern "C" int contig_decode_bf16_lse(const void* q, const void* k, const void* v,
                                      const void* lens, void* out, int B, int S_max, int Hq,
                                      int Hkv, int D, int window, int chunk, int order, int snake,
                                      float scale, void* stream, void* lse, int splits) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, q, k, v, lens, out, static_cast<float*>(lse), nullptr, B,
                              S_max, Hq, Hkv, D, window, chunk, order, snake, scale, splits,
                              &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(a, B, D, dev, static_cast<cudaStream_t>(stream)));
}

namespace {

// The attributes of the launch at this shape (see contig_decode_attr), of
// the kLse instantiation or the other.
template <bool kLse>
int attr(int B, int S_max, int Hq, int Hkv, int D, int chunk, int* out) {
  Args a;
  int dev = 0;
  cudaError_t err = make_args(&a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              B, S_max, Hq, Hkv, D, -1, chunk, 0, 1, 1.f, 0, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  int smem = 0;
#define REPRO_ATTR(DD)                                                                  \
  switch (rows_of(a.G)) {                                                               \
    case 1: err = cudaFuncGetAttributes(&fa, contig_decode_kernel<DD, 1, kLse>);        \
            smem = (int)Layout<DD, 1>::kBytes; break;                                   \
    case 2: err = cudaFuncGetAttributes(&fa, contig_decode_kernel<DD, 2, kLse>);        \
            smem = (int)Layout<DD, 2>::kBytes; break;                                   \
    case 4: err = cudaFuncGetAttributes(&fa, contig_decode_kernel<DD, 4, kLse>);        \
            smem = (int)Layout<DD, 4>::kBytes; break;                                   \
    default: err = cudaFuncGetAttributes(&fa, contig_decode_kernel<DD, 8, kLse>);       \
             smem = (int)Layout<DD, 8>::kBytes; break;                                  \
  }
  if (D == 128) {
    REPRO_ATTR(128)
  } else if (D == 80) {
    REPRO_ATTR(80)
  } else if (D == 96) {
    REPRO_ATTR(96)
  } else {
    REPRO_ATTR(64)
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

}  // namespace

// The launch contig_decode_bf16 makes at this shape: out[0] registers a
// thread, out[1] dynamic shared memory bytes a CTA, out[2] threads a CTA,
// out[3] local (spill) bytes a thread, out[4] the split (cluster) size,
// out[5] CTAs in the grid. Returns a cudaError_t code.
extern "C" int contig_decode_attr(int B, int S_max, int Hq, int Hkv, int D, int chunk, int* out) {
  return attr<false>(B, S_max, Hq, Hkv, D, chunk, out);
}

// The same for contig_decode_bf16_lse's launch (the kLse instantiation).
extern "C" int contig_decode_lse_attr(int B, int S_max, int Hq, int Hkv, int D, int chunk,
                                      int* out) {
  return attr<true>(B, S_max, Hq, Hkv, D, chunk, out);
}
