// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a), CUDA C++.
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
// may underflow to 0 on the inter-chunk term, which is exact enough.
// Positions at or past S are masked inside the kernel (dt = 0 there: no
// update and no decay; their x, b, c are zero and their y is not stored),
// so the ragged last chunk needs no padded copy of the inputs.
//
// Grid: one block per (batch row, head), blockIdx.x = b * H + h. The TPU
// carries the state in VMEM across a sequential grid axis; nothing carries
// between blocks here, so each block walks its chunks in order in a loop,
// with the state (P x N f32: 32 KB at N 128, 16 KB at N 64) resident in
// shared memory. B and C are the same for all H heads of a batch row: with h
// the fastest index of blockIdx, the blocks of one row are resident at about
// the same time and read each B/C chunk from L2 after the first fetch. This
// is the SSD's counterpart of the revisit the sawtooth order exploits for
// attention, and of the TPU kernel's bh-fastest grid, whose BlockSpec elides
// H - 1 of the H fetches of a B/C chunk. (Computing C B^T once for all heads
// of a row is later work.)
//
// Design, per chunk, 8 warps (256 threads):
//   1. x (as f32), b, c (bf16) and dt of the chunk into shared memory;
//   2. warp 0: cum by a warp scan;
//   3. C B^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//      accumulate: exact products of the bf16 inputs, so nothing the
//      reference keeps is lost), warp w rows 16w.., then W in f32 in shared
//      memory (the upper right 64 x 64 block, all j > i, is skipped);
//   4. y: a 16 x 16 thread grid, 8 rows x 4 head dims a thread, float32
//      FMAs for (C S^T) and for W X, whose operands are float32;
//   5. x_j scaled by dt_j exp(cum_last - cum_j), then the state update by
//      float32 FMAs (a thread owns N / 16 x 4 entries of the state).
// Shared memory: x 32 KB, b and c (L x (N + 8)) 34 KB each at N 128, W (L x
// (L + 1)) 66 KB, the state 32 KB: 198 KB at N 128, 150 KB at N 64, one
// block per SM.
//
// What bounds it on this card: bytes. x, dt, b and c read once, y and the
// final state written once (a zero initial state is a null pointer and is
// not read) come to 44 MB at mamba2-130m's prefill group (8, 700, 24
// heads, N 128), 13 us at 3.35 TB/s, and 128 MB at zamba2-2.7b's (80
// heads, N 64), 38 us; their 5.6 and 10.9 GFLOP take 6 and 11 us at the
// dense bf16 tensor-core rate (989 TFLOP/s), which split-bf16 or 3xTF32
// products of float32 operands approach. What limits it today: the
// products whose operands are float32 (W X, C S^T, the state update: about
// 2 L P (L/2 + 2N) flops a head and chunk) run as plain float32 FMAs fed
// from shared memory, whose 67 TFLOP/s alone take 82 and 162 us; one block
// per (b, h) at one block per SM (8 warps an SM: little latency hiding, and
// B*H blocks in whole waves); C B^T recomputed by every head; and no
// overlap of the next chunk's loads with this chunk's compute (cp.async or
// TMA). Those are later work.

#include "flash_common.cuh"

namespace {

using namespace repro;

constexpr int kL = 128;  // positions per chunk
constexpr int kP = 64;   // head dim P
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Args {
  const uint16_t* x;   // (B, S, H, P) bf16
  const float* dt;     // (B, S, H)
  const float* a;      // (H,)
  const uint16_t* b;   // (B, S, N) bf16
  const uint16_t* c;   // (B, S, N) bf16
  const float* init;   // (B, H, P, N), or null for zeros
  uint16_t* y;         // (B, S, H, P) bf16
  float* final_state;  // (B, H, P, N)
  int S, H;
};

template <int N>
struct Smem {
  static constexpr int BS = N + 8;   // bf16 row stride of b, c: conflict-free mma fragments
  static constexpr int WS = kL + 1;  // f32 row stride of W: the two row groups of a warp
                                     // read different banks
  static constexpr size_t x_bytes = sizeof(float) * kL * kP;
  static constexpr size_t bc_bytes = sizeof(uint16_t) * kL * BS;  // each of b, c
  static constexpr size_t w_bytes = sizeof(float) * kL * WS;
  static constexpr size_t st_bytes = sizeof(float) * N * kP;
  static constexpr size_t vec_bytes = sizeof(float) * kL;         // each of dt, cum
  static constexpr size_t total = x_bytes + 2 * bc_bytes + w_bytes + st_bytes + 2 * vec_bytes;
  static_assert(bc_bytes % 16 == 0 && w_bytes % 16 == 0, "16-byte aligned regions");
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(Args p) {
  using Sm = Smem<N>;
  constexpr int BS = Sm::BS;
  constexpr int WS = Sm::WS;
  constexpr int NR = N / 16;  // state rows (n) a thread updates

  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);                       // [L][P]
  uint16_t* Bs = reinterpret_cast<uint16_t*>(smem + Sm::x_bytes);   // [L][BS]
  uint16_t* Cs = Bs + kL * BS;                                      // [L][BS]
  float* Ws = reinterpret_cast<float*>(smem + Sm::x_bytes + 2 * Sm::bc_bytes);  // [L][WS]
  float* St = Ws + kL * WS;   // the state, transposed: [N][P]
  float* dts = St + N * kP;   // [L]
  float* cums = dts + kL;     // [L]

  const int bh = blockIdx.x;  // b * H + h
  const int bi = bh / p.H;
  const int h = bh % p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = tid >> 4;    // 16 x 16 thread grid of the y and state tiles
  const int tx = tid & 15;
  const float a_h = p.a[h];
  const size_t state_off = (size_t)bh * kP * N;

  for (int e = tid; e < N * kP; e += kThreads) {
    const int pp = e / N, n = e % N;
    St[n * kP + pp] = p.init != nullptr ? p.init[state_off + e] : 0.f;
  }

  const int n_chunks = (p.S + kL - 1) / kL;
  for (int z = 0; z < n_chunks; ++z) {
    const int s0 = z * kL;
    const int valid = min(kL, p.S - s0);
    const size_t row0 = (size_t)bi * p.S + s0;  // (b, s0) as a row of (B*S, ...)

    // 1. The chunk's inputs; positions past S are zeros (dt = 0).
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < kL * (kP / 8); e += kThreads) {
      const int j = e / (kP / 8), ch = e % (kP / 8);
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < valid)
        unpack8(*reinterpret_cast<const uint4*>(p.x + ((row0 + j) * p.H + h) * kP + ch * 8), f);
      float4* dst = reinterpret_cast<float4*>(Xs + j * kP + ch * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    for (int e = tid; e < kL * (N / 8); e += kThreads) {
      const int j = e / (N / 8), ch = e % (N / 8);
      uint4 bw = make_uint4(0u, 0u, 0u, 0u);
      uint4 cw = bw;
      if (j < valid) {
        const size_t off = (row0 + j) * N + ch * 8;
        bw = *reinterpret_cast<const uint4*>(p.b + off);
        cw = *reinterpret_cast<const uint4*>(p.c + off);
      }
      *reinterpret_cast<uint4*>(Bs + j * BS + ch * 8) = bw;
      *reinterpret_cast<uint4*>(Cs + j * BS + ch * 8) = cw;
    }
    if (tid < kL) dts[tid] = tid < valid ? p.dt[(row0 + tid) * p.H + h] : 0.f;
    __syncthreads();

    // 2. cum = inclusive cumsum of dt * a: 4 positions a lane, then a warp scan.
    if (warp == 0) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += dts[lane * 4 + k] * a_h;
        v[k] = run;
      }
      float inc = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      const float base = inc - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cums[lane * 4 + k] = base + v[k];
    }
    __syncthreads();

    // 3. W = (C B^T) * tril exp(cum_i - cum_j) * dt_j; warp w owns rows 16w..16w+15.
    {
      const int g = lane >> 2, tig = lane & 3;
      const int r0 = warp * 16;
      for (int hc = 0; hc < 2; ++hc) {
        if (hc == 1 && r0 + 16 <= 64) continue;  // rows < 64 see no column >= 64
        float acc[8][4];
        mma_abt<N, BS>(acc, Cs, r0, Bs + hc * 64 * BS, g, tig);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + (e >> 1) * 8;
            const int j = hc * 64 + nt * 8 + tig * 2 + (e & 1);
            Ws[i * WS + j] = j <= i ? acc[nt][e] * expf(cums[i] - cums[j]) * dts[j] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 4. y_i = exp(cum_i) (S c_i) + sum_{j <= i} W_ij x_j: rows ty*8.., dims tx*4..
    {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int n = 0; n < N; n += 2) {
        const float4 sa = *reinterpret_cast<const float4*>(St + n * kP + tx * 4);
        const float4 sb = *reinterpret_cast<const float4*>(St + (n + 1) * kP + tx * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t cw = *reinterpret_cast<const uint32_t*>(Cs + (ty * 8 + r) * BS + n);
          const float c0 = bf16_lo(cw), c1 = bf16_hi(cw);
          acc[r][0] += c0 * sa.x + c1 * sb.x;
          acc[r][1] += c0 * sa.y + c1 * sb.y;
          acc[r][2] += c0 * sa.z + c1 * sb.z;
          acc[r][3] += c0 * sa.w + c1 * sb.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float ec = expf(cums[ty * 8 + r]);
        acc[r][0] *= ec; acc[r][1] *= ec; acc[r][2] *= ec; acc[r][3] *= ec;
      }
      const int jmax = min(ty * 8 + 8, valid);  // W_ij = 0 for j > i and for j >= valid
      for (int j = 0; j < jmax; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kP + tx * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float w = Ws[(ty * 8 + r) * WS + j];
          acc[r][0] += w * xv.x;
          acc[r][1] += w * xv.y;
          acc[r][2] += w * xv.z;
          acc[r][3] += w * xv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty * 8 + r;
        if (i < valid) {
          uint2 w;
          w.x = pack_bf16(acc[r][0], acc[r][1]);
          w.y = pack_bf16(acc[r][2], acc[r][3]);
          *reinterpret_cast<uint2*>(p.y + ((row0 + i) * p.H + h) * kP + tx * 4) = w;
        }
      }
    }
    __syncthreads();  // the state and x are rewritten below

    // 5. x_j <- dt_j exp(cum_last - cum_j) x_j, then S <- exp(cum_last) S + X^T B.
    const float cum_last = cums[kL - 1];  // = cum at the last valid position (dt = 0 after)
    for (int e = tid; e < kL * kP; e += kThreads) {
      const int j = e / kP;
      Xs[e] *= dts[j] * expf(cum_last - cums[j]);
    }
    __syncthreads();
    {
      float acc[NR][4];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int j = 0; j < valid; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kP + tx * 4);
        float bv[NR];
        const uint16_t* brow = Bs + j * BS + ty * NR;
        if constexpr (NR == 8) {
          unpack8(*reinterpret_cast<const uint4*>(brow), bv);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(brow);
          bv[0] = bf16_lo(w.x); bv[1] = bf16_hi(w.x);
          bv[2] = bf16_lo(w.y); bv[3] = bf16_hi(w.y);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          acc[r][0] += bv[r] * xv.x;
          acc[r][1] += bv[r] * xv.y;
          acc[r][2] += bv[r] * xv.z;
          acc[r][3] += bv[r] * xv.w;
        }
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float4* sp = reinterpret_cast<float4*>(St + (ty * NR + r) * kP + tx * 4);
        float4 s = *sp;
        s.x = decay * s.x + acc[r][0];
        s.y = decay * s.y + acc[r][1];
        s.z = decay * s.z + acc[r][2];
        s.w = decay * s.w + acc[r][3];
        *sp = s;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * kP; e += kThreads) {
    const int pp = e / N, n = e % N;
    p.final_state[state_off + e] = St[n * kP + pp];
  }
}

template <int N>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using Sm = Smem<N>;
  auto kernel = ssd_kernel<N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::total);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.H, kThreads, Sm::total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code, 0 on
// a successful launch; cudaErrorInvalidValue for a head dim other than 64 or
// a state dim other than 64 and 128. `init` may be null (zeros). S >= 1. No
// synchronisation: the kernel runs on `stream`.
extern "C" int ssd_fwd_bf16(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* init, void* y, void* final_state, int B,
                            int S, int H, int P, int N, void* stream) {
  if (P != kP || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.x = static_cast<const uint16_t*>(x);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const uint16_t*>(b);
  args.c = static_cast<const uint16_t*>(c);
  args.init = static_cast<const float*>(init);
  args.y = static_cast<uint16_t*>(y);
  args.final_state = static_cast<float*>(final_state);
  args.S = S;
  args.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 128) return static_cast<int>(launch<128>(args, B, st));
  if (N == 64) return static_cast<int>(launch<64>(args, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
