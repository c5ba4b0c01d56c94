"""Analytic cache-traffic models from the paper (§3.2–§3.4).

A port of ``repro.core.cache_model``. The formulas keep (S, D, E, C, T)
symbolic, so one code serves the paper's chip (``GB10``: C = 32 B sectors,
E = 2 fp16, D = 64, T = 80/64) and the port's card (``H100``, or
:func:`device_hw_config` read from the card itself).

The model counts *accesses* (demand traffic into the shared cache level) and
*cold (compulsory) misses*; the LRU simulator (``cache_sim``) provides the
non-compulsory miss counts that depend on traversal order.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "HWConfig",
    "GB10",
    "H100",
    "device_hw_config",
    "AttentionWorkload",
    "sectors_per_tile",
    "l2_sector_accesses",
    "l2_sector_accesses_simple",
    "cold_miss_sectors",
    "kv_bytes",
    "l2_hit_rate_wavefront",
    "attention_flops",
    "gb10_throughput_model",
    "calibrate_miss_service",
    "divergence_seq_len",
]


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """The cache/memory level the model targets."""

    name: str
    sector_bytes: int          # C — granularity of the cache level
    cache_bytes: int           # capacity of the shared level (the L2)
    mem_bandwidth: float       # bytes/s behind the cache (LPDDR / HBM)
    peak_flops: float          # per-device peak (fp16/bf16 MACs*2)
    n_workers: int             # SMs (persistent workers)


# GB10: 48 SMs, 24 MiB L2, ~600 GB/s aggregate LPDDR5X (paper §2.1).
# Peak fp16 tensor throughput for GB10 is not published precisely; the paper's
# CUDA kernel reaches 2.4 TFLOPS and the CuTile one 69 TFLOPS. We use 100e12
# as a nominal dense fp16 peak for the bottleneck model; only *ratios* between
# cyclic/sawtooth matter for the reproduction.
GB10 = HWConfig(
    name="gb10",
    sector_bytes=32,
    cache_bytes=24 * 2**20,
    mem_bandwidth=600e9,
    peak_flops=100e12,
    n_workers=48,
)

# NVIDIA H100 SXM (Hopper): 132 SMs, 50 MiB L2 of 32-byte sectors, 3.35 TB/s
# of HBM3 and 989 TFLOP/s of dense bf16 (data sheet). The L2 is split in two
# halves; the models see one shared level of the whole size.
H100 = HWConfig(
    name="h100",
    sector_bytes=32,
    cache_bytes=50 * 2**20,
    mem_bandwidth=3.35e12,
    peak_flops=989e12,
    n_workers=132,
)


def device_hw_config(device=None, *, base: HWConfig = H100) -> HWConfig:
    """``base`` with the name, SM count and L2 size that
    ``torch.cuda.get_device_properties`` reports for ``device`` (default the
    current CUDA device); the rates stay the data sheet's."""
    import torch

    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device
    )
    return dataclasses.replace(
        base, name=props.name, cache_bytes=int(props.L2_cache_size),
        n_workers=int(props.multi_processor_count),
    )


@dataclasses.dataclass(frozen=True)
class AttentionWorkload:
    """One flash-attention forward problem (single head unless stated)."""

    seq_len: int               # S
    head_dim: int = 64         # D
    elem_bytes: int = 2        # E (fp16/bf16)
    tile: int = 80             # T (square tiling, B_r == B_c, paper §2.2)
    batch: int = 1
    heads: int = 1
    causal: bool = False

    @property
    def n_tiles(self) -> int:
        return self.seq_len // self.tile  # paper uses floor(S/T)

    def scale(self) -> int:
        """batch*heads scales the problem linearly (paper §3.2)."""
        return self.batch * self.heads


def sectors_per_tile(w: AttentionWorkload, hw: HWConfig) -> float:
    """T*D*E/C — sectors in one (T × D) tile."""
    return w.tile * w.head_dim * w.elem_bytes / hw.sector_bytes


def l2_sector_accesses(w: AttentionWorkload, hw: HWConfig) -> float:
    """Exact tiled count of demand sectors into the shared level.

    Q and O tiles are touched once each; K and V tiles once per Q tile
    (non-causal) or only up to the diagonal (causal). Matches paper §3.2
    including the floor-division tile count.
    """
    spt = sectors_per_tile(w, hw)
    n = w.n_tiles
    qo = 2.0 * spt * n
    if w.causal:
        # sum_{i=1..n} i  = n(n+1)/2 KV tile visits; the paper's closed form
        # uses S(S-1)/(2T) ~ n^2/2 — we keep the exact tiled sum here.
        kv_visits = n * (n + 1) / 2.0
    else:
        kv_visits = float(n) * n
    kv = 2.0 * spt * kv_visits
    return w.scale() * (qo + kv)


def l2_sector_accesses_simple(w: AttentionWorkload, hw: HWConfig) -> float:
    """Paper's closed forms (direct-division approximations).

    non-causal: M = 2(S·D·E/C + S²·D·E/(T·C))
    causal:     M = 2(S·D·E/C + S(S−1)·D·E/(2·T·C))
                  ≈ 8S(S/2T + 1/2) for C=32,E=2,D=64
    """
    s, d, e, c, t = w.seq_len, w.head_dim, w.elem_bytes, hw.sector_bytes, w.tile
    if w.causal:
        m = 2.0 * (s * d * e / c + s * (s - 1) * d * e / (2.0 * t * c))
    else:
        m = 2.0 * (s * d * e / c + s * s * d * e / (t * c))
    return w.scale() * m


def cold_miss_sectors(w: AttentionWorkload, hw: HWConfig) -> float:
    """Compulsory misses: each of Q,K,V,O is loaded at least once.

    4·S·D·E/C — "16S with our configuration" (paper §3.3).
    """
    return w.scale() * 4.0 * w.seq_len * w.head_dim * w.elem_bytes / hw.sector_bytes


def kv_bytes(w: AttentionWorkload) -> int:
    """Size of the streamed KV working set (drives the §3.3 threshold)."""
    return w.scale() * 2 * w.seq_len * w.head_dim * w.elem_bytes


def l2_hit_rate_wavefront(n_workers: int) -> float:
    """Paper §3.4: synchronized wavefronts give hit rate ≈ 1 − 1/N_SM."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    return 1.0 - 1.0 / n_workers


def attention_flops(w: AttentionWorkload) -> float:
    """Matmul FLOPs of the fused forward: 2 GEMMs of 2·S·S·D each.

    Causal halves the score region. Softmax FLOPs are O(S²) and ignored,
    consistent with how the paper reports TFLOPS.
    """
    full = 4.0 * w.seq_len * w.seq_len * w.head_dim
    if w.causal:
        full *= 0.5
    return w.scale() * full


def gb10_throughput_model(
    w: AttentionWorkload,
    hw: HWConfig,
    miss_sectors: float,
    *,
    miss_service_s: float,
    kernel_peak: float | None = None,
) -> float:
    """Additive stall model used to reproduce Fig 7/10/12.

        t = t_compute + misses · miss_service_s,   throughput = FLOPs / t

    Rationale (napkin math in EXPERIMENTS.md §Paper-validation): at the
    paper's CUDA operating point, pure DRAM *bandwidth* for the measured
    miss traffic would cost ~0.2 s while the observed time is ~27 s — the
    kernel is miss-*latency* (stall) bound, so time scales ~linearly in the
    miss count, which is exactly why halving misses nearly doubles
    throughput (1.3→2.4 TFLOPS). The CuTile kernel runs near its compute
    ceiling, so the same model with its calibrated (much smaller) exposed
    miss-service time yields the paper's ~13% non-causal gain.

    ``miss_service_s`` is calibrated once on the *cyclic baseline* via
    :func:`calibrate_miss_service`; sawtooth numbers are then predictions.
    """
    flops = attention_flops(w)
    t_compute = flops / (kernel_peak or hw.peak_flops)
    t = t_compute + miss_sectors * miss_service_s
    return flops / t


def calibrate_miss_service(
    w: AttentionWorkload,
    hw: HWConfig,
    *,
    observed_flops: float,
    miss_sectors: float,
    kernel_peak: float | None = None,
) -> float:
    """Solve the additive model for the exposed per-miss service time given
    one observed (baseline) throughput."""
    flops = attention_flops(w)
    t_total = flops / observed_flops
    t_compute = flops / (kernel_peak or hw.peak_flops)
    return max(t_total - t_compute, 0.0) / max(miss_sectors, 1.0)


def divergence_seq_len(hw: HWConfig, w: AttentionWorkload) -> int:
    """Sequence length where KV working set reaches cache capacity (§3.3).

    Paper: divergence at S ≈ 80K on GB10 (KV = 20 MiB vs 24 MiB L2).
    """
    per_token = w.scale() * 2 * w.head_dim * w.elem_bytes
    return int(hw.cache_bytes // per_token)
