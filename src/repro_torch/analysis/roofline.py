"""Roofline terms per (arch × shape × mesh) from dry-run records.

A port of ``repro.analysis.roofline``, over the port's configs and the
H100's constants (``analysis.constants``):

  compute term    = flops(per rank) / peak FLOP/s
  memory term     = bytes accessed(per rank) / HBM bandwidth
  collective term = collective bytes(per rank) / NVLink bandwidth

The dry-run's counts come from a trace of one rank's local ops
(``analysis.trace``), so they are per rank, as the reference's
per-partition ``cost_analysis()``: no extra division by the rank count.
The "useful compute" ratio compares 6·N_active·D model FLOPs against the
global traced FLOPs (ranks × per rank) — it exposes remat recompute,
capacity overcounting (MoE), and padding waste. The parameter and FLOP
counts are the reference's arithmetic, exactly.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis import constants as C
from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["RooflineTerms", "analyze", "param_count", "active_param_count", "model_flops"]


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float
    step_s: float              # max of the three terms (no-overlap bound)
    hw_flops_util: float       # model_flops / (chips * peak * step_s)

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    coll: dict,
    cfg: ModelConfig,
    shape_cfg: ShapeConfig,
) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0.0))
    t_c = flops / C.PEAK_FLOPS_BF16
    t_m = byts / C.HBM_BW
    t_x = cb / C.NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_cfg)
    global_flops = flops * chips
    useful = mf / global_flops if global_flops else 0.0
    step_s = max(t_c, t_m, t_x)
    util = mf / (chips * C.PEAK_FLOPS_BF16 * step_s) if step_s else 0.0
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes_per_device=cb,
        compute_s=t_c,
        memory_s=t_m,
        collective_s=t_x,
        bottleneck=bottleneck,
        model_flops_global=mf,
        useful_ratio=useful,
        step_s=step_s,
        hw_flops_util=util,
    )


# --------------------------------------------------------------------------
# analytic parameter / FLOP counts
# --------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.hd
    p = cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * cfg.d_model
    if cfg.qkv_bias:
        p += hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
    return p


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff


def _mamba_params(cfg: ModelConfig) -> int:
    m = cfg.ssm
    di = m.expand * cfg.d_model
    n = m.state_dim
    h = di // m.head_dim
    return (
        cfg.d_model * (2 * di + 2 * n + h)
        + m.conv_width * (di + 2 * n)
        + di * cfg.d_model
        + di
        + 3 * h
    )


def param_count(cfg: ModelConfig, *, active_only: bool = False) -> int:
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "vlm"):
        per = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        total = cfg.n_layers * per + emb
        if cfg.family == "vlm":
            total += cfg.d_model * cfg.d_model
        return total
    if cfg.family == "moe":
        e = cfg.moe.num_experts if not active_only else cfg.moe.top_k
        per = (
            _attn_params(cfg)
            + e * 3 * cfg.d_model * cfg.moe.d_ff_expert
            + cfg.d_model * cfg.moe.num_experts
        )
        return cfg.n_layers * per + emb
    if cfg.family == "ssm":
        return cfg.n_layers * _mamba_params(cfg) + emb
    if cfg.family == "hybrid":
        shared = (
            2 * cfg.d_model * cfg.d_model
            + _attn_params(cfg)
            + _ffn_params(cfg, cfg.d_ff)
        )
        return cfg.n_layers * _mamba_params(cfg) + shared + emb
    if cfg.family == "encdec":
        enc = cfg.n_encoder_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        dec = cfg.n_layers * (2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        return enc + dec + emb
    raise ValueError(cfg.family)


def active_param_count(cfg: ModelConfig) -> int:
    return param_count(cfg, active_only=True)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for train, 2·N_active·D for prefill/decode forward."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch
