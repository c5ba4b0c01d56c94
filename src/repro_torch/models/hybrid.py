"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention block
applied every ``shared_attn_every`` layers (arXiv:2411.15242).

A port of ``repro.models.hybrid``. The shared block takes concat(hidden,
initial embedding) through a down projection (the Zamba concat trick), runs
GQA attention and a SwiGLU FFN with the same parameters at every
application site, and adds back to the residual stream. The per-site LoRA
deltas of the paper are omitted, as in the reference.

Params: ``{"mamba": [[layer] * every] * groups, "shared": {...}}``, the
reference's stacked ``(groups, every, ...)`` leaves as nested lists of
per-layer dicts. Each application site keeps its own contiguous KV cache;
the caches of all sites are allocated once (``init_cache(...,
n_layers=groups)``) and the Mamba states of all layers once, both written in
place. Each group's output passes ``constrain(h, "residual")``, as in the
reference: a no-op outside an activation-rules context.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import cache_layout, constrain, write_local
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T

__all__ = [
    "hybrid_init",
    "hybrid_apply",
    "hybrid_prefill",
    "hybrid_decode",
    "hybrid_init_caches",
    "n_groups",
]


def n_groups(cfg: ModelConfig) -> int:
    every = cfg.ssm.shared_attn_every
    assert every > 0 and cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "ln": L.rmsnorm_init(cfg.d_model, cfg.parameter_dtype(), gen.device),
        "mamba": ssm.mamba_init(gen, cfg),
    }


def hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.parameter_dtype()
    g, e = n_groups(cfg), cfg.ssm.shared_attn_every
    mamba = [[_mamba_layer_init(gen, cfg) for _ in range(e)] for _ in range(g)]
    shared = {
        "proj_in": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype=pd),
        "ln_attn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "attn": T.attn_init(gen, cfg),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "ffn": T.ffn_init(gen, cfg),
    }
    return {"mamba": mamba, "shared": shared}


def _proj_in(shared: dict, cfg: ModelConfig, h: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    return L.dense(shared["proj_in"], torch.cat([h, h0], dim=-1), dtype=cfg.activation_dtype())


def _shared_block(shared: dict, cfg: ModelConfig, h, h0, positions):
    zin = _proj_in(shared, cfg, h, h0)
    a = T.attn_apply(shared["attn"], cfg, L.rmsnorm(shared["ln_attn"], zin, cfg.norm_eps),
                     positions=positions)
    z = zin + a
    f = T.ffn_apply(shared["ffn"], cfg, L.rmsnorm(shared["ln_ffn"], z, cfg.norm_eps))
    return h + (z + f - zin)  # residual contribution of the shared block


def hybrid_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """The training forward: each group (its Mamba layers, then the shared
    block) under ``remat_wrap``. Returns (hidden (B, S, d), aux 0)."""
    shared = params["shared"]
    h0 = x

    def group(h, gp):
        for lp in gp:
            h = h + ssm.mamba_apply(lp["mamba"], cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps))
        return constrain(_shared_block(shared, cfg, h, h0, positions), "residual")

    h = x
    for gp in params["mamba"]:
        h = T.remat_wrap(lambda h_, gp=gp: group(h_, gp), cfg)(h)
    return h, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device="cpu", mesh=None,
                       pcfg=None) -> dict:
    """Zero caches: ``mamba`` states (groups, every, B, ...), the sites'
    contiguous KV caches ``attn`` (groups, B, S, Hkv, hd) and ``len`` 0 (a
    0-d int32 tensor); with ``mesh`` and ``pcfg`` placed by
    ``dist.sharding.cache_shardings``."""
    g, e = n_groups(cfg), cfg.ssm.shared_attn_every
    place = dict(mesh=mesh, pcfg=pcfg)
    return {
        "mamba": ssm.mamba_init_state(cfg, batch, device=device, lead=(g, e), **place),
        "attn": T.init_cache(cfg, batch, max_len, device=device, n_layers=g, **place),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _layer_state(mamba: dict, gi: int, ei: int) -> dict:
    return {name: t[gi, ei] for name, t in mamba.items()}


def hybrid_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                   max_len: int):
    """Forward over the whole prompt x (B, S, d), filling every Mamba state
    and every site's KV cache of ``max_len`` positions. Returns (hidden,
    caches)."""
    shared = params["shared"]
    h0 = x
    caches = hybrid_init_caches(cfg, x.shape[0], max_len, device=x.device, **cache_layout())
    h = x
    for gi, gp in enumerate(params["mamba"]):
        for ei, lp in enumerate(gp):
            out, st = ssm.mamba_prefill(lp["mamba"], cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps))
            h = h + out
            for name, t in _layer_state(caches["mamba"], gi, ei).items():
                write_local(t, st[name])
        zin = _proj_in(shared, cfg, h, h0)
        a, (k, v) = T.attn_apply(shared["attn"], cfg,
                                 L.rmsnorm(shared["ln_attn"], zin, cfg.norm_eps),
                                 positions=positions, return_kv=True)
        z = zin + a
        f = T.ffn_apply(shared["ffn"], cfg, L.rmsnorm(shared["ln_ffn"], z, cfg.norm_eps))
        h = h + (z + f - zin)
        filled = T.fill_cache(cfg, T._layer_cache(caches["attn"], gi), k, v)
    caches["attn"]["len"] = filled["len"]
    caches["len"] = filled["len"]
    return h, caches


def hybrid_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, caches: dict):
    """One decode step, x (B, 1, d), every state and cache written in place;
    ``len`` advances by one."""
    shared = params["shared"]
    h0 = x
    pos = caches["len"]
    attn = T.decode_view(cfg, dict(caches["attn"], len=pos), x.shape[0], 1)  # shared by the sites
    h = x
    for gi, gp in enumerate(params["mamba"]):
        for ei, lp in enumerate(gp):
            out, _ = ssm.mamba_decode(lp["mamba"], cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
                                      _layer_state(caches["mamba"], gi, ei))
            h = h + out
        zin = _proj_in(shared, cfg, h, h0)
        a, lc = T.attn_decode(shared["attn"], cfg,
                              L.rmsnorm(shared["ln_attn"], zin, cfg.norm_eps),
                              T._layer_cache(attn, gi))
        z = zin + a
        f = T.ffn_apply(shared["ffn"], cfg, L.rmsnorm(shared["ln_ffn"], z, cfg.norm_eps))
        h = h + (z + f - zin)
    new = dict(caches, attn=dict(caches["attn"], len=lc["len"]), len=pos + 1)
    return h, new
