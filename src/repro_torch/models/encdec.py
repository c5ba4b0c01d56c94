"""Encoder-decoder backbone (seamless-m4t style: speech/text encoder ->
text decoder).

A port of ``repro.models.encdec``. The modality frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings ``src_embeds``
(B, S_src, d). The encoder is the decoder stack's layer run non-causally
(``T.stack_apply(..., causal=False)``); the decoder is a causal stack with a
cross-attention into the encoder's output in every layer.

Layers are lists of per-layer dicts (``"encoder"``, ``"decoder"``), as
elsewhere in the port. Caches, made by :func:`encdec_prefill`:

  * ``"self"``: the decoder's contiguous KV caches, one allocation for the
    stack (``T.init_cache`` with ``n_layers``), written in place by
    :func:`encdec_decode`, and their shared ``len`` (a 0-d int32 tensor);
  * ``"cross"``: the encoder's K/V as every decoder layer projects them,
    ``k``/``v`` (L, B, R, Hkv, hd) with R = max(``max_len``, S_src), unroped,
    zero past row S_src and never written after the prefill, and
    ``kv_len`` = S_src (a 0-d int32 tensor; the reference keeps the same
    scalar per layer, and its K/V hold the S_src rows alone). The decode
    reads the length from the tensor only, so every source up to
    ``max_len`` gives caches of one shape (the static engine's one
    captured decode step serves every bucket).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import cache_layout, constrain, grad_placed_like, write_local
from repro_torch.dist.sharding import distribute_caches
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = [
    "encdec_init",
    "encode",
    "decode_train",
    "encdec_prefill",
    "encdec_decode",
]


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.parameter_dtype()
    return {
        "ln_self": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "self_attn": T.attn_init(gen, cfg),
        "ln_cross": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "cross_attn": T.attn_init(gen, cfg),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "ffn": T.ffn_init(gen, cfg),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``{"encoder": n_encoder_layers layer dicts, "decoder": n_layers}``."""
    return {
        "encoder": T.stack_init(gen, cfg, cfg.n_encoder_layers),
        "decoder": [_dec_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
    }


def _arange(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def encode(params: dict, cfg: ModelConfig, src_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder's output (B, S_src, d): every encoder layer, non-causal,
    each under ``remat_wrap``; no final norm (as in the reference)."""
    h, _ = T.stack_apply(params["encoder"], cfg, src_embeds,
                         _arange(src_embeds.shape[1], src_embeds.device), causal=False)
    return h


def _dec_layer(lp: dict, cfg: ModelConfig, h, enc_out, positions, enc_positions):
    a = T.attn_apply(lp["self_attn"], cfg, L.rmsnorm(lp["ln_self"], h, cfg.norm_eps),
                     positions=positions, causal=True)
    h = h + a
    c = T.attn_apply(lp["cross_attn"], cfg, L.rmsnorm(lp["ln_cross"], h, cfg.norm_eps),
                     positions=positions, kv_src=enc_out, kv_positions=enc_positions,
                     causal=False, use_rope=False)
    h = h + c
    f = T.ffn_apply(lp["ffn"], cfg, L.rmsnorm(lp["ln_ffn"], h, cfg.norm_eps))
    return h + f


def decode_train(params: dict, cfg: ModelConfig, tgt_embeds: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder's training forward over the teacher-forced target
    embeddings (B, S, d), each layer under ``remat_wrap``."""
    positions = _arange(tgt_embeds.shape[1], tgt_embeds.device)
    enc_positions = _arange(enc_out.shape[1], enc_out.device)
    # on a mesh the encoder's output gradient (partial sums from every cross
    # K/V product) is reduced once, before the encoder's layers, as a norm's
    # input gradient is (``L.rmsnorm``); a no-op off a mesh
    enc_out = grad_placed_like(enc_out)
    h = tgt_embeds
    for lp in params["decoder"]:
        body = T.remat_wrap(
            lambda h_, e_, lp=lp: constrain(_dec_layer(lp, cfg, h_, e_, positions,
                                                       enc_positions), "residual"), cfg)
        h = body(h, enc_out)
    return h


def encdec_prefill(params: dict, cfg: ModelConfig, tgt_embeds: torch.Tensor,
                   enc_out: torch.Tensor, max_len: int):
    """Teacher-forced pass over the target prefix (B, S, d), filling the
    self caches of ``max_len`` positions and the cross caches of
    max(``max_len``, S_src) rows (see the module docstring). The cross K/V are the cross-attention's own k, v
    (``return_kv``): computed once from ``enc_out`` a layer. Returns
    (hidden (B, S, d), caches)."""
    b, s, _ = tgt_embeds.shape
    skv = enc_out.shape[1]
    dev = tgt_embeds.device
    positions = _arange(s, dev)
    enc_positions = _arange(skv, dev)
    layers = params["decoder"]
    place = cache_layout()
    self_caches = T.init_cache(cfg, b, max_len, device=dev, n_layers=len(layers), **place)
    shape = (len(layers), b, max(max_len, skv), cfg.n_kv_heads, cfg.hd)
    if place:  # each rank's shard only (an expanded zero is never made whole)
        zero = torch.zeros((), dtype=cfg.activation_dtype(), device=dev).expand(shape)
        cross = distribute_caches({"k": zero, "v": zero}, place["pcfg"], place["mesh"])
    else:
        cross = {n: torch.zeros(shape, dtype=cfg.activation_dtype(), device=dev)
                 for n in ("k", "v")}
    cross["kv_len"] = torch.full((), skv, dtype=torch.int32, device=dev)
    h = tgt_embeds
    for i, lp in enumerate(layers):
        a, (k, v) = T.attn_apply(lp["self_attn"], cfg, L.rmsnorm(lp["ln_self"], h, cfg.norm_eps),
                                 positions=positions, causal=True, return_kv=True)
        h = h + a
        c, (ck, cv) = T.attn_apply(lp["cross_attn"], cfg,
                                   L.rmsnorm(lp["ln_cross"], h, cfg.norm_eps),
                                   positions=positions, kv_src=enc_out,
                                   kv_positions=enc_positions, causal=False, use_rope=False,
                                   return_kv=True)
        h = h + c
        h = h + T.ffn_apply(lp["ffn"], cfg, L.rmsnorm(lp["ln_ffn"], h, cfg.norm_eps))
        filled = T.fill_cache(cfg, T._layer_cache(self_caches, i), k, v)
        rows = torch.arange(skv, device=dev)
        write_local(cross["k"][i], ck, rows)
        write_local(cross["v"][i], cv, rows)
    self_caches["len"] = filled["len"]
    return h, {"self": self_caches, "cross": cross}


def encdec_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, caches: dict):
    """One decode step, x (B, 1, d): each layer's self-attention against its
    cache (written in place; ``len`` advances by one) and its
    cross-attention against the static encoder K/V. Returns (hidden,
    caches)."""
    step = T.decode_view(cfg, caches["self"], x.shape[0], 1)
    cross = caches["cross"]
    h = x
    lc = step
    for i, lp in enumerate(params["decoder"]):
        a, lc = T.attn_decode(lp["self_attn"], cfg, L.rmsnorm(lp["ln_self"], h, cfg.norm_eps),
                              T._layer_cache(step, i))
        h = h + a
        c, _ = T.attn_decode(lp["cross_attn"], cfg, L.rmsnorm(lp["ln_cross"], h, cfg.norm_eps),
                             {"k": cross["k"][i], "v": cross["v"][i],
                              "kv_len": cross["kv_len"]}, cross=True)
        h = h + c
        h = h + T.ffn_apply(lp["ffn"], cfg, L.rmsnorm(lp["ln_ffn"], h, cfg.norm_eps))
    return h, dict(caches, self=dict(caches["self"], len=lc["len"]))
