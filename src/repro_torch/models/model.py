"""Family dispatch: one ``LM`` object per architecture config.

  lm = build_model(cfg, device="cuda")
  params           = lm.init(seed)
  logits, caches   = lm.decode_step(params, tokens, caches)

The port serves the dense decoder-only family through the paged ragged
chunk step (``decode_step``). Other families, ``LM.prefill`` and
``LM.loss`` are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["LM", "build_model"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
_PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    decode_step: Callable


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"].to(cfg.activation_dtype())[tokens.long()]


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = h @ params["embed"]["table"].to(cfg.activation_dtype()).T
    else:
        out = L.dense(params["lm_head"], h, dtype=cfg.activation_dtype())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out


def _build_decoder_only(cfg: ModelConfig, device: torch.device) -> LM:
    def init(seed=0) -> dict:
        """Random params on ``device`` at the reference's scales, drawn from
        ``seed`` (an int or a ``torch.Generator`` on ``device``)."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        pd = cfg.parameter_dtype()
        p = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, pd)}
        if not cfg.tie_embeddings:
            p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype=pd)
        p["layers"] = T.stack_init(gen, cfg, cfg.n_layers)
        p["ln_f"] = L.rmsnorm_init(cfg.d_model, pd, device)
        return p

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, caches: dict):
        """Ragged chunk step: tokens (B, C) -> logits (B, C, vocab), with
        the paged caches written in place (see ``T.stack_decode``)."""
        x = _embed_tokens(params, cfg, tokens)
        h, caches = T.stack_decode(params["layers"], cfg, x, caches)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _logits(params, cfg, h), caches

    return LM(cfg, device, init, decode_step)


def build_model(cfg: ModelConfig, device="cuda") -> LM:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of {FAMILIES}")
    if cfg.family not in _PORTED_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP §A13); the port "
            f"serves {_PORTED_FAMILIES}"
        )
    return _build_decoder_only(cfg, resolve_device(device))
