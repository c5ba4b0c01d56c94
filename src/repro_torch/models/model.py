"""Family dispatch: one ``LM`` object per architecture config.

  lm = build_model(cfg, device="cuda")
  params           = lm.init(seed)
  loss, metrics    = lm.loss(params, batch)
  logits, caches   = lm.prefill(params, batch, max_len)
  logits, caches   = lm.decode_step(params, tokens, caches)
  batch            = lm.input_specs(shape, reduced=False, device=None)

Batches, as the reference's; ``input_specs`` makes one of a
``configs.ShapeConfig`` with ``torch.empty`` (under ``FakeTensorMode``,
fake tensors: the counterpart of the reference's ``ShapeDtypeStruct``s):

  dense/moe/ssm/hybrid: ``{"tokens": (B, S) int32}``
  vlm:    ``{"tokens": (B, S - P) int32, "prefix_embeds": (B, P, d)}``, P =
          ``min(n_prefix_embeds, max(S // 4, 1))`` in training (the serve
          engine feeds min(n_prefix_embeds, 8) zero embeddings)
  encdec: ``{"src_embeds": (B, S_src, d), "tgt_tokens": (B, S) int32}``

The port trains and serves every family of the reference. Dense and MoE:
``loss`` is the next-token cross-entropy of the training step
(differentiable, with the layers under the config's rematerialization);
``prefill`` (the static serve path) builds contiguous caches, or paged ones
when ``cfg.kv_layout`` is ``"paged"``; ``decode_step`` is the single-token
step over contiguous caches or the ragged chunk step over a paged pool.
The MoE family (``models.moe``) swaps the FFN, as the reference's
``_ffn_fn_for``: ``loss`` runs the capacity path and adds its auxiliary
losses; ``prefill`` and ``decode_step`` run the dropless grouped-product
path where ``cfg.moe_serve_dropless`` is set (the default), the capacity
path otherwise, and drop the aux. The VLM is the dense decoder with a
``vision_proj`` of its prefix embeddings, which go before the tokens
(their positions padded with token 0 and masked out of the loss).

The SSM (Mamba-2) and hybrid (Zamba2) families: ``prefill`` returns
``{"mamba": {"conv", "ssd"}, "len"}`` with the states of all layers stacked
on a leading axis (hybrid: ``(groups, every)``, plus the shared block's
contiguous KV caches ``attn``, one per application site), and
``decode_step`` is the exact recurrent step, writing the states in place.
The enc-dec family (``models.encdec``): ``prefill`` encodes the source and
returns ``{"self", "cross"}`` caches, ``decode_step`` attends both. Every
``len`` is a 0-d int32 tensor on the device, so no decode step reads a
host value (the serve engine captures it as a CUDA graph).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.dist.context import (cache_layout, constrain, placed_like, seq_gathered,
                                      write_local)
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

__all__ = ["LM", "build_model"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    input_specs: Callable


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # ``embedding`` rather than indexing, and on a mesh the table as the
    # ``embed_table`` rule places it (whole): DTensor's ``index_put`` (the
    # indexing's backward) and its masked vocab-parallel lookup fail on some
    # torch versions.
    table = constrain(params["embed"]["table"], "embed_table")
    return torch.nn.functional.embedding(tokens.long(), table.to(cfg.activation_dtype()))


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = seq_gathered(h)  # the head is a column-parallel product (a no-op off a mesh)
    if cfg.tie_embeddings:
        out = h @ params["embed"]["table"].to(cfg.activation_dtype()).T
    else:
        out = L.dense(params["lm_head"], h, dtype=cfg.activation_dtype())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out


def _lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor, h: torch.Tensor, *, mask=None,
             aux=0.0, z_loss: float = 1e-4):
    """Next-token cross-entropy of h (B, S, d) against tokens (B, S). As in
    the reference, ``LM.loss`` calls it with this default ``z_loss``, not
    ``TrainConfig.z_loss``."""
    logits = constrain(_logits(params, cfg, h[:, :-1]), "logits")
    labels = tokens[:, 1:]
    m = None if mask is None else mask[:, 1:]
    loss, metrics = L.cross_entropy(logits, labels, m, z_loss=z_loss)
    loss = loss + aux
    metrics["aux_loss"] = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    metrics["total_loss"] = loss
    return loss, metrics


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _generator(seed, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _input_specs_fn(cfg: ModelConfig, model_device: torch.device):
    """``input_specs(shape, reduced=False, device=None)``: the batch of
    ``shape`` (its ``.reduced()`` form, with the config's, when ``reduced``)
    as ``torch.empty`` tensors on ``device`` (default the model's), built
    by the reference's rules for the family."""
    def input_specs(shape: ShapeConfig, reduced: bool = False, device=None) -> dict:
        c = cfg.reduced() if reduced else cfg
        sh = shape.reduced() if reduced else shape
        b, s = sh.global_batch, sh.seq_len
        dev = model_device if device is None else torch.device(device)
        if c.family == "vlm":
            p = min(c.n_prefix_embeds, max(s // 4, 1))
            return {"tokens": torch.empty((b, s - p), dtype=torch.int32, device=dev),
                    "prefix_embeds": torch.empty((b, p, c.d_model), dtype=c.activation_dtype(),
                                                 device=dev)}
        if c.family == "encdec":
            return {"src_embeds": torch.empty((b, s, c.d_model), dtype=c.activation_dtype(),
                                              device=dev),
                    "tgt_tokens": torch.empty((b, s), dtype=torch.int32, device=dev)}
        return {"tokens": torch.empty((b, s), dtype=torch.int32, device=dev)}

    return input_specs


def _head_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.parameter_dtype()
    p = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, pd)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype=pd)
    return p


def _ffn_fn_for(cfg: ModelConfig, *, serve: bool = False):
    """The FFN ``T.stack_*`` take: None (the dense SwiGLU) or the MoE's,
    dropless when serving with ``cfg.moe_serve_dropless``."""
    if cfg.moe is None:
        return None
    dropless = serve and cfg.moe_serve_dropless
    return lambda p, c, h: MOE.moe_apply(p, c, h, dropless=dropless)


def _ffn_init_for(cfg: ModelConfig):
    if cfg.moe is None:
        return None
    return lambda gen: MOE.moe_init(gen, cfg)


def _build_decoder_only(cfg: ModelConfig, device: torch.device) -> LM:
    ffn_fn = _ffn_fn_for(cfg)
    ffn_fn_serve = _ffn_fn_for(cfg, serve=True)
    is_vlm = cfg.family == "vlm"

    def init(seed=0) -> dict:
        """Random params on ``device`` at the reference's scales, drawn from
        ``seed`` (an int or a ``torch.Generator`` on ``device``)."""
        gen = _generator(seed, device)
        pd = cfg.parameter_dtype()
        p = _head_init(gen, cfg)
        p["layers"] = T.stack_init(gen, cfg, cfg.n_layers, ffn_init_fn=_ffn_init_for(cfg))
        p["ln_f"] = L.rmsnorm_init(cfg.d_model, pd, device)
        if is_vlm:
            p["vision_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, dtype=pd)
        return p

    def _embed_batch(params, batch: dict):
        """(x (B, S, d), tokens (B, S), loss mask (B, S)); the VLM's
        projected prefix goes first, over pad tokens 0 and a zero mask."""
        tokens = torch.as_tensor(batch["tokens"], device=device)
        x = _embed_tokens(params, cfg, tokens)
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=device)
        if is_vlm:
            pe = L.dense(params["vision_proj"],
                         torch.as_tensor(batch["prefix_embeds"], device=device),
                         dtype=cfg.activation_dtype())
            b, p = pe.shape[:2]
            # on a mesh the prefix takes the tokens' placements: DTensor
            # would join a column-sharded prefix by sharding the sequence,
            # which the next products cannot plan on fake tensors
            x = torch.cat([placed_like(pe, x), x], dim=1)
            tokens = torch.cat([tokens.new_zeros((b, p)), tokens], dim=1)
            mask = torch.cat([mask.new_zeros((b, p)), mask], dim=1)
        return x, tokens, mask

    def loss(params, batch: dict):
        """batch (tensors or numpy arrays; see the module docstring) ->
        (loss, metrics): the mean next-token cross-entropy with the
        reference's z-loss, plus the MoE's auxiliary losses (metric
        ``aux_loss``), differentiable with respect to ``params``."""
        x, tokens, mask = _embed_batch(params, batch)
        b, s = tokens.shape
        h, aux = T.stack_apply(params["layers"], cfg, x, _positions(b, s, device),
                               ffn_apply_fn=ffn_fn)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _lm_loss(params, cfg, tokens, h, mask=mask, aux=aux)

    @torch.no_grad()
    def prefill(params, batch: dict, max_len: int):
        """batch ``{"tokens": (B, S)}`` (the VLM's with its prefix) ->
        (logits (B, 1, vocab) of the last position, caches of ``max_len``
        positions holding the prompt, the prefix first; see
        ``T.stack_prefill``). Every row's positions are ``0..S-1``."""
        x, tokens, _ = _embed_batch(params, batch)
        b, s = tokens.shape
        h, caches = T.stack_prefill(params["layers"], cfg, x, _positions(b, s, x.device), max_len,
                                    ffn_apply_fn=ffn_fn_serve)
        h = L.rmsnorm(params["ln_f"], h[:, -1:], cfg.norm_eps)
        return _logits(params, cfg, h), caches

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, caches: dict):
        """tokens (B, C) -> logits (B, C, vocab), with the caches written in
        place (see ``T.stack_decode``): C = 1 over contiguous caches, a
        ragged chunk over a paged pool."""
        x = _embed_tokens(params, cfg, tokens)
        h, caches = T.stack_decode(params["layers"], cfg, x, caches, ffn_apply_fn=ffn_fn_serve)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _logits(params, cfg, h), caches

    return LM(cfg, device, init, loss, prefill, decode_step, _input_specs_fn(cfg, device))


def _build_ssm(cfg: ModelConfig, device: torch.device) -> LM:
    hybrid = cfg.family == "hybrid"

    def init(seed=0) -> dict:
        """Random params on ``device`` at the reference's scales, drawn from
        ``seed`` (an int or a ``torch.Generator`` on ``device``)."""
        gen = _generator(seed, device)
        pd = cfg.parameter_dtype()
        p = _head_init(gen, cfg)
        if hybrid:
            p["layers"] = HY.hybrid_init(gen, cfg)
        else:
            p["layers"] = [
                {"ln": L.rmsnorm_init(cfg.d_model, pd, device), "mamba": SSM.mamba_init(gen, cfg)}
                for _ in range(cfg.n_layers)
            ]
        p["ln_f"] = L.rmsnorm_init(cfg.d_model, pd, device)
        return p

    def _backbone(params, x, positions):
        if hybrid:
            return HY.hybrid_apply(params["layers"], cfg, x, positions)
        h = x
        for lp in params["layers"]:
            body = T.remat_wrap(lambda h_, lp=lp: h_ + SSM.mamba_apply(
                lp["mamba"], cfg, L.rmsnorm(lp["ln"], h_, cfg.norm_eps)), cfg)
            h = body(h)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(params, batch: dict):
        """batch ``{"tokens": (B, S)}`` -> (loss, metrics), as the dense
        family's (no mask: every position counts)."""
        tokens = torch.as_tensor(batch["tokens"], device=device)
        x = _embed_tokens(params, cfg, tokens)
        b, s = tokens.shape
        h, aux = _backbone(params, x, _positions(b, s, device))
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _lm_loss(params, cfg, tokens, h, aux=aux)

    @torch.no_grad()
    def prefill(params, batch: dict, max_len: int):
        """batch ``{"tokens": (B, S)}`` -> (logits (B, 1, vocab) of the last
        position, caches). SSM caches do not depend on ``max_len``."""
        tokens = batch["tokens"]
        x = _embed_tokens(params, cfg, tokens)
        b, s = tokens.shape
        if hybrid:
            h, caches = HY.hybrid_prefill(params["layers"], cfg, x, _positions(b, s, x.device),
                                          max_len)
        else:
            states = SSM.mamba_init_state(cfg, b, device=x.device, lead=(cfg.n_layers,),
                                          **cache_layout())
            h = x
            for i, lp in enumerate(params["layers"]):
                out, st = SSM.mamba_prefill(lp["mamba"], cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps))
                h = h + out
                for name, t in states.items():
                    write_local(t[i], st[name])
            caches = {"mamba": states,
                      "len": torch.full((), s, dtype=torch.int32, device=x.device)}
        h = L.rmsnorm(params["ln_f"], h[:, -1:], cfg.norm_eps)
        return _logits(params, cfg, h), caches

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, caches: dict):
        """tokens (B, 1) -> logits (B, 1, vocab), the states (and the hybrid's
        KV caches) written in place."""
        x = _embed_tokens(params, cfg, tokens)
        if hybrid:
            h, caches = HY.hybrid_decode(params["layers"], cfg, x, caches)
        else:
            h = x
            states = caches["mamba"]
            for i, lp in enumerate(params["layers"]):
                out, _ = SSM.mamba_decode(lp["mamba"], cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
                                          {name: t[i] for name, t in states.items()})
                h = h + out
            caches = dict(caches, len=caches["len"] + 1)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _logits(params, cfg, h), caches

    return LM(cfg, device, init, loss, prefill, decode_step, _input_specs_fn(cfg, device))


def _build_encdec(cfg: ModelConfig, device: torch.device) -> LM:
    def init(seed=0) -> dict:
        """Random params on ``device`` at the reference's scales, drawn from
        ``seed`` (an int or a ``torch.Generator`` on ``device``)."""
        gen = _generator(seed, device)
        p = _head_init(gen, cfg)
        p.update(ED.encdec_init(gen, cfg))
        p["ln_f"] = L.rmsnorm_init(cfg.d_model, cfg.parameter_dtype(), device)
        return p

    def _encode(params, batch: dict):
        src = torch.as_tensor(batch["src_embeds"], device=device).to(cfg.activation_dtype())
        tgt = torch.as_tensor(batch["tgt_tokens"], device=device)
        return ED.encode(params, cfg, src), tgt

    def loss(params, batch: dict):
        """batch ``{"src_embeds": (B, S_src, d), "tgt_tokens": (B, S)}`` ->
        (loss, metrics): the decoder's next-token cross-entropy (no mask),
        differentiable through the encoder too."""
        enc_out, tgt = _encode(params, batch)
        h = ED.decode_train(params, cfg, _embed_tokens(params, cfg, tgt), enc_out)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _lm_loss(params, cfg, tgt, h)

    @torch.no_grad()
    def prefill(params, batch: dict, max_len: int):
        """batch as ``loss``'s -> (logits (B, 1, vocab) of the last target
        position, ``{"self", "cross"}`` caches; see ``ED.encdec_prefill``)."""
        enc_out, tgt = _encode(params, batch)
        h, caches = ED.encdec_prefill(params, cfg, _embed_tokens(params, cfg, tgt), enc_out,
                                      max_len)
        h = L.rmsnorm(params["ln_f"], h[:, -1:], cfg.norm_eps)
        return _logits(params, cfg, h), caches

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, caches: dict):
        """tokens (B, 1) -> logits (B, 1, vocab); the self caches written in
        place."""
        h, caches = ED.encdec_decode(params, cfg, _embed_tokens(params, cfg, tokens), caches)
        h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _logits(params, cfg, h), caches

    return LM(cfg, device, init, loss, prefill, decode_step, _input_specs_fn(cfg, device))


def build_model(cfg: ModelConfig, device="cuda") -> LM:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of {FAMILIES}")
    if cfg.family in ("ssm", "hybrid"):
        return _build_ssm(cfg, resolve_device(device))
    if cfg.family == "encdec":
        return _build_encdec(cfg, resolve_device(device))
    return _build_decoder_only(cfg, resolve_device(device))
