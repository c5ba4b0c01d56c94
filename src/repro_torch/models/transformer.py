"""Dense decoder stack over a paged KV cache: GQA attention with RoPE,
SwiGLU FFN, and the ragged chunk step of the continuous serve engine.

A port of the paged decode path of ``repro.models.transformer``. The JAX
package scans stacked layer params; here the layers are a list and
``stack_decode`` is a Python loop. The paged cache is written in place:
``k_pages``/``v_pages`` are the pool tensors (L, n_pages, page, Hkv, hd)
and each layer writes its own slice. Invalid chunk rows (``t >= q_len``)
are routed to the reserved dummy page 0, which no sequence owns and every
read masks; duplicate writes there are harmless whichever one lands.

All attention goes through ``repro_torch.kernels.ops.attention_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

__all__ = [
    "attn_init",
    "attn_decode",
    "ffn_init",
    "ffn_apply",
    "layer_init",
    "stack_init",
    "stack_decode",
    "page_geometry",
    "init_cache",
]


def _int8_not_ported(cfg: ModelConfig) -> None:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "kv_cache_dtype='int8' (quantized KV pages) is not ported yet: "
            "ROADMAP §A5"
        )


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    hd = cfg.hd
    pd = cfg.parameter_dtype()
    return {
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=pd),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=pd),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=pd),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype=pd),
    }


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """Ragged chunk step of one layer against its paged cache.

    x (B, C, d); ``cache`` holds this layer's ``k_pages``/``v_pages``
    (n_pages, page, Hkv, hd), the ``block_table`` (B, n_blocks), ``len``
    (B,) tokens already cached, and optionally ``q_len`` (B,) valid chunk
    rows and ``order_group`` (the step's effective reversal group).
    Returns (out (B, C, d), cache with ``len`` advanced by ``q_len``).
    """
    if "k_pages" not in cache:
        raise NotImplementedError(
            "contiguous KV caches (the static scheduler's layout) are not "
            "ported yet: ROADMAP §A7"
        )
    dt = cfg.activation_dtype()
    b = x.shape[0]
    hd = cfg.hd
    q = L.dense(p["wq"], x, dtype=dt).reshape(b, -1, cfg.n_heads, hd)
    k = L.dense(p["wk"], x, dtype=dt).reshape(b, -1, cfg.n_kv_heads, hd)
    v = L.dense(p["wv"], x, dtype=dt).reshape(b, -1, cfg.n_kv_heads, hd)
    o, cache = _attn_decode_paged(cfg, cache, q, k, v)
    out = L.dense(p["wo"], o.reshape(b, o.shape[1], -1), dtype=dt)
    return out, cache


def _paged_write(cfg: ModelConfig, cache: dict, k, v, starts, q_lens) -> dict:
    """Write chunk k/v (B, C, Hkv, hd) at positions ``starts[b] + t`` for
    ``t < q_lens[b]`` through the block table, in place; invalid rows go to
    dummy page 0."""
    _int8_not_ported(cfg)
    b, c = k.shape[:2]
    bt = cache["block_table"]
    page = cache["k_pages"].shape[1]
    capacity = bt.shape[1] * page
    tq = torch.arange(c, dtype=torch.int32, device=k.device)[None, :]
    pos = starts[:, None] + tq                               # (B, C)
    valid = tq < q_lens[:, None]
    wpos = torch.clamp(pos, max=capacity - 1)
    page_log = torch.div(wpos, page, rounding_mode="floor")
    offset = (wpos % page).long()
    phys = torch.gather(bt, 1, page_log.long())
    phys = torch.where(valid, phys, torch.zeros_like(phys)).long()
    for name, val in (("k_pages", k), ("v_pages", v)):
        pages = cache[name]
        pages[phys, offset] = val.to(pages.dtype)
    return cache


def _attn_decode_paged(cfg: ModelConfig, cache: dict, q, k, v):
    b, c = q.shape[:2]
    lens = cache["len"]
    bt = cache["block_table"]
    page = cache["k_pages"].shape[1]
    capacity = bt.shape[1] * page
    q_lens = cache.get("q_len")
    if q_lens is None:
        q_lens = torch.full((b,), c, dtype=torch.int32, device=q.device)

    positions = lens[:, None] + torch.arange(c, dtype=torch.int32, device=q.device)[None, :]
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)

    cache = _paged_write(cfg, dict(cache), k, v, lens, q_lens)
    cache["len"] = lens + q_lens
    # The parity driver of the page walk is the length after this write.
    valid = torch.clamp(lens + q_lens, max=capacity)
    o = ops.attention_decode(
        q,
        cache["k_pages"],
        cache["v_pages"],
        valid,
        order=cfg.attn_order,
        snake_group=cfg.snake_group,
        impl=cfg.attn_impl,
        block_table=bt,
        q_lens=q_lens,
        order_group=cache.get("order_group"),
    )
    return o, cache


def page_geometry(cfg: ModelConfig, max_len: int) -> tuple[int, int]:
    """(page rows, blocks-per-sequence) for a paged cache of ``max_len``;
    the page defaults to ``kv_block`` so pages coincide with KV tiles."""
    page = cfg.page_size or cfg.kv_block
    page = max(1, min(page, max_len))
    return page, -(-max_len // page)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None, device="cpu") -> dict:
    """One layer's paged KV cache: zero pages (batch * n_blocks, page, Hkv,
    hd), an identity ``block_table`` and zero ``len``."""
    if cfg.kv_layout != "paged":
        raise NotImplementedError(
            "contiguous KV caches (the static scheduler's layout) are not "
            "ported yet: ROADMAP §A7"
        )
    if cfg.window is not None:
        raise ValueError(
            "paged KV layout requires full attention; sliding-window "
            "archs keep the ring-buffer layout (kv_layout='contiguous')"
        )
    _int8_not_ported(cfg)
    page, bpr = page_geometry(cfg, max_len)
    shape = (batch * bpr, page, cfg.n_kv_heads, cfg.hd)
    dt = dtype or cfg.activation_dtype()
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "block_table": torch.arange(batch * bpr, dtype=torch.int32, device=device).reshape(
            batch, bpr
        ),
        "k_pages": torch.zeros(shape, dtype=dt, device=device),
        "v_pages": torch.zeros(shape, dtype=dt, device=device),
    }


# --------------------------------------------------------------------------
# FFN, layers, stack
# --------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg: ModelConfig, *, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.parameter_dtype()
    return {
        "w_gate": L.dense_init(gen, d, ff, dtype=pd),
        "w_up": L.dense_init(gen, d, ff, dtype=pd),
        "w_down": L.dense_init(gen, ff, d, dtype=pd),
    }


def ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.activation_dtype()
    g = L.dense(p["w_gate"], x, dtype=dt)
    u = L.dense(p["w_up"], x, dtype=dt)
    return L.dense(p["w_down"], torch.nn.functional.silu(g) * u, dtype=dt)


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.parameter_dtype()
    return {
        "ln_attn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "attn": attn_init(gen, cfg),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "ffn": ffn_init(gen, cfg),
    }


def stack_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int) -> list[dict]:
    return [layer_init(gen, cfg) for _ in range(n_layers)]


def stack_decode(layers: list[dict], cfg: ModelConfig, x: torch.Tensor, caches: dict):
    """One ragged chunk step through every layer. ``caches`` holds the pool
    tensors ``k_pages``/``v_pages`` (L, n_pages, page, Hkv, hd) and the
    per-step ``block_table``, ``len``, ``q_len`` and ``order_group`` shared
    by all layers. Pages are written in place; the returned caches carry
    ``len`` advanced by ``q_len``."""
    h = x
    out = caches
    for i, lp in enumerate(layers):
        layer_cache = dict(caches, k_pages=caches["k_pages"][i], v_pages=caches["v_pages"][i])
        a, lc = attn_decode(lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], h, cfg.norm_eps), layer_cache)
        h = h + a
        h = h + ffn_apply(lp["ffn"], cfg, L.rmsnorm(lp["ln_ffn"], h, cfg.norm_eps))
        out = dict(caches, len=lc["len"])
    return h, out
