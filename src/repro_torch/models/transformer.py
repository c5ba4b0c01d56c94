"""Decoder stack: GQA attention with RoPE and SWA, SwiGLU FFN (or the
caller's, ``ffn_apply_fn``/``ffn_init_fn``: the MoE family's), the
training forward (``stack_apply``, with per-layer rematerialization), the
full-sequence prefill that builds KV caches, and the decode steps over
contiguous caches (the static serve path) and paged pools (the ragged chunk
step of the continuous serve engine).

A port of ``repro.models.transformer``. The JAX package scans stacked layer
params; here the layers are a list and ``stack_apply``/``stack_prefill``/
``stack_decode`` are Python loops. Caches are allocated once for all layers and written in
place (the reference is functional and builds one cache per layer inside
its scan):

  * contiguous: ``k``/``v`` (L, B, S, Hkv, hd) with ``S = max_len``, or
    ``min(max_len, window)`` as a ring buffer for sliding-window configs,
    and one ``len``, a 0-d int32 tensor on the caches' device, shared by
    the batch and the layers (the reference keeps the same scalar per
    layer). Decode reads and writes it on the device only, so a decode
    step holds no host value and can be captured as a CUDA graph;
  * paged: ``k_pages``/``v_pages`` (L, n_pages, page, Hkv, hd), one
    ``block_table`` and per-row ``len`` (B,). Invalid chunk rows (``t >=
    q_len``) are routed to the reserved dummy page 0, which no sequence owns
    and every read masks; duplicate writes there are harmless whichever one
    lands.

With ``kv_cache_dtype="int8"`` every K/V vector is stored quantized
(``dist.compression.quantize_int8_vec``) beside a float32 scale plane
``<name>_scale`` of the cache's shape less the head dim; as in the
reference, a decode step dequantizes the whole cache before the attention
call, so the decode kernels see the activation dtype.

Full-sequence attention goes through ``repro_torch.kernels.ops.attention``,
decode through ``ops.attention_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import compression
from repro_torch.dist.context import constrain, split_last, whole
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import fold_schedule
from repro_torch.models import layers as L

__all__ = [
    "attn_init",
    "attn_apply",
    "attn_decode",
    "ffn_init",
    "ffn_apply",
    "layer_init",
    "stack_init",
    "remat_wrap",
    "stack_apply",
    "stack_prefill",
    "stack_decode",
    "page_geometry",
    "init_cache",
    "kv_buffers",
    "fill_cache",
    "decode_view",
]


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


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_src: torch.Tensor,
         positions: torch.Tensor, kv_positions: torch.Tensor, *, use_rope: bool = True):
    """q (B, S, Hq, hd) of x (B, S, d), and k, v (B, Skv, Hkv, hd) of
    ``kv_src`` (B, Skv, d): x itself for self-attention, the encoder's
    output for cross-attention. With ``use_rope`` q and k are roped at
    ``positions`` and ``kv_positions``."""
    dt = cfg.activation_dtype()
    hd = cfg.hd
    q = split_last(L.dense(p["wq"], x, dtype=dt), cfg.n_heads, hd)
    k = split_last(L.dense(p["wk"], kv_src, dtype=dt), cfg.n_kv_heads, hd)
    v = split_last(L.dense(p["wv"], kv_src, dtype=dt), cfg.n_kv_heads, hd)
    if use_rope:
        q = L.rope(q, positions, theta=cfg.rope_theta)
        k = L.rope(k, kv_positions, theta=cfg.rope_theta)
    return q, k, v


def attn_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    kv_src: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    use_rope: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention: training, prefill, the encoder
    (``causal=False``) and cross-attention (``kv_src``, the encoder's output
    (B, Skv, d), at ``kv_positions``). Causal self-attention is windowed
    for SWA configs; cross-attention is neither causal nor windowed. With
    ``return_kv`` also returns k, v (B, Skv, Hkv, hd), roped when
    ``use_rope``."""
    cross = kv_src is not None
    kv_src = x if kv_src is None else kv_src
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _qkv(p, cfg, x, kv_src, positions, kv_positions, use_rope=use_rope)
    masked = causal and not cross
    o = ops.attention(
        q,
        k,
        v,
        order=cfg.attn_order,
        snake_group=cfg.snake_group,
        causal=masked,
        window=cfg.window if masked else None,
        q_block=cfg.q_block,
        kv_block=cfg.kv_block,
        impl=cfg.attn_impl,
        score_dtype=cfg.score_dtype,
        bwd_q_block=cfg.bwd_q_block,
        bwd_kv_block=cfg.bwd_kv_block,
    )
    b, s = o.shape[:2]
    out = L.dense(p["wo"], o.reshape(b, s, -1), dtype=cfg.activation_dtype())
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, *,
                cross: bool = False):
    """Decode step of one layer against its cache.

    Cross (``cross=True``, the enc-dec decoder): ``cache`` holds the
    encoder's static ``k``/``v`` (B, S, Hkv, hd) and ``kv_len``, the
    positions of them attended (a 0-d int32 tensor); x (B, 1, d) attends
    them unroped and writes nothing, and ``cache`` comes back as it is.

    Paged (``cache`` holds ``k_pages``/``v_pages`` (n_pages, page, Hkv, hd),
    the ``block_table`` (B, n_blocks), ``len`` (B,) tokens already cached,
    and optionally ``q_len`` (B,) valid chunk rows and ``order_group``): x
    (B, C, d) is a ragged chunk, ``len`` advances by ``q_len``.
    Contiguous (``k``/``v`` (B, S, Hkv, hd), ``len`` a 0-d int32 tensor): x
    (B, 1, d), one token at position ``len`` for every row, ``len``
    advances by one. The indices every layer of a step shares come from
    :func:`decode_view` (made here when ``cache`` lacks them).
    Returns (out (B, C, d), cache).
    """
    dt = cfg.activation_dtype()
    b = x.shape[0]
    hd = cfg.hd
    q = split_last(L.dense(p["wq"], x, dtype=dt), cfg.n_heads, hd)
    if cross:
        if q.shape[1] != 1:
            raise ValueError(f"cross decode takes a single query position, got {q.shape[1]}")
        o = ops.attention_decode(q, cache["k"], cache["v"], cache["kv_len"], impl=cfg.attn_impl)
        return L.dense(p["wo"], o.reshape(b, 1, -1), dtype=dt), cache
    if "valid" not in cache:
        cache = decode_view(cfg, cache, b, x.shape[1])
    k = split_last(L.dense(p["wk"], x, dtype=dt), cfg.n_kv_heads, hd)
    v = split_last(L.dense(p["wv"], x, dtype=dt), cfg.n_kv_heads, hd)
    if "k_pages" in cache:
        o, cache = _attn_decode_paged(cfg, cache, q, k, v)
    else:
        o, cache = _attn_decode_contiguous(cfg, cache, q, k, v)
    out = L.dense(p["wo"], o.reshape(b, o.shape[1], -1), dtype=dt)
    return out, cache


def _attn_decode_contiguous(cfg: ModelConfig, cache: dict, q, k, v):
    b, one = q.shape[:2]
    if one != 1:
        raise ValueError(f"contiguous decode takes a single query position, got {one}")
    pos = cache["len"]
    positions = pos.reshape(1, 1).expand(b, 1)
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)
    _cache_write(cfg, cache, "k", k, cache["write_row"])
    _cache_write(cfg, cache, "v", v, cache["write_row"])
    o = ops.attention_decode(
        q,
        _cache_read(cfg, cache, "k"),
        _cache_read(cfg, cache, "v"),
        cache["valid"],
        order=cfg.attn_order,
        snake_group=cfg.snake_group,
        impl=cfg.attn_impl,
    )
    return o, dict(cache, len=pos + 1)


def _paged_write(cfg: ModelConfig, cache: dict, k, v, starts, q_lens) -> dict:
    """Write chunk k/v (B, C, Hkv, hd) at positions ``starts[b] + t`` for
    ``t < q_lens[b]`` through the block table, in place (int8 pages:
    quantized, with their scales); invalid rows go to dummy page 0."""
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
    for name, val in (("k_pages", whole(k)), ("v_pages", whole(v))):
        if cfg.kv_cache_dtype == "int8":
            qv, sc = _quantize_kv(val)
            cache[name][phys, offset] = qv
            cache[name + "_scale"][phys, offset] = sc
        else:
            cache[name][phys, offset] = val.to(cache[name].dtype)
    return cache


def _attn_decode_paged(cfg: ModelConfig, cache: dict, q, k, v):
    c = q.shape[1]
    lens, q_lens = cache["len"], cache["q_len"]
    positions = lens[:, None] + torch.arange(c, dtype=torch.int32, device=q.device)[None, :]
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)

    cache = _paged_write(cfg, dict(cache), k, v, lens, q_lens)
    cache["len"] = lens + q_lens
    o = ops.attention_decode(
        q,
        _cache_read(cfg, cache, "k_pages"),
        _cache_read(cfg, cache, "v_pages"),
        cache["valid"],
        order=cfg.attn_order,
        snake_group=cfg.snake_group,
        impl=cfg.attn_impl,
        block_table=cache["block_table"],
        q_lens=q_lens,
        fold=cache["fold"],
    )
    return o, cache


def decode_view(cfg: ModelConfig, caches: dict, b: int, c: int) -> dict:
    """``caches`` plus what every layer of one decode step shares, made
    once for the step, on the device (nothing is read by the host, so the
    step can be captured as a CUDA graph). Paged: ``q_len`` (all C when
    absent), ``valid`` (B,) the lengths after the step's writes clamped to
    the capacity (the parity driver of the page walk), and ``fold``, the
    (B, n_blocks) int32 physical and logical page ids in each row's visit
    order (``order_group`` when given, else the config's order), which the
    kernel takes as they are. Contiguous: ``write_row`` (1,) the cache row
    the token goes to (a ring buffer's ``len % S`` with a window; clamped
    into the cache, as the reference's ``dynamic_update_slice`` clamps) and
    ``valid`` (B,) the positions attended, ``min(len + 1, S)``."""
    pos = caches["len"]
    if "k_pages" in caches:
        q_lens = caches.get("q_len")
        if q_lens is None:
            q_lens = torch.full((b,), c, dtype=torch.int32, device=pos.device)
        bt = caches["block_table"]
        valid = torch.clamp(pos + q_lens, max=bt.shape[1] * caches["k_pages"].shape[-3])
        fold = fold_schedule(valid, bt, order=cfg.attn_order, snake_group=cfg.snake_group,
                             order_group=caches.get("order_group"))
        return dict(caches, q_len=q_lens, valid=valid, fold=fold)
    s_max = caches["k"].shape[-3]
    write = pos % s_max if cfg.window is not None else pos  # SWA ring buffer
    row = torch.clamp(write, 0, s_max - 1).reshape(1).long()
    valid = torch.clamp(pos + 1, max=s_max).expand(b).contiguous()
    return dict(caches, write_row=row, valid=valid)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head)-vector symmetric int8: x (..., hd) -> (q, scale)."""
    return compression.quantize_int8_vec(x)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return compression.dequantize_int8_vec(q, scale, dtype)


def _cache_read(cfg: ModelConfig, cache: dict, name: str) -> torch.Tensor:
    """Cache entry ``name`` in the activation dtype: an int8 cache
    dequantized whole (a new tensor), any other as it is."""
    if cfg.kv_cache_dtype == "int8":
        return _dequantize_kv(cache[name], cache[name + "_scale"], cfg.activation_dtype())
    return cache[name]


def page_geometry(cfg: ModelConfig, max_len: int) -> tuple[int, int]:
    """(page rows, blocks-per-sequence) for a paged cache of ``max_len``;
    the page defaults to ``kv_block`` so pages coincide with KV tiles."""
    page = cfg.page_size or cfg.kv_block
    page = max(1, min(page, max_len))
    return page, -(-max_len // page)


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, dtype=None, device="cpu",
    n_layers: Optional[int] = None,
) -> dict:
    """Zero KV cache of ``batch`` rows for ``max_len`` positions.

    Contiguous (``cfg.kv_layout == "contiguous"``): ``k``/``v`` (B, S, Hkv,
    hd) with ``S = max_len``, or ``min(max_len, window)`` (a ring buffer)
    for sliding-window configs, and ``len`` 0 (a 0-d int32 tensor). Paged:
    pages (batch * n_blocks, page, Hkv, hd), an identity ``block_table`` and
    zero ``len`` (B,); the K/V tensors in the cache's format
    (:func:`kv_buffers`: int8 ones carry scale planes). With ``n_layers``
    the tensors gain a leading layer axis (one allocation for the whole
    stack); the other entries are shared.
    """
    lead = () if n_layers is None else (n_layers,)
    if cfg.kv_layout == "paged":
        if cfg.window is not None:
            raise ValueError(
                "paged KV layout requires full attention; sliding-window "
                "archs keep the ring-buffer layout (kv_layout='contiguous')"
            )
        page, bpr = page_geometry(cfg, max_len)
        shape = lead + (batch * bpr, page, cfg.n_kv_heads, cfg.hd)
        return {
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "block_table": torch.arange(batch * bpr, dtype=torch.int32, device=device).reshape(
                batch, bpr
            ),
            **kv_buffers(cfg, ("k_pages", "v_pages"), shape, dtype=dtype, device=device),
        }
    size = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = lead + (batch, size, cfg.n_kv_heads, cfg.hd)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            **kv_buffers(cfg, ("k", "v"), shape, dtype=dtype, device=device)}


def kv_buffers(cfg: ModelConfig, names, shape, *, dtype=None, device="cpu") -> dict:
    """Zero K/V buffers ``names`` of ``shape`` (..., hd) in the cache's
    format: ``dtype`` (default the activation dtype), or with
    ``kv_cache_dtype="int8"`` int8 payloads each beside a float32
    ``<name>_scale`` of ones shaped as the payload less the head dim."""
    if cfg.kv_cache_dtype == "int8":
        out = {}
        for name in names:
            out[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            out[name + "_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=device)
        return out
    dt = dtype or cfg.activation_dtype()
    return {name: torch.zeros(shape, dtype=dt, device=device) for name in names}


def _cache_write(cfg: ModelConfig, cache: dict, name: str, val: torch.Tensor, rows) -> None:
    """Write ``val`` (B, s, H, D) at the cache rows ``rows`` (s,) int64, a
    device tensor, in place (an int8 cache: quantized, and its scales
    beside)."""
    val = whole(val)
    if cfg.kv_cache_dtype == "int8":
        q, scale = _quantize_kv(val)
        cache[name].index_copy_(1, rows, q)
        cache[name + "_scale"].index_copy_(1, rows, scale)
        return
    buf = cache[name]
    buf.index_copy_(1, rows, val.to(buf.dtype))


def fill_cache(cfg: ModelConfig, cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write prefill K/V (B, s, Hkv, hd) into a fresh cache, in place, and
    return it with ``len = s`` (a 0-d int32 tensor). A contiguous cache
    keeps the last ``S`` positions when ``s >= S``; a sliding-window ring
    buffer then rolls them by ``s % S`` so position p sits at index ``p %
    S``, where decode writes it. A paged cache must have the identity block
    table of :func:`init_cache`."""
    if "k_pages" in cache:
        return _fill_cache_paged(cfg, cache, k, v)
    s = k.shape[1]
    size = cache["k"].shape[1]
    if s >= size:
        k, v = k[:, -size:], v[:, -size:]
        if cfg.window is not None:
            shift = s % size
            if shift:
                k = torch.roll(k, shift, dims=1)
                v = torch.roll(v, shift, dims=1)
    rows = torch.arange(k.shape[1], device=k.device)
    _cache_write(cfg, cache, "k", k, rows)
    _cache_write(cfg, cache, "v", v, rows)
    return dict(cache, len=torch.full((), s, dtype=torch.int32, device=k.device))


def _fill_cache_paged(cfg: ModelConfig, cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    b, s = k.shape[:2]
    page = cache["k_pages"].shape[1]
    capacity = cache["block_table"].shape[1] * page
    if s > capacity:
        k, v = k[:, -capacity:], v[:, -capacity:]
        s = capacity
    starts = torch.zeros((b,), dtype=torch.int32, device=k.device)
    q_lens = torch.full((b,), s, dtype=torch.int32, device=k.device)
    out = _paged_write(cfg, dict(cache), k, v, starts, q_lens)
    out["len"] = q_lens
    return out


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


def layer_init(gen: torch.Generator, cfg: ModelConfig, *, ffn_init_fn=None) -> dict:
    """One layer's params; ``ffn_init_fn(gen)`` makes its FFN (default the
    dense SwiGLU's; the MoE family passes ``moe_init``)."""
    pd = cfg.parameter_dtype()
    f_init = ffn_init_fn or (lambda g: ffn_init(g, cfg))
    return {
        "ln_attn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "attn": attn_init(gen, cfg),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, pd, gen.device),
        "ffn": f_init(gen),
    }


def stack_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
               ffn_init_fn=None) -> list[dict]:
    return [layer_init(gen, cfg, ffn_init_fn=ffn_init_fn) for _ in range(n_layers)]


def _ffn(ffn_apply_fn, lp: dict, cfg: ModelConfig, h: torch.Tensor):
    """The layer's FFN on the normed h: (out, aux or None). The dense
    default is ``ffn_apply``; an ``ffn_apply_fn`` that returns a tuple (the
    MoE) gives ``(out, aux)``."""
    xn = L.rmsnorm(lp["ln_ffn"], h, cfg.norm_eps)
    if ffn_apply_fn is None:
        return ffn_apply(lp["ffn"], cfg, xn), None
    y = ffn_apply_fn(lp["ffn"], cfg, xn)
    return y if isinstance(y, tuple) else (y, None)


# The products ``remat="dots"`` keeps: a 2-D matrix product, which is what
# a projection of a (B, S, d) activation by a weight (``L.dense``,
# ``torch.matmul``) reaches. Batched products (``bmm``, the plain
# attention's einsums) and everything else are recomputed, as JAX's
# ``dots_with_no_batch_dims_saveable`` keeps only dots without batch dims.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    # Only these two: a hand-written kernel writes through ctypes into a
    # ``torch.empty`` that is all the dispatcher sees of it, so a policy
    # that saved more than the products could cache that buffer unwritten.
    if op in _DOTS_SAVED:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under the config's rematerialization policy (non-reentrant
    activation checkpointing, the reference's ``jax.checkpoint``):
    ``"none"`` keeps every activation for the backward; ``"full"`` keeps
    only the inputs and runs ``fn`` again in the backward; ``"dots"`` also
    keeps the outputs of the 2-D matrix products (the projections) and
    recomputes the rest around them (selective checkpointing, the
    reference's ``dots_with_no_batch_dims_saveable`` policy)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}; valid: 'none', 'full', 'dots'")
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _layer_fwd(lp: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               ffn_apply_fn=None, causal: bool = True):
    """(hidden, aux or None) of one layer."""
    h = x + attn_apply(lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
                       positions=positions, causal=causal)
    y, aux = _ffn(ffn_apply_fn, lp, cfg, h)
    return constrain(h + y, "residual"), aux


def stack_apply(layers: list[dict], cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True, ffn_apply_fn=None):
    """The training forward through every layer, each under ``remat_wrap``
    (``causal=False``: the enc-dec encoder). Returns (hidden (B, S, d),
    aux): the sum of the layers' auxiliary losses in float32 (the MoE's
    load-balance and router z terms), 0 for the dense FFN, which has
    none."""
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        body = remat_wrap(lambda h_, lp=lp: _layer_fwd(lp, cfg, h_, positions, ffn_apply_fn,
                                                       causal), cfg)
        h, extra = body(h)
        if extra is not None:
            aux = aux + extra
    return h, aux


def _layer_cache(caches: dict, i: int) -> dict:
    """Layer ``i``'s view of the stacked caches (the shared entries as they
    are): the K/V tensors and their int8 scale planes."""
    names = ("k_pages", "v_pages") if "k_pages" in caches else ("k", "v")
    names += tuple(n + "_scale" for n in names if n + "_scale" in caches)
    return dict(caches, **{n: caches[n][i] for n in names})


def stack_prefill(
    layers: list[dict], cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, max_len: int,
    *, ffn_apply_fn=None,
):
    """Forward of every layer over the whole prompt x (B, S, d), filling
    the KV caches of ``max_len`` positions (allocated once for the stack,
    see :func:`init_cache`). Returns (hidden (B, S, d), caches); an FFN's
    aux is dropped, as in the reference."""
    b = x.shape[0]
    caches = init_cache(cfg, b, max_len, device=x.device, n_layers=len(layers))
    h = x
    for i, lp in enumerate(layers):
        xn = L.rmsnorm(lp["ln_attn"], h, cfg.norm_eps)
        a, (k, v) = attn_apply(lp["attn"], cfg, xn, positions=positions, return_kv=True)
        h = h + a
        h = constrain(h + _ffn(ffn_apply_fn, lp, cfg, h)[0], "residual")
        filled = fill_cache(cfg, _layer_cache(caches, i), k, v)
    caches["len"] = filled["len"]
    return h, caches


def stack_decode(layers: list[dict], cfg: ModelConfig, x: torch.Tensor, caches: dict, *,
                 ffn_apply_fn=None):
    """One decode step through every layer, caches written in place.
    Paged: ``caches`` holds the pool tensors ``k_pages``/``v_pages`` (L,
    n_pages, page, Hkv, hd) and the per-step ``block_table``, ``len``,
    ``q_len`` and ``order_group`` shared by all layers; ``len`` advances by
    ``q_len``. Contiguous: ``k``/``v`` (L, B, S, Hkv, hd) and the shared
    ``len`` (0-d), which advances by one. What the layers share (the page
    walk folded once for the step, the write row) comes from one
    :func:`decode_view`. ``ffn_apply_fn`` as in :func:`stack_apply`; an
    aux is dropped."""
    h = x
    step = decode_view(cfg, caches, *x.shape[:2])
    out = caches
    for i, lp in enumerate(layers):
        a, lc = attn_decode(lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], h, cfg.norm_eps),
                            _layer_cache(step, i))
        h = h + a
        h = h + _ffn(ffn_apply_fn, lp, cfg, h)[0]
        out = dict(caches, len=lc["len"])
    return h, out
