"""Top-k routed MoE FFN (GShard/Mixtral-style): a port of
``repro.models.moe``.

Two paths, as in the reference:

  * the capacity path (``LM.loss``, and serving when
    ``cfg.moe_serve_dropless`` is off): every token's k choices claim slots
    of a static (E, C, d) expert buffer in token-major order; choices past
    an expert's capacity C are dropped. The expert SwiGLU runs as batched
    products over the buffer and the outputs are gathered back, weighted
    and summed over k. It returns the Switch load-balance and router z
    auxiliary losses, in float32;
  * dropless (``_moe_dropless``, the serving path): the T·k choices are
    sorted by expert (a stable sort) and the three expert products are one
    grouped product each (``ops.ragged_dot``: ``grouped_mm`` on the card),
    with no capacity and no drop; its aux is 0.

Both read no value on the host: group sizes come from a scatter-add of
fixed length E, the repeat of each token k times is an expand, the inverse
of the sort a scatter. So the dropless step runs inside the serve engine's
captured CUDA graphs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import (
    constrain,
    grad_placed_like,
    placed_like,
    replicated,
    whole,
)
from repro_torch.kernels import ops
from repro_torch.models import layers as L

__all__ = ["moe_init", "moe_apply", "expert_capacity"]


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert has for ``n_tokens`` tokens: the even share of the
    T·k choices times ``capacity_factor``, padded to a multiple of 8 (at
    least 8)."""
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Router (float32, (d, E)) and expert weights ``w_gate``/``w_up`` (E, d,
    ff) and ``w_down`` (E, ff, d) at the reference's scales, drawn from
    ``gen``."""
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
    pd = cfg.parameter_dtype()
    return {
        "router": L.dense_init(gen, d, e, dtype=torch.float32),
        "w_gate": L._normal(gen, (e, d, ff), 1.0 / math.sqrt(d), pd),
        "w_up": L._normal(gen, (e, d, ff), 1.0 / math.sqrt(d), pd),
        "w_down": L._normal(gen, (e, ff, d), 1.0 / math.sqrt(ff), pd),
    }


def _route(p: dict, cfg: ModelConfig, xf: torch.Tensor):
    """float32 router logits (T, E), the top-k logits and experts (T, k),
    each row's choices in descending order."""
    logits = L.dense(p["router"], xf.float())
    top_logits, sel = torch.topk(logits, cfg.moe.top_k, dim=-1)
    return logits, top_logits, sel


def _repeat_k(xf: torch.Tensor, k: int) -> torch.Tensor:
    """Each row of xf (T, d) k times in a row: (T·k, d)."""
    t, d = xf.shape
    return xf[:, None].expand(t, k, d).reshape(t * k, d)


def _capacity_slots(e_flat: torch.Tensor, e: int, cap: int):
    """The flat assignment stream e_flat (T·k,) in token-major priority ->
    (one-hot (T·k, E) int32, keep (T·k,) float32, slot (T·k,) clamped
    to cap - 1): each choice's position among its expert's earlier ones,
    kept where it is below ``cap``."""
    # not F.one_hot, which checks its classes with a host read
    oh = (e_flat[:, None] == torch.arange(e, device=e_flat.device)).to(torch.int32)
    pos_all = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos_all, 1, e_flat[:, None])[:, 0]
    keep = (pos < cap).float()
    return oh, keep, torch.clamp(pos, max=cap - 1).long()


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, dropless: bool = False):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux 0-d float32).
    ``dropless`` picks the sorted grouped-product path (serving); the
    default is the capacity path (training)."""
    if dropless:
        return _moe_dropless(p, cfg, x)
    m = cfg.moe
    dt = cfg.activation_dtype()
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(t, cfg)

    # on a mesh xf's gradient comes back in xf's placements, for the same
    # reason as the combine's below (exact no-ops off a mesh)
    xf = grad_placed_like(x.reshape(t, d))
    logits, top_logits, sel = _route(p, cfg, xf)
    probs = torch.softmax(logits, dim=-1)
    weights = torch.softmax(top_logits, dim=-1)

    e_flat = sel.reshape(-1)
    w_flat = weights.reshape(-1)
    oh, keep, pos_c = _capacity_slots(e_flat, e, cap)

    # dispatch: scatter-add the kept choices into the (E, C, d) buffer; on a
    # mesh from the replicated token stream and slots, the buffer's gradient
    # replicated too (torch 2.11's DTensor pairs a whole index with a shard
    # of the rows otherwise, and a shard of the capacity dim cannot be
    # flattened back on fake tensors; the expert products read the buffer
    # whole there anyway; exact no-ops off a mesh)
    slots = replicated(e_flat * cap + pos_c)
    x_rep = replicated(_repeat_k(xf, k).to(dt) * keep[:, None].to(dt))
    buf = torch.zeros((e * cap, d), dtype=dt, device=x.device)
    buf = grad_placed_like(buf.index_add(0, slots, x_rep).view(e, cap, d))
    buf = constrain(buf, "moe_buffer")

    # expert SwiGLU as batched products
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y_buf = torch.bmm(F.silu(g) * u, p["w_down"].to(dt))

    # combine: gather back, weight, sum over k; on a mesh the tokens go back
    # to xf's placements first: DTensor may shard them over mesh dims that
    # the batch does not divide, which the reshape to (B, S) cannot follow
    y_flat = y_buf[e_flat, pos_c] * (w_flat * keep)[:, None].to(dt)
    y = placed_like(y_flat.reshape(t, k, d).sum(dim=1), xf).reshape(b, s, d)

    # aux losses (float32)
    me = probs.mean(dim=0)                                # mean router prob
    ce = oh.float().mean(dim=0) * (1.0 / k) * e           # dispatch fraction
    load_balance = e * torch.sum(me * ce) / e             # Switch aux (≈1 uniform)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = m.aux_loss_coef * load_balance + m.router_z_coef * z
    return y.to(x.dtype), aux


def _dropless_routing(p: dict, cfg: ModelConfig, xf: torch.Tensor):
    """The dropless path's routing of xf (T, d): (weights (T·k,) float32,
    the stable sort ``order`` of the flat expert ids (T·k,), its inverse,
    group sizes (E,) int32). Nothing is read on the host."""
    e = cfg.moe.num_experts
    _, top_logits, sel = _route(p, cfg, xf)
    w_flat = torch.softmax(top_logits, dim=-1).reshape(-1)
    e_flat = sel.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=xf.device))
    sizes = torch.zeros(e, dtype=torch.int64, device=xf.device)
    sizes = sizes.scatter_add(0, e_flat, torch.ones_like(e_flat)).to(torch.int32)
    return w_flat, order, inv, sizes


def _moe_dropless(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Dropless grouped-product MoE (vLLM/MegaBlocks-style): every choice
    runs, sorted by expert."""
    dt = cfg.activation_dtype()
    b, s, d = x.shape
    t, k = b * s, cfg.moe.top_k
    xf = x.reshape(t, d)
    w_flat, order, inv, sizes = _dropless_routing(p, cfg, xf)
    x_sorted = constrain(_repeat_k(xf, k).index_select(0, order).to(dt), "moe_tokens")

    g = ops.ragged_dot(x_sorted, p["w_gate"].to(dt), sizes)
    u = ops.ragged_dot(x_sorted, p["w_up"].to(dt), sizes)
    y_sorted = ops.ragged_dot(F.silu(g) * u, p["w_down"].to(dt), sizes)

    # On a mesh the routing weights are taken whole: DTensor shards the
    # softmax's token dim, and its reshape of the (T·k, d) product cannot
    # follow that shard (an exact no-op off a mesh).
    y_flat = y_sorted.index_select(0, inv) * whole(w_flat)[:, None].to(dt)
    y = y_flat.reshape(t, k, d).sum(dim=1).reshape(b, s, d)
    return y.to(x.dtype), torch.zeros((), dtype=torch.float32, device=x.device)
