"""The operations and bytes a served request needs, from the configuration's
shapes alone: every prompt and generated token once, no pads, causal
attention over each token's own context, a MoE's active experts only.
They count what the inputs need, not what an implementation does, so a
change that drops padding or a recomputation raises the shares taken
against them.

A request is ``(prompt_len, n_out)``: ``n_out`` generated tokens, the first
sampled from the prompt's last position, each later one from a decode step
that processes the token before it. So a request processes ``prompt_len +
n_out - 1`` tokens, decode step ``j`` (1-based) attends ``prompt_len + j``
positions, and the LM head is needed ``n_out`` times.
"""

from __future__ import annotations

import dataclasses

from bench.constants import BF16_BYTES, PEAK_BF16_FLOPS, PEAK_HBM_BYTES

__all__ = ["Shapes", "layer_matmul_params", "served_flops", "prefill_flops", "b1_need",
           "b2_need", "roofline_seconds"]


@dataclasses.dataclass(frozen=True)
class Shapes:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0

    @classmethod
    def from_config(cls, c: dict) -> "Shapes":
        """From a configuration file of ``bench/configs`` (the keys of the
        model's published ``config.json``)."""
        heads = int(c["num_attention_heads"])
        return cls(
            layers=int(c["num_hidden_layers"]), d=int(c["hidden_size"]), heads=heads,
            kv_heads=int(c["num_key_value_heads"]),
            head_dim=int(c.get("head_dim") or c["hidden_size"] // heads),
            d_ff=int(c["intermediate_size"]), vocab=int(c["vocab_size"]),
            experts=int(c.get("num_experts", 0)), top_k=int(c.get("num_experts_per_tok", 0)),
            d_ff_expert=int(c["intermediate_size"]) if c.get("num_experts") else 0,
        )


def layer_matmul_params(s: Shapes) -> int:
    """Weights one token multiplies by in one layer: the four attention
    projections and the SwiGLU, or the router and top-k experts' SwiGLUs."""
    attn = s.d * s.heads * s.head_dim + 2 * s.d * s.kv_heads * s.head_dim \
        + s.heads * s.head_dim * s.d
    if s.experts:
        return attn + s.d * s.experts + s.top_k * 3 * s.d * s.d_ff_expert
    return attn + 3 * s.d * s.d_ff


def _causal_pairs(p: int) -> int:
    """Query-key pairs of causal attention over p positions."""
    return p * (p + 1) // 2


def _decode_context(p: int, n_out: int) -> int:
    """Positions attended over a request's decode steps, summed."""
    m = max(n_out - 1, 0)
    return m * p + m * (m + 1) // 2


def served_flops(s: Shapes, requests) -> int:
    """FLOPs of serving ``requests`` ((prompt_len, n_out) pairs): the
    projections of every processed token, causal attention (QK and PV, 4
    FLOPs a head dim a pair), the LM head for every generated token."""
    per_pair = 4 * s.heads * s.head_dim
    total = 0
    for p, n_out in requests:
        if n_out <= 0:
            continue
        tokens = p + n_out - 1
        pairs = _causal_pairs(p) + _decode_context(p, n_out)
        total += s.layers * (2 * layer_matmul_params(s) * tokens + per_pair * pairs)
        total += 2 * s.d * s.vocab * n_out
    return total


def prefill_flops(s: Shapes, prompt_lens) -> int:
    """FLOPs of prefilling each prompt alone (no pads) and its one LM-head
    row."""
    per_pair = 4 * s.heads * s.head_dim
    return sum(s.layers * (2 * layer_matmul_params(s) * p + per_pair * _causal_pairs(p))
               + 2 * s.d * s.vocab for p in prompt_lens)


def b1_need(s: Shapes, requests) -> tuple[int, int]:
    """(FLOPs, bytes) of the paged attention (B1) that ``requests`` need:
    each prompt's K/V read once for its prompt and each decode step's whole
    context K/V read once, every layer, plus a q row read and an output row
    written for every processed token; FLOPs of causal attention over the
    prompt and of each decode step."""
    kv_row = 2 * s.kv_heads * s.head_dim * BF16_BYTES
    qo_row = 2 * s.heads * s.head_dim * BF16_BYTES
    per_pair = 4 * s.heads * s.head_dim
    flops = nbytes = 0
    for p, n_out in requests:
        if n_out <= 0:
            continue
        m = n_out - 1
        ctx = _decode_context(p, n_out)
        nbytes += s.layers * ((p + ctx) * kv_row + (p + m) * qo_row)
        flops += s.layers * per_pair * (_causal_pairs(p) + ctx)
    return flops, nbytes


def b2_need(s: Shapes, prompt_lens) -> tuple[int, int]:
    """(FLOPs, bytes) of the flash forward (B2) over each prompt alone:
    causal attention, q, k, v read and o written once, every layer."""
    per_pair = 4 * s.heads * s.head_dim
    row = (2 * s.heads + 2 * s.kv_heads) * s.head_dim * BF16_BYTES
    flops = sum(s.layers * per_pair * _causal_pairs(p) for p in prompt_lens)
    nbytes = sum(s.layers * p * row for p in prompt_lens)
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
