"""Shared building blocks (plain functions on tensors, dict params).

Parameters are nested dicts of tensors with the JAX package's names and
layouts: a dense weight ``w`` is (in, out) and applies as ``x @ w``.
Initializers draw from an explicit ``torch.Generator`` at the reference's
scales (they cannot reproduce ``jax.random``'s numbers; the parity tests
load the reference's weights through ``repro_torch.testing``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.context import grad_placed_like, reduce_partial, seq_gathered

__all__ = [
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "embed_init",
    "rope",
    "rope_angles",
    "rope_rotate",
    "cross_entropy",
]


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def dense_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    *,
    bias: bool = False,
    dtype=torch.float32,
    scale: Optional[float] = None,
) -> dict:
    scale = (1.0 / math.sqrt(in_dim)) if scale is None else scale
    p = {"w": _normal(gen, (in_dim, out_dim), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    # On a mesh a sequence-sharded input is gathered first (Megatron's
    # sequence parallelism): flattened for the product, its shard would be a
    # strided one, which DTensor cannot plan on fake tensors. A no-op off a
    # mesh.
    x = seq_gathered(x)
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # On a mesh a partial sum (a row-parallel product's output) is reduced
    # first, as Megatron's all-reduce: DTensor would otherwise reduce-scatter
    # it onto the sequence, whose strided shard the next product cannot plan
    # on fake tensors (the dry-run). Its gradient (a partial sum from the
    # column-parallel products the norm feeds) is reduced on the way back,
    # Megatron's backward all-reduce, so no product below sees a partial
    # gradient and runs its backward on gathered operands. A no-op off a mesh.
    xf = grad_placed_like(reduce_partial(x)).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32) -> dict:
    return {"table": _normal(gen, (vocab, dim), 0.02, dtype)}


def rope_angles(positions: torch.Tensor, half: int, *,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (..., S, half) float32 of the half-split RoPE at
    ``positions`` (..., S), ``half`` frequencies."""
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                      / half)
    angles = positions[..., :, None].float() * freqs       # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by the half-split RoPE of :func:`rope_angles`'
    cos and sin (..., S, half), shared by the heads; in float32, rounded to
    x's dtype. An odd head dim's last element passes through."""
    half = cos.shape[-1]
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]  # (..., S, 1, half)
    xf1, xf2 = x[..., :half].float(), x[..., half : 2 * half].float()
    parts = [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin]
    if 2 * half != x.shape[-1]:  # odd head_dim tail passes through
        parts.append(x[..., 2 * half :].float())
    return torch.cat(parts, dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, half-split (not interleaved).
    x: (..., S, H, D), positions: (..., S)."""
    cos, sin = rope_angles(positions, x.shape[-1] // 2, theta=theta)
    return rope_rotate(x, cos, sin)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Token-mean softmax cross-entropy with optional z-regularization.
    logits (..., V) in any float dtype (reduced in float32), labels int
    (...,). Returns (loss, {"loss", "tokens", "ppl_proxy"}), 0-d float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    metrics = {
        "loss": loss,
        "tokens": denom,
        "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0)),
    }
    return loss, metrics
