"""Per-vector symmetric int8, the quantization of int8 KV caches.

A port of ``repro.dist.compression.quantize_int8_vec`` and
``dequantize_int8_vec``: one float32 scale ``max|x| / 127`` per trailing
vector (an all-zero vector gets scale 1), ``q = clip(round(x / scale),
-127, 127)`` rounded half to even as ``jnp.round`` does, and the inverse
``(q * scale)`` computed in float32 and rounded once to the caller's
dtype. The blockwise wire format (``quantize_int8``) and the compressed
all-reduce serve collectives and wait for the sharded paths (ROADMAP
§A14).
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8_vec", "dequantize_int8_vec"]


def quantize_int8_vec(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (..., D) -> (q (..., D) int8, scale (...,) float32). The
    maximum is taken in ``x``'s dtype (exact, as is its float32 value) and
    ``x / scale`` in float32 without a float32 copy of ``x``: the
    reference's values with fewer passes over ``x``."""
    scale = x.abs().amax(dim=-1).float() / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.div(x, scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_vec(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_vec`, in one elementwise pass: the
    product is taken in float32 and written rounded to ``dtype``, the bits
    of ``(q.float() * scale[..., None]).to(dtype)`` without its float32
    temporaries."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale[..., None], out=out)
