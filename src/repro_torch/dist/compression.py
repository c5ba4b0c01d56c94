"""Int8 compression for gradients, collectives and KV caches.

A port of ``repro.dist.compression``:

  * ``quantize_int8`` is blockwise symmetric: the flattened tensor is split
    into blocks of ``BLOCK`` values, each with one float32 scale ``max|x| /
    127`` (an all-zero block gets scale 1), so the elementwise error is at
    most scale/2; rounding is half to even, as ``jnp.round``'s;
  * ``reduce_grads_compressed`` is an error-feedback compressed mean
    all-reduce (the 1-bit-Adam / EF-SGD family, arXiv:2102.02888): each rank
    quantizes (grad + carried residual), the dequantized values are
    mean-reduced over a process group (the reference's ``pmean`` over a
    bound mesh axis), and each rank keeps its local quantization error as
    the next step's residual;
  * ``quantize_int8_vec``, the per-vector variant of the int8 KV caches:
    one float32 scale per trailing vector, and the inverse ``(q * scale)``
    computed in float32 and rounded once to the caller's dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "BLOCK",
    "quantize_int8",
    "dequantize_int8",
    "quantize_int8_vec",
    "dequantize_int8_vec",
    "init_residuals",
    "reduce_grads_compressed",
]

# 256 int8 payload bytes + one f32 scale per block: ~1.6% scale overhead.
BLOCK = 256


def quantize_int8(x: torch.Tensor, *, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Any shape -> (q (nb, block) int8, scale (nb,) float32). The tensor is
    flattened and zero-padded to a whole number of blocks."""
    xf = x.reshape(-1).float()
    pad = (-xf.numel()) % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(-1, block)
    scale = xb.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(xb / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; ``shape`` trims the block padding."""
    flat = (q.float() * scale[..., None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape).to(dtype)


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


def init_residuals(grads):
    """Zero error-feedback residuals, one float32 leaf per gradient leaf (a
    nested dict or list of tensors)."""
    if isinstance(grads, dict):
        return {k: init_residuals(v) for k, v in grads.items()}
    if isinstance(grads, list):
        return [init_residuals(v) for v in grads]
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)


def _group(axis):
    """A process group from ``axis``: None (the default group), a group, or
    ``(DeviceMesh, dim name)``."""
    if isinstance(axis, tuple):
        mesh, name = axis
        return mesh.get_group(name)
    return axis


def reduce_grads_compressed(grads, residuals, axis=None, *, block: int = BLOCK):
    """Error-feedback int8 mean all-reduce over ``axis``: a process group,
    ``(DeviceMesh, dim name)``, or None for the default group (the
    reference's ``axis_name``). Every rank calls it with its local
    gradients. Returns ``(reduced, new_residuals)``: ``reduced`` is the
    mean over the group's ranks of the dequantized gradients, in each
    gradient's dtype and the same on every rank; ``new_residuals`` is this
    rank's quantization error, carried into the next step."""
    import torch.distributed as dist

    group = _group(axis)
    n = dist.get_world_size(group)

    def one(g, r):
        gf = g.float() + r.float()
        q, s = quantize_int8(gf, block=block)
        local = dequantize_int8(q, s, g.shape, torch.float32)
        new_r = gf - local
        out = local.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return (out / n).to(g.dtype), new_r

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
        if isinstance(g, list):
            pairs = [walk(a, b) for a, b in zip(g, r)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        return one(g, r)

    return walk(grads, residuals)
