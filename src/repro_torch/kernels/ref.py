"""Oracles of the kernels (``impl="reference"``).

A port of ``repro.kernels.ref``: the attention oracles materialize every
score (no tiling, no visit order) and the SSD oracle is the sequential
recurrence, a Python loop over positions; independent of the blockwise and
chunked paths, small shapes only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import decode_attention, mha_reference

__all__ = ["flash_attention_ref", "decode_attention_ref", "ssd_ref"]


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Oracle of the flash forward. Layout (B, S, H, D)."""
    return mha_reference(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Oracle of the contiguous decode. q (B, 1, Hq, D), caches (B, S, Hkv, D)."""
    return decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)


def ssd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle of the Mamba-2 SSD kernel: the sequential selective-state
    recurrence, in float32.

      x (B, S, H, P), dt (B, S, H) post-softplus, a (H,) <= 0,
      b, c (B, S, N) shared across heads (G = 1).
      S_t = exp(dt_t a_h) S_{t-1} + dt_t x_t b_t^T,   y_t = S_t c_t.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    ``init_state`` (B, H, P, N) starts the recurrence (zeros when None; the
    reference's oracle always starts from zeros)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t, :, None, None] * af[None, :, None, None])
        upd = (dtf[:, t, :, None] * xf[:, t])[..., :, None] * bf[:, t, None, None, :]
        state = decay * state + upd                                  # (B, H, P, N)
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), state
