"""Full-materialization oracles of the attention kernels (``impl="reference"``).

A port of the attention part of ``repro.kernels.ref``: independent of the
blockwise path (no tiling, no visit order), small shapes only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import decode_attention, mha_reference

__all__ = ["flash_attention_ref", "decode_attention_ref"]


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
