"""Device-dispatched attention ops that the model layers call.

``attention_decode`` is the port of ``repro.kernels.ops.attention_decode``
for the paged layout. ``impl``:

  * ``"auto"``  — by the tensors' device: the CUDA kernel for CUDA tensors,
    the plain PyTorch version for CPU tensors;
  * ``"cuda"``  — the hand-written kernel (CUDA tensors only);
  * ``"torch"`` — the plain PyTorch version on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import paged_decode_attention
from repro_torch.core.schedule import Order
from repro_torch.kernels.flash_decode import paged_flash_decode_fwd

__all__ = ["attention_decode"]

_IMPLS = ("auto", "cuda", "torch")


def attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    order: Order | str = Order.CYCLIC,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    block_table: Optional[torch.Tensor] = None,
    q_lens=None,
    snake_group: Optional[int] = None,
    order_group=None,
) -> torch.Tensor:
    """Ragged attention of q (B, C, Hq, D) against paged KV pools
    (n_pages, page, Hkv, D) through ``block_table`` (B, n_blocks), pages
    visited in schedule order (``order_group`` overrides ``order``)."""
    if block_table is None:
        raise NotImplementedError(
            "contiguous-cache decode (the _decode_kernel path of the static "
            "scheduler) is not ported yet: ROADMAP §B3"
        )
    if impl not in _IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}; valid: {_IMPLS}")
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    kw = dict(
        q_lens=q_lens, order=order, window=window, scale=scale,
        snake_group=snake_group, order_group=order_group,
    )
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return paged_flash_decode_fwd(q, k_cache, v_cache, cache_len, block_table, **kw)
    return paged_decode_attention(q, k_cache, v_cache, cache_len, block_table, **kw)
