"""Plain PyTorch ragged paged attention: the oracle of the paged kernel.

A port of ``repro.core.attention.paged_decode_attention``: a blockwise
online softmax over a row's pages in visit order, accumulated in float32.
``repro_torch.kernels.flash_decode`` uses it for tensors on the CPU, and the
chip smoke test holds the CUDA kernel against it on the card.

Layouts: q (B, C, Hq, D); pools (n_pages, page, Hkv, D); block_table
(B, n_blocks) int32. Hq % Hkv == 0 (GQA).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.schedule import (
    Order,
    page_visit_order,
    page_visit_order_dynamic,
)

__all__ = ["NEG_INF", "paged_decode_attention", "row_meta"]

NEG_INF = float(torch.finfo(torch.float32).min)


def row_meta(b: int, c: int, cache_len, q_lens, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lens, q_lens) as (B,) int32 tensors; q_lens defaults to all C."""
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device).expand(b)
    if q_lens is None:
        qls = torch.full((b,), c, dtype=torch.int32, device=device)
    else:
        qls = torch.as_tensor(q_lens, dtype=torch.int32, device=device).expand(b)
    return lens.contiguous(), qls.contiguous()


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    cache_len,
    block_table: torch.Tensor,
    *,
    q_lens=None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    order: Order | str = Order.CYCLIC,
    snake_group: Optional[int] = None,
    order_group=None,
) -> torch.Tensor:
    """Ragged attention of q (B, C, Hq, D) over a paged KV pool.

    ``cache_len`` (B,) counts valid KV positions including this chunk's
    writes; ``q_lens`` (B,) valid query rows per row (default all C). Query
    t of row b sits at position ``cache_len - q_len + t`` and attends to
    positions at or before its own (and after ``pos - window`` with a
    window). Pages are walked in visit order: ``order_group`` (the effective
    reversal group) when given, else ``order``/``snake_group``; the parity
    driver is ``cache_len``. Rows with nothing to attend to (q_len 0, len 0)
    come back as exact zeros.
    """
    b, c, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    n_blocks = block_table.shape[1]
    g = hq // hkv
    scale_ = d ** -0.5 if scale is None else scale
    dev = q.device
    lens, qls = row_meta(b, c, cache_len, q_lens, dev)
    tq = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    q_pos = (lens - qls)[:, None] + tq                       # (B, C)
    q_valid = tq < qls[:, None]

    if order_group is not None:
        visit = page_visit_order_dynamic(lens, n_blocks, order_group)
    else:
        visit = page_visit_order(order, lens, n_blocks, snake_group=snake_group)
    phys = torch.gather(block_table.to(device=dev, dtype=torch.int64), 1, visit.long())

    qf = q.float().reshape(b, c, hkv, g, d).permute(0, 2, 3, 1, 4) * scale_
    offs = torch.arange(page, dtype=torch.int32, device=dev)[None, :]
    m = torch.full((b, hkv, g, c), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, c), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, c, d), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        pid = phys[:, j]
        k_j = k_pool[pid].float()                            # (B, page, Hkv, D)
        v_j = v_pool[pid].float()
        pos = visit[:, j, None] * page + offs                # (B, page)
        valid = (pos[:, None, :] <= q_pos[:, :, None]) & q_valid[:, :, None]
        valid &= pos[:, None, :] < lens[:, None, None]
        if window is not None:
            valid &= pos[:, None, :] > (q_pos[:, :, None] - window)
        ok = valid[:, None, None, :, :]                      # (B, 1, 1, C, page)
        s = torch.einsum("bhgcd,bkhd->bhgck", qf, k_j)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgck,bkhd->bhgcd", p, v_j)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    o = acc / l[..., None]                                   # (B, Hkv, G, C, D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, hq, d).to(q.dtype)
