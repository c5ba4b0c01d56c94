"""Plain PyTorch attention: the oracles of the port's attention kernels.

A port of ``repro.core.attention``:

  * ``mha_reference``: full-materialization attention (small shapes only);
  * ``flash_attention``: blockwise online-softmax attention, KV tiles
    walked in the Traversal's order (split-Q, paper Alg. 1 and 4), with
    the per-row log-sum-exp on request; the plain version of the flash
    forward kernel;
  * ``flash_attention_bwd``: the fused blockwise backward from the saved
    ``(o, lse)`` (delta, a dQ pass on the forward grid, a dK/dV pass on
    the transposed grid); the plain version of the three backward kernels
    together, and ``attention_delta`` of the first;
  * ``decode_attention``: one query position against a contiguous cache
    (the plain version of the contiguous decode kernel), or the paged
    layout when a block table is given;
  * ``paged_decode_attention``: ragged attention over a paged pool, pages
    in visit order (the plain version of the paged kernel).

Everything accumulates in float32. The ``repro_torch.kernels`` wrappers
use these for tensors on the CPU, and the chip smoke test holds each CUDA
kernel against its plain version on the card.

Layouts: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D); decode q (B, C, Hq, D)
against caches (B, S_max, Hkv, D) or pools (n_pages, page, Hkv, D) with a
block_table (B, n_blocks) int32. Hq % Hkv == 0 (GQA).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core.schedule import (
    Order,
    Traversal,
    page_visit_order,
    page_visit_order_dynamic,
)

__all__ = [
    "NEG_INF",
    "mha_reference",
    "flash_attention",
    "attention_delta",
    "flash_attention_bwd",
    "decode_attention",
    "merge_decode_partials",
    "paged_decode_attention",
    "row_meta",
    "MASK_VALUE",
]

NEG_INF = float(torch.finfo(torch.float32).min)
# The lse of a row that sees nothing (the kernels' kMaskValue, csrc/common.cuh).
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _valid_mask(rows, cols, *, causal: bool, window: Optional[int], kv_len: int):
    """Boolean visibility mask for global row indices ``rows`` (..., R, 1)
    and column indices ``cols`` (..., 1, C)."""
    m = cols < kv_len
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    return m


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-materialization attention. Small shapes / testing only."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    g = hq // hkv
    scale_ = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale_
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    ok = _valid_mask(rows, cols, causal=causal, window=window, kv_len=skv)
    s = s + torch.where(ok, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _pad_to(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    order: Order | str = Order.CYCLIC,
    causal: bool = False,
    window: Optional[int] = None,
    q_block: int = 128,
    kv_block: int = 128,
    scale: Optional[float] = None,
    score_dtype: str = "float32",
    snake_group: Optional[int] = None,
    return_lse: bool = False,
):
    """Blockwise online-softmax attention, KV tiles in traversal order.

    Every Q tile (all at once, as the reference vmaps them) walks the full
    KV-tile range in ``Traversal.kv_step`` order and masks instead of
    trimming. Scores and probabilities are in ``score_dtype``; m, l and the
    accumulator in float32. ``return_lse=True`` also returns the per-row
    log-sum-exp of the scaled scores, (B, Sq, Hq) float32. As in the
    reference, masked scores take an additive ``NEG_INF`` bias; a row with
    no visible key at all (possible only with a window and Sq > Skv) gets
    no defined output.
    """
    order = Order.parse(order)
    sdt = torch_dtype(score_dtype)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    g = hq // hkv
    scale_ = d ** -0.5 if scale is None else scale
    q_block = min(q_block, max(sq, 1))
    kv_block = min(kv_block, max(skv, 1))
    qp = _pad_to(q, 1, q_block)
    kp = _pad_to(k, 1, kv_block)
    vp = _pad_to(v, 1, kv_block)
    nq, nkv = qp.shape[1] // q_block, kp.shape[1] // kv_block
    tr = Traversal(
        order=order, n_q=nq, n_kv=nkv, causal=causal, window=window,
        q_block=q_block, kv_block=kv_block, n_groups=g, snake_group=snake_group,
    )
    dev = q.device
    # (B, Hkv, G, nq, qb, D) queries; (B, Hkv, nkv, kb, D) keys/values.
    qb_ = qp.reshape(b, nq, q_block, hkv, g, d).permute(0, 3, 4, 1, 2, 5).to(sdt) * scale_
    kb_ = kp.reshape(b, nkv, kv_block, hkv, d).permute(0, 3, 1, 2, 4)
    vb_ = vp.reshape(b, nkv, kv_block, hkv, d).permute(0, 3, 1, 2, 4)
    tiles = torch.arange(nq, dtype=torch.int32, device=dev)
    rows = (tiles[:, None] * q_block + torch.arange(q_block, device=dev)[None, :])[:, :, None]

    m = torch.full((b, hkv, g, nq, q_block), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, nq, q_block, d), dtype=torch.float32, device=dev)
    for j in range(nkv):
        kv_j = torch.as_tensor(tr.kv_step(tiles, j), device=dev).long().expand(nq)
        k_j = kb_[:, :, kv_j].float()                       # (B, Hkv, nq, kb, D)
        v_j = vb_[:, :, kv_j]
        s = torch.einsum("bhgqxd,bhqkd->bhgqxk", qb_.float(), k_j).to(sdt)
        cols = (kv_j[:, None] * kv_block + torch.arange(kv_block, device=dev)[None, :])[:, None, :]
        ok = _valid_mask(rows, cols, causal=causal, window=window, kv_len=skv)
        s = s + torch.where(ok, 0.0, NEG_INF).to(sdt)       # (nq, qb, kb) bias
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        p = torch.exp(s - m_new.to(sdt)[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqxk,bhqkd->bhgqxd", p.float(), v_j.to(sdt).float()
        )
        m = m_new
    lse = m + torch.log(torch.where(l == 0.0, 1.0, l))
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).permute(0, 3, 4, 1, 2, 5).reshape(b, nq * q_block, hq, d)
    out = out[:, :sq].to(q.dtype)
    if not return_lse:
        return out
    lse = lse.permute(0, 3, 4, 1, 2).reshape(b, nq * q_block, hq)[:, :sq]
    return out, lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, (B, Sq, Hq): the softmax-gradient
    dot product the dQ and dK/dV passes reuse."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    order: Order | str = Order.CYCLIC,
    causal: bool = False,
    window: Optional[int] = None,
    q_block: int = 128,
    kv_block: int = 128,
    scale: Optional[float] = None,
    score_dtype: str = "float32",
    snake_group: Optional[int] = None,
):
    """Fused blockwise flash backward from the saved ``(o, lse)``: returns
    (dq, dk, dv) in the dtypes of q, k, v.

    The FlashAttention-2 two-pass structure, without re-running the
    forward: delta = rowsum(dO * O); a dQ pass with every Q tile resident
    and the KV tiles walked in ``Traversal.kv_step`` order (dQ += scale *
    dS K); a dK/dV pass with every KV tile resident and the Q tiles walked
    in the transposed order, parity keyed on the KV tile (dV += P^T dO, dK
    += scale * dS^T Q). P = exp(S * scale - lse) comes from the saved
    log-sum-exp and dS = P * (dP - delta). Both passes walk the full tile
    range and mask (the kernels trim instead). ``score_dtype`` sets the
    type of the two score-shaped products; softmax recovery and the sums
    stay float32.
    """
    order = Order.parse(order)
    sdt = torch_dtype(score_dtype)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    g = hq // hkv
    scale_ = d ** -0.5 if scale is None else scale
    q_block = min(q_block, max(sq, 1))
    kv_block = min(kv_block, max(skv, 1))

    delta = attention_delta(o, do)
    qp, dop = _pad_to(q, 1, q_block), _pad_to(do, 1, q_block)
    lsep, deltap = _pad_to(lse.float(), 1, q_block), _pad_to(delta, 1, q_block)
    kp, vp = _pad_to(k, 1, kv_block), _pad_to(v, 1, kv_block)
    nq, nkv = qp.shape[1] // q_block, kp.shape[1] // kv_block
    tr = Traversal(
        order=order, n_q=nq, n_kv=nkv, causal=causal, window=window,
        q_block=q_block, kv_block=kv_block, n_groups=g, snake_group=snake_group,
    )
    # The dK/dV pass streams Q tiles with parity on the resident KV tile:
    # the same arithmetic with the roles of the axes swapped.
    tr_t = Traversal(order=order, n_q=nkv, n_kv=nq, q_block=kv_block, kv_block=q_block,
                     snake_group=snake_group)
    dev = q.device

    def fold_q(x):  # (B, Sq_p, Hq[, D]) -> (B, Hkv, G, nq, qb[, D])
        tail = x.shape[3:]
        x = x.reshape((b, nq, q_block, hkv, g) + tail)
        return x.permute((0, 3, 4, 1, 2) + tuple(range(5, x.dim())))

    def fold_kv(x):  # (B, Skv_p, Hkv, D) -> (B, Hkv, nkv, kb, D)
        return x.float().reshape(b, nkv, kv_block, hkv, d).permute(0, 3, 1, 2, 4)

    qb_, dob_ = fold_q(qp.float()), fold_q(dop.float())
    lseb, deltab = fold_q(lsep), fold_q(deltap)
    kb_, vb_ = fold_kv(kp), fold_kv(vp)
    q_rows = torch.arange(q_block, device=dev)
    kv_cols = torch.arange(kv_block, device=dev)

    def p_ds(q_t, do_t, lse_t, delta_t, k_j, v_j, ok):
        """Normalized probabilities P and the score gradient dS of a tile;
        q_t/do_t (B, Hkv, G, T, qb, D), k_j/v_j (B, Hkv, T, kb, D)."""
        s = torch.einsum("bhgtqd,bhtkd->bhgtqk", q_t.to(sdt), k_j.to(sdt)).float() * scale_
        p = torch.where(ok, torch.exp(s - lse_t[..., None]), 0.0)
        dp = torch.einsum("bhgtqd,bhtkd->bhgtqk", do_t.to(sdt), v_j.to(sdt)).float()
        return p, p * (dp - delta_t[..., None])

    # dQ pass: every Q tile resident, KV tiles streamed in forward order.
    tiles = torch.arange(nq, dtype=torch.int32, device=dev)
    rows = (tiles[:, None] * q_block + q_rows[None, :])[:, :, None]       # (nq, qb, 1)
    dq = torch.zeros((b, hkv, g, nq, q_block, d), dtype=torch.float32, device=dev)
    for j in range(nkv):
        kv_j = torch.as_tensor(tr.kv_step(tiles, j), device=dev).long().expand(nq)
        k_j, v_j = kb_[:, :, kv_j], vb_[:, :, kv_j]                     # (B, Hkv, nq, kb, D)
        cols = (kv_j[:, None] * kv_block + kv_cols[None, :])[:, None, :]
        ok = _valid_mask(rows, cols, causal=causal, window=window, kv_len=skv)
        _, ds = p_ds(qb_, dob_, lseb, deltab, k_j, v_j, ok)
        dq += scale_ * torch.einsum("bhgtqk,bhtkd->bhgtqd", ds, k_j)
    dq = dq.permute(0, 3, 4, 1, 2, 5).reshape(b, nq * q_block, hq, d)[:, :sq]

    # dK/dV pass: every KV tile resident, Q tiles streamed in transposed order.
    kv_tiles = torch.arange(nkv, dtype=torch.int32, device=dev)
    cols = (kv_tiles[:, None] * kv_block + kv_cols[None, :])[:, None, :]  # (nkv, 1, kb)
    dk = torch.zeros((b, hkv, nkv, kv_block, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for jq in range(nq):
        q_i = torch.as_tensor(tr_t.kv_step(kv_tiles, jq), device=dev).long().expand(nkv)
        q_t, do_t = qb_[:, :, :, q_i], dob_[:, :, :, q_i]               # (B, Hkv, G, nkv, qb, D)
        lse_t, delta_t = lseb[:, :, :, q_i], deltab[:, :, :, q_i]
        r = (q_i[:, None] * q_block + q_rows[None, :])[:, :, None]
        ok = _valid_mask(r, cols, causal=causal, window=window, kv_len=skv)
        p, ds = p_ds(q_t, do_t, lse_t, delta_t, kb_, vb_, ok)
        dv += torch.einsum("bhgtqk,bhgtqd->bhtkd", p, do_t)
        dk += scale_ * torch.einsum("bhgtqk,bhgtqd->bhtkd", ds, q_t)
    dk = dk.permute(0, 2, 3, 1, 4).reshape(b, nkv * kv_block, hkv, d)[:, :skv]
    dv = dv.permute(0, 2, 3, 1, 4).reshape(b, nkv * kv_block, hkv, d)[:, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_table: Optional[torch.Tensor] = None,
    q_lens=None,
    order: Order | str = Order.CYCLIC,
    snake_group: Optional[int] = None,
    order_group=None,
    fold=None,
    return_lse: bool = False,
):
    """Single-position decode attention against a contiguous cache.

    Contiguous layout: q (B, 1, Hq, D); caches (B, S_max, Hkv, D);
    ``cache_len`` the valid prefix length, scalar or (B,). Position ``pos``
    is visible iff ``pos < len`` and, with a window, ``pos > len - 1 -
    window``. The result does not depend on a visit order. A row of length
    0 has no defined output here (the kernel gives zeros). With
    ``block_table`` the caches are paged pools: see
    :func:`paged_decode_attention`.

    ``return_lse`` (contiguous only) also returns each row's float32
    log-sum-exp of its scaled scores, (B, Hq), as B3 writes it: the online
    softmax's m + log l, and for a row that sees nothing exact zeros and
    ``MASK_VALUE`` (m the mask value, l 0), so partial results over
    disjoint slices of a cache merge exactly (:func:`merge_decode_partials`).
    """
    if block_table is not None:
        if return_lse:
            raise ValueError("return_lse takes the contiguous layout")
        return paged_decode_attention(
            q, k_cache, v_cache, cache_len, block_table, q_lens=q_lens, window=window,
            scale=scale, order=order, snake_group=snake_group, order_group=order_group,
            fold=fold,
        )
    if q_lens is not None or order_group is not None or fold is not None:
        raise ValueError("q_lens, order_group and fold require the paged layout (block_table)")
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"contiguous decode takes a single query position, got {one}")
    _, s_max, hkv, _ = k_cache.shape
    g = hq // hkv
    scale_ = d ** -0.5 if scale is None else scale
    lens = torch.as_tensor(cache_len, device=q.device).expand(b)
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale_
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < lens[:, None]
    if window is not None:
        valid &= pos > (lens[:, None] - 1 - window)
    ok = valid[:, None, None, :]
    if not return_lse:
        p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
        return o.reshape(b, 1, hq, d).to(q.dtype)
    m = torch.clamp(torch.where(ok, s, NEG_INF).amax(dim=-1), min=MASK_VALUE)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / torch.where(l == 0, 1.0, l)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), MASK_VALUE)
    return o.reshape(b, 1, hq, d).to(q.dtype), lse.reshape(b, hq)


def merge_decode_partials(o: torch.Tensor, lse: torch.Tensor):
    """Merge n partial decodes over disjoint slices of one cache: o (n, B,
    1, Hq, D) and lse (n, B, Hq) float32, as :func:`decode_attention` with
    ``return_lse`` (or B3) gives them, into (o (B, 1, Hq, D) in o's dtype,
    lse (B, Hq)), by log-sum-exp in float32. A part that saw nothing (lse
    ``MASK_VALUE``, o zeros) weighs nothing; a row no part saw ends in exact
    zeros and ``MASK_VALUE``."""
    seen = lse > 0.5 * MASK_VALUE
    top = torch.where(seen, lse, MASK_VALUE).amax(dim=0)                 # (B, Hq)
    w = torch.where(seen, torch.exp(lse - top), 0.0)                     # (n, B, Hq)
    total = w.sum(dim=0)
    out = (w[:, :, None, :, None] * o.float()).sum(dim=0)
    out = out / torch.where(total == 0, 1.0, total)[:, None, :, None]
    merged = torch.where(total > 0, top + torch.log(torch.where(total > 0, total, 1.0)),
                         MASK_VALUE)
    return out.to(o.dtype), merged


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
    fold=None,
) -> torch.Tensor:
    """Ragged attention of q (B, C, Hq, D) over a paged KV pool.

    ``cache_len`` (B,) counts valid KV positions including this chunk's
    writes; ``q_lens`` (B,) valid query rows per row (default all C). Query
    t of row b sits at position ``cache_len - q_len + t`` and attends to
    positions at or before its own (and after ``pos - window`` with a
    window). Pages are walked in visit order: ``order_group`` (the effective
    reversal group) when given, else ``order``/``snake_group``; the parity
    driver is ``cache_len``; ``fold``, the walk already folded for these
    lengths as (phys, logical) page ids in visit order, replaces that
    choice. Rows with nothing to attend to (q_len 0, len 0) come back as
    exact zeros.
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

    if fold is not None:
        phys, visit = (t.long() for t in fold)
    else:
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
