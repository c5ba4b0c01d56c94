"""Decode attention: the CUDA kernels' wrappers and their plain versions.

``flash_decode_fwd`` is the port of the JAX package's wrapper of the same
name: with a ``block_table`` it is ragged paged attention, without one a
single-token decode over contiguous caches.

The contiguous branch (``_flash_decode_contiguous``) launches
``csrc/contig_decode.cu``: one block per (row, kv head) holding its GQA
query heads, the cache cut into chunks as the reference cuts it
(:func:`decode_chunk`) and walked in ``kv_index(order, b*Hkv + h, c,
n_chunks)`` order, the mask derived in-kernel from per-row lengths. Its
plain version is ``repro_torch.core.attention.decode_attention``.

``paged_flash_decode_fwd`` is the port of the JAX package's wrapper of the
same name. It folds the traversal schedule into two (B, n_blocks) operands
before the launch: each row's logical visit order (sawtooth parity keyed on
the row's cache length, or the effective reversal group ``order_group``)
and the physical pool pages gathered along it from the block table. The
kernel (``csrc/paged_decode.cu``) walks the pages in that order.

For tensors on the CPU each wrapper returns its plain version
(``decode_attention`` and ``paged_decode_attention``, re-exported here).
For CUDA tensors it launches its kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import decode_attention, paged_decode_attention, row_meta
from repro_torch.core.schedule import (
    DEFAULT_SNAKE_GROUP,
    Order,
    page_visit_order,
    page_visit_order_dynamic,
)
from repro_torch.kernels import cuda_lib

__all__ = [
    "flash_decode_fwd",
    "decode_chunk",
    "launch_contig_decode",
    "decode_attention",
    "paged_flash_decode_fwd",
    "fold_schedule",
    "launch_paged_decode",
    "paged_decode_attention",
]

_HEAD_DIMS = (64, 128)            # the paged kernel (B1)
_CONTIG_HEAD_DIMS = (64, 80, 128)  # the contiguous decode (B3)


def _check_cuda_operands(q, k_pool, v_pool, phys, logical, lens, q_lens) -> None:
    dev = q.device
    b, n_blocks = q.shape[0], phys.shape[-1]
    for name, t, shape in (
        ("k_pool", k_pool, None), ("v_pool", v_pool, None),
        ("phys", phys, (b, n_blocks)), ("logical", logical, (b, n_blocks)),
        ("lens", lens, (b,)), ("q_lens", q_lens, (b,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if shape is not None:
            if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"paged_decode kernel takes a contiguous int32 {name} of shape {shape}, "
                    f"got {t.dtype} {tuple(t.shape)}"
                )
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged_decode kernel takes bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode kernel needs a 16-byte aligned {name}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool {tuple(v_pool.shape)}")
    d, hq, hkv = q.shape[3], q.shape[2], k_pool.shape[2]
    if d not in _HEAD_DIMS or k_pool.shape[3] != d:
        raise ValueError(f"paged_decode kernel takes head dim in {_HEAD_DIMS}, got {d}")
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")


def decode_chunk(chunk: int, s_max: int) -> int:
    """Chunk length of the contiguous walk, as the reference derives it:
    the requested ``chunk``, but no more than the cache rounded up to a
    power of two (at least 128)."""
    return min(int(chunk), max(128, 1 << (max(int(s_max), 1) - 1).bit_length()))


def flash_decode_fwd(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    order: Order | str = Order.CYCLIC,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    chunk: int = 512,
    snake_group: Optional[int] = None,
    block_table: Optional[torch.Tensor] = None,
    q_lens=None,
    order_group=None,
) -> torch.Tensor:
    """Decode attention. Contiguous: q (B, 1, Hq, D), caches (B, S_max,
    Hkv, D), ``cache_len`` scalar or (B,). With ``block_table`` (B,
    n_blocks) the caches are paged pools and q may carry ragged chunks (see
    :func:`paged_flash_decode_fwd`)."""
    if block_table is not None:
        return paged_flash_decode_fwd(
            q, k_cache, v_cache, cache_len, block_table, q_lens=q_lens, order=order,
            window=window, scale=scale, snake_group=snake_group, order_group=order_group,
        )
    if q_lens is not None or order_group is not None:
        raise ValueError("q_lens and order_group require the paged layout (block_table)")
    return _flash_decode_contiguous(
        q, k_cache, v_cache, cache_len, order=Order.parse(order), window=window,
        scale=scale, chunk=chunk, snake_group=snake_group,
    )


def _flash_decode_contiguous(q, k_cache, v_cache, cache_len, *, order, window, scale, chunk,
                             snake_group):
    if q.device.type == "cpu":
        return decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_fwd: unsupported device {q.device}")
    b = q.shape[0]
    if isinstance(cache_len, int):  # the static path's shared length: no host copy
        lens = torch.full((b,), cache_len, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(b).contiguous()
    return launch_contig_decode(
        q, k_cache, v_cache, lens, order=order, window=window, scale=scale, chunk=chunk,
        snake_group=snake_group,
    )


def launch_contig_decode(q, k_cache, v_cache, lens, *, order=Order.CYCLIC, window=None,
                         scale=None, chunk=512, snake_group=None):
    """Launch the contiguous decode kernel on the current stream: q (B, 1,
    Hq, D), caches (B, S_max, Hkv, D) bfloat16, ``lens`` (B,) int32; returns
    the (B, 1, Hq, D) bfloat16 output (exact zeros for rows of length 0)."""
    order = Order.parse(order)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"contig_decode kernel takes one query position, q {tuple(q.shape)}")
    b, _, hq, d = q.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"contig_decode kernel takes bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"contig_decode kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"contig_decode kernel needs a 16-byte aligned {name}")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if d not in _CONTIG_HEAD_DIMS:
        raise ValueError(f"contig_decode kernel takes head dim in {_CONTIG_HEAD_DIMS}, got {d}")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if (lens.dtype != torch.int32 or tuple(lens.shape) != (b,) or not lens.is_contiguous()
            or lens.device != q.device):
        raise ValueError(f"contig_decode kernel takes contiguous int32 lens of shape ({b},)")
    out = torch.empty_like(q)
    if b == 0 or s_max == 0:
        return out.zero_()
    snake = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    if snake < 1:
        raise ValueError(f"snake_group must be >= 1, got {snake_group}")
    scale_ = float(d ** -0.5 if scale is None else scale)
    spec = cuda_lib.KERNELS["contig_decode"]
    fn = getattr(cuda_lib.load("contig_decode"), spec.entry)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, s_max, hq, hkv, d, -1 if window is None else int(window),
            decode_chunk(chunk, s_max), cuda_lib.ORDER_CODES[order.value], snake, scale_,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"contig_decode kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["contig_decode"] += 1
    return out


def paged_flash_decode_fwd(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    cache_len,
    block_table: torch.Tensor,
    *,
    q_lens=None,
    order: Order | str = Order.CYCLIC,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    snake_group: Optional[int] = None,
    order_group=None,
) -> torch.Tensor:
    """Ragged paged attention: q (B, C, Hq, D); pools (n_pages, page, Hkv, D);
    block_table (B, n_blocks); cache_len and q_lens (B,). See
    :func:`paged_decode_attention` for the semantics."""
    if q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pool, v_pool, cache_len, block_table, q_lens=q_lens, window=window,
            scale=scale, order=order, snake_group=snake_group, order_group=order_group,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_fwd: unsupported device {q.device}")
    if block_table.device != q.device:
        raise ValueError(f"block_table is on {block_table.device}, q on {q.device}")
    b, c = q.shape[:2]
    if b == 0 or c == 0 or block_table.shape[1] == 0:
        return torch.zeros_like(q)
    lens, qls = row_meta(b, c, cache_len, q_lens, q.device)
    phys, visit = fold_schedule(
        lens, block_table, order=order, snake_group=snake_group, order_group=order_group
    )
    return launch_paged_decode(q, k_pool, v_pool, phys, visit, lens, qls, window=window, scale=scale)


def fold_schedule(lens, block_table, *, order=Order.CYCLIC, snake_group=None, order_group=None):
    """(phys, logical): (B, n_blocks) int32 physical and logical page ids in
    each row's visit order, the parity driver being ``lens``."""
    n_blocks = block_table.shape[1]
    if order_group is not None:
        visit = page_visit_order_dynamic(lens, n_blocks, order_group)
    else:
        visit = page_visit_order(order, lens, n_blocks, snake_group=snake_group)
    phys = torch.gather(block_table.to(torch.int32), 1, visit.long()).contiguous()
    return phys, visit.to(torch.int32).contiguous()


def launch_paged_decode(q, k_pool, v_pool, phys, logical, lens, q_lens, *, window=None, scale=None):
    """Launch the CUDA kernel on folded operands (see :func:`fold_schedule`)
    on the current stream; returns the (B, C, Hq, D) bfloat16 output. The
    page ids in ``phys`` must lie in ``[0, n_pages)``: the pool's block
    tables always do, and checking them here would cost a device sync."""
    _check_cuda_operands(q, k_pool, v_pool, phys, logical, lens, q_lens)
    b, c, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    n_blocks = phys.shape[1]
    out = torch.empty_like(q)
    scale_ = float(d ** -0.5 if scale is None else scale)
    fn = getattr(cuda_lib.load("paged_decode"), cuda_lib.KERNELS["paged_decode"].entry)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), phys.data_ptr(),
            logical.data_ptr(), lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
            b, c, hq, hkv, d, n_blocks, page, -1 if window is None else int(window),
            scale_, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["paged_decode"] += 1
    return out
