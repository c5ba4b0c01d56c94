"""Ragged paged attention: the CUDA kernel's wrapper and its plain version.

``paged_flash_decode_fwd`` is the port of the JAX package's wrapper of the
same name. It folds the traversal schedule into two (B, n_blocks) operands
before the launch: each row's logical visit order (sawtooth parity keyed on
the row's cache length, or the effective reversal group ``order_group``)
and the physical pool pages gathered along it from the block table. The
kernel (``csrc/paged_decode.cu``) walks the pages in that order.

For tensors on the CPU the wrapper returns the plain version,
``repro_torch.core.attention.paged_decode_attention`` (re-exported here).
For CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import paged_decode_attention, row_meta
from repro_torch.core.schedule import Order, page_visit_order, page_visit_order_dynamic
from repro_torch.kernels import cuda_lib

__all__ = [
    "paged_flash_decode_fwd",
    "fold_schedule",
    "launch_paged_decode",
    "paged_decode_attention",
]

_HEAD_DIMS = (64, 128)


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
