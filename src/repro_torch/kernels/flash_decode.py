"""Decode attention: the CUDA kernels' wrappers and their plain versions.

``flash_decode_fwd`` is the port of the JAX package's wrapper of the same
name: with a ``block_table`` it is ragged paged attention, without one a
single-token decode over contiguous caches.

The contiguous branch (``_flash_decode_contiguous``) launches
``csrc/contig_decode.cu``: a work item per (row, kv head, tile of its GQA
query heads), the cache cut into chunks as the reference cuts it
(:func:`decode_chunk`), walked in ``kv_index(order, b*Hkv + h, c,
n_chunks)`` order, each chunk in 64-position tiles, the mask derived
in-kernel from per-row lengths. Its plain version is
``repro_torch.core.attention.decode_attention``.

``paged_flash_decode_fwd`` is the port of the JAX package's wrapper of the
same name. It folds the traversal schedule into two (B, n_blocks) operands
before the launch: each row's logical visit order (sawtooth parity keyed on
the row's cache length, or the effective reversal group ``order_group``)
and the physical pool pages gathered along it from the block table. The
kernel (``csrc/paged_decode.cu``) walks the pages in that order.

Both kernels split a work item's walk across the S CTAs of a cluster
(:func:`decode_splits`): the tiles (B3) or pages (B1) the item sees, in walk
order, cut into S contiguous segments, the partial softmax states merged in
split order. :func:`paged_decode_walks` and :func:`contig_decode_walks` are
the host models of the walks the kernels record (``visit_out``).

For tensors on the CPU each wrapper returns its plain version
(``decode_attention`` and ``paged_decode_attention``, re-exported here).
For CUDA tensors it launches its kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import (
    MASK_VALUE,
    decode_attention,
    paged_decode_attention,
    row_meta,
)
from repro_torch.core.schedule import (
    DEFAULT_SNAKE_GROUP,
    Order,
    page_visit_order,
    page_visit_order_dynamic,
)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import _check_visit

__all__ = [
    "flash_decode_fwd",
    "decode_chunk",
    "launch_contig_decode",
    "decode_attention",
    "paged_flash_decode_fwd",
    "fold_schedule",
    "launch_paged_decode",
    "paged_decode_attention",
    "DECODE_TILE",
    "DECODE_ROW_TILE",
    "decode_splits",
    "paged_decode_splits",
    "contig_decode_rows",
    "contig_decode_splits",
    "paged_decode_walks",
    "contig_decode_walks",
    "decode_kernel_attr",
]

_HEAD_DIMS = (64, 128)            # the paged kernel (B1)
_CONTIG_HEAD_DIMS = (64, 80, 96, 128)  # the contiguous decode (B3)
# The kernels' tiles (csrc/decode_core.cuh): positions of a ring tile, and
# folded query rows of one of B1's row tiles.
DECODE_TILE = 64
DECODE_ROW_TILE = 64


# CTAs an SM the kernels fit at D 128: the CUDA-core instantiations, and
# B1's with the tensor-core path (more than 8 folded rows).
_ROW_CTAS_PER_SM = 3
_CHUNK_CTAS_PER_SM = 2


def decode_splits(n_items: int, n_units: int, sms: int, per_sm: int = _ROW_CTAS_PER_SM) -> int:
    """The CTAs a work item's walk is split across (the cluster size): the
    largest S in {1, 2, 4, 8} whose ``n_items`` x S CTAs all fit on the
    card at once at ``per_sm`` CTAs an SM (no second wave), but no more
    splits than an item's ``n_units`` pages or tiles; at least 1
    (``pick_splits`` in ``csrc/decode_core.cuh``)."""
    s = 1
    while s < 8 and n_items * 2 * s <= per_sm * sms and 2 * s <= n_units:
        s *= 2
    return s


def paged_decode_splits(b: int, hkv: int, n_blocks: int, sms: int, rows: int = 1) -> int:
    """B1's split count for ``rows`` = C * G folded rows: over B * Hkv items
    (the host cannot see which row tiles past the first hold rows) and the
    row's ``n_blocks`` pages."""
    per_sm = _CHUNK_CTAS_PER_SM if rows > 8 else _ROW_CTAS_PER_SM
    return decode_splits(b * hkv, n_blocks, sms, per_sm)


def contig_decode_rows(g: int) -> int:
    """Query heads a B3 work item holds: the GQA group rounded up to 1, 2, 4
    or 8 (larger groups take several items)."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def contig_decode_splits(b: int, hkv: int, g: int, s_max: int, sms: int) -> int:
    """B3's split count: over its B * Hkv * ceil(G / rows) items and the
    cache's 64-position tiles."""
    rows = contig_decode_rows(g)
    return decode_splits(b * hkv * -(-g // rows), -(-s_max // DECODE_TILE), sms)


def _segments(seen: list, splits: int, width: int) -> list:
    """``seen`` cut into ``splits`` contiguous segments (split s takes
    ``seen[n s // S : n (s + 1) // S]``), each padded with -1 to ``width``."""
    n = len(seen)
    segs = [seen[n * s // splits: n * (s + 1) // splits] for s in range(splits)]
    return [seg + [-1] * (width - len(seg)) for seg in segs]


def paged_decode_walks(logical, lens, q_lens, *, c: int, g: int, hkv: int, page: int,
                       window: Optional[int], splits: int) -> torch.Tensor:
    """What B1 records in ``visit_out`` (B * Hkv, n_rt, splits, n_blocks)
    int32: row tile rt of row b holds folded rows [64 rt, 64 rt + 64) of C *
    G, of which the first ``min(C, q_len) * G`` are valid (none when len is
    0). It sees the pages, in ``logical``'s visit order, whose first column
    is at most min(len - 1, its last valid row's q_pos) and which do not lie
    wholly left of the window of its first valid row; split s walks the
    s-th contiguous segment of them. Pages are logical ids, -1 past a
    segment; the same for every kv head."""
    logical = torch.as_tensor(logical).cpu().tolist()
    lens = torch.as_tensor(lens).cpu().tolist()
    q_lens = torch.as_tensor(q_lens).cpu().tolist()
    n_blocks = len(logical[0])
    rows = c * g
    n_rt = -(-rows // DECODE_ROW_TILE)
    out = []
    for vis, ln, ql in zip(logical, lens, q_lens):
        tiles = []
        for rt in range(n_rt):
            row0 = rt * DECODE_ROW_TILE
            n_out = min(DECODE_ROW_TILE, rows - row0)
            n_valid = max(0, min(min(c, max(ql, 0)) * g - row0, n_out)) if ln > 0 else 0
            if n_valid == 0:
                tiles.append([[-1] * n_blocks for _ in range(splits)])
                continue
            qbase = ln - ql
            qpos_min = qbase + row0 // g
            qpos_max = qbase + (row0 + n_valid - 1) // g
            col_limit = min(ln - 1, qpos_max)
            seen = [p for p in vis if p * page <= col_limit
                    and not (window is not None and p * page + page - 1 <= qpos_min - window)]
            tiles.append(_segments(seen, splits, n_blocks))
        out.extend([tiles] * hkv)
    return torch.tensor(out, dtype=torch.int32).reshape(len(lens) * hkv, n_rt, splits, n_blocks)


def contig_decode_walks(lens, *, s_max: int, hkv: int, g: int, chunk: int, order,
                        snake_group: Optional[int], window: Optional[int],
                        splits: int) -> torch.Tensor:
    """What B3 records in ``visit_out`` (B * Hkv, n_rt, splits, W) int32, W =
    n_chunks * ceil(chunk / 64), chunk = ``decode_chunk(chunk, s_max)``: for
    item (b, h) the chunks in ``kv_index_host(order, b * Hkv + h, j,
    n_chunks)`` order, each cut into 64-position tiles in ascending order,
    keeping the tiles that hold a position p with first <= p < len (first =
    len - window with a window, else 0); split s records the first position
    of each tile of the s-th contiguous segment, then -1. The same for every
    row tile of an item's query heads; all -1 for a row of length 0."""
    from repro_torch.core.schedule import kv_index_host

    snake = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    ch = decode_chunk(chunk, s_max)
    n_chunks = -(-s_max // ch)
    width = n_chunks * -(-ch // DECODE_TILE)
    rows = contig_decode_rows(g)
    n_rt = -(-g // rows)
    lens = torch.as_tensor(lens).cpu().tolist()
    out = []
    for b, ln in enumerate(lens):
        ln = min(max(ln, 0), s_max)
        first = max(0, ln - window) if window is not None else 0
        for h in range(hkv):
            seen = []
            if ln > 0:
                for j in range(n_chunks):
                    c0 = kv_index_host(order, b * hkv + h, j, n_chunks, snake_group=snake) * ch
                    c1 = min(c0 + ch, ln)
                    seen += [t0 for t0 in range(c0, c1, DECODE_TILE)
                             if min(t0 + DECODE_TILE, c1) > first]
                item = _segments(seen, splits, width)
            else:
                item = [[-1] * width for _ in range(splits)]
            out.append([item] * n_rt)
    return torch.tensor(out, dtype=torch.int32).reshape(len(lens) * hkv, n_rt, splits, width)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_kernel_attr(kernel: str, shape: tuple, device=None) -> dict:
    """What the launch of ``kernel`` ("paged_decode": shape (B, C, Hq, Hkv,
    D, n_blocks, page); "contig_decode", or "contig_decode_lse" for the
    launch that writes the lse: (B, S_max, Hq, Hkv, D, chunk)) runs:
    registers and local (spill) bytes a thread, dynamic shared memory and
    threads a CTA, the split (cluster) size and the grid's CTAs."""
    import ctypes

    vals = (ctypes.c_int * 6)(*([-1] * 6))
    lib = cuda_lib.load("contig_decode" if kernel.startswith("contig_decode") else kernel)
    with torch.cuda.device(device):
        err = getattr(lib, f"{kernel}_attr")(*shape, vals)
    if err:
        raise RuntimeError(f"{kernel}_attr{shape} returned cudaError_t {err}")
    return {"registers": vals[0], "dynamic_smem_bytes": vals[1], "threads": vals[2],
            "local_bytes": vals[3], "cluster_size": vals[4], "ctas": vals[5]}


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
    fold=None,
    return_lse: bool = False,
):
    """Decode attention. Contiguous: q (B, 1, Hq, D), caches (B, S_max,
    Hkv, D), ``cache_len`` scalar or (B,); with ``return_lse`` also each
    row's float32 log-sum-exp (B, Hq) (see ``decode_attention``). With
    ``block_table`` (B, n_blocks) the caches are paged pools and q may carry
    ragged chunks (see :func:`paged_flash_decode_fwd`)."""
    if block_table is not None:
        if return_lse:
            raise ValueError("return_lse takes the contiguous layout")
        return paged_flash_decode_fwd(
            q, k_cache, v_cache, cache_len, block_table, q_lens=q_lens, order=order,
            window=window, scale=scale, snake_group=snake_group, order_group=order_group,
            fold=fold,
        )
    if q_lens is not None or order_group is not None or fold is not None:
        raise ValueError("q_lens, order_group and fold require the paged layout (block_table)")
    return _flash_decode_contiguous(
        q, k_cache, v_cache, cache_len, order=Order.parse(order), window=window,
        scale=scale, chunk=chunk, snake_group=snake_group, return_lse=return_lse,
    )


def _flash_decode_contiguous(q, k_cache, v_cache, cache_len, *, order, window, scale, chunk,
                             snake_group, return_lse=False):
    if q.device.type == "cpu":
        return decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale,
                                return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_fwd: unsupported device {q.device}")
    # A tensor length (the static path's 0-d ``len``) stays on the device:
    # a captured step reads it at each replay.
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(q.shape[0])
    lse = (torch.empty((q.shape[0], q.shape[2]), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out = launch_contig_decode(
        q, k_cache, v_cache, lens.contiguous(), order=order, window=window, scale=scale,
        chunk=chunk, snake_group=snake_group, lse=lse,
    )
    return (out, lse) if return_lse else out


def launch_contig_decode(q, k_cache, v_cache, lens, *, order=Order.CYCLIC, window=None,
                         scale=None, chunk=512, snake_group=None, visit_out=None, splits=None,
                         lse=None):
    """Launch the contiguous decode kernel on the current stream: q (B, 1,
    Hq, D), caches (B, S_max, Hkv, D) bfloat16, ``lens`` (B,) int32; returns
    the (B, 1, Hq, D) bfloat16 output (exact zeros for rows of length 0).
    ``splits`` (1, 2, 4 or 8) overrides the kernel's split count
    (:func:`contig_decode_splits`); ``visit_out``, an int32 tensor shaped as
    :func:`contig_decode_walks`'s result, receives the walk. ``lse``, a
    contiguous float32 (B, Hq) tensor on q's card, receives each row's
    log-sum-exp (``MASK_VALUE`` where a row sees nothing): the kernel's
    instantiation with the output, which the launch without it never
    runs."""
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
    if lse is not None and (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq)
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"contig_decode kernel writes a contiguous float32 lse of shape "
                         f"({b}, {hq}) on {q.device}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    if lse is not None and visit_out is not None:
        raise ValueError("contig_decode kernel records a walk or writes an lse, not both")
    out = torch.empty_like(q)
    if b == 0 or s_max == 0:
        if lse is not None:
            lse.fill_(MASK_VALUE)
        return out.zero_()
    snake = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    if snake < 1:
        raise ValueError(f"snake_group must be >= 1, got {snake_group}")
    scale_ = float(d ** -0.5 if scale is None else scale)
    ch = decode_chunk(chunk, s_max)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, s_max, hq, hkv, d, -1 if window is None else int(window), ch,
            cuda_lib.ORDER_CODES[order.value], snake, scale_,
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = cuda_lib.load("contig_decode")
    with torch.cuda.device(q.device):
        if lse is not None:
            err = lib.contig_decode_bf16_lse(*args, lse.data_ptr(), splits or 0)
        elif visit_out is None and splits is None:
            err = getattr(lib, cuda_lib.KERNELS["contig_decode"].entry)(*args)
        else:
            g = hq // hkv
            n_split = _check_splits(splits) or contig_decode_splits(b, hkv, g, s_max,
                                                                    _sms(q.device))
            width = -(-s_max // ch) * -(-ch // DECODE_TILE)
            shape = (b * hkv, -(-g // contig_decode_rows(g)), n_split, width)
            _check_visit(visit_out, shape, q.device, "visit_out")
            err = lib.contig_decode_bf16_visit(
                *args, None if visit_out is None else visit_out.data_ptr(), splits or 0)
    if err != 0:
        raise RuntimeError(f"contig_decode kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["contig_decode"] += 1
    return out


def _check_splits(splits):
    if splits is not None and splits not in (1, 2, 4, 8):
        raise ValueError(f"splits must be 1, 2, 4 or 8, got {splits}")
    return splits


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
    fold=None,
) -> torch.Tensor:
    """Ragged paged attention: q (B, C, Hq, D); pools (n_pages, page, Hkv, D);
    block_table (B, n_blocks); cache_len and q_lens (B,). ``fold``, the
    (phys, logical) pair of :func:`fold_schedule` for these lengths, skips
    the fold (a step folds once for all its layers). See
    :func:`paged_decode_attention` for the semantics."""
    if q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pool, v_pool, cache_len, block_table, q_lens=q_lens, window=window,
            scale=scale, order=order, snake_group=snake_group, order_group=order_group,
            fold=fold,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_fwd: unsupported device {q.device}")
    if block_table.device != q.device:
        raise ValueError(f"block_table is on {block_table.device}, q on {q.device}")
    b, c = q.shape[:2]
    if b == 0 or c == 0 or block_table.shape[1] == 0:
        return torch.zeros_like(q)
    lens, qls = row_meta(b, c, cache_len, q_lens, q.device)
    phys, visit = fold if fold is not None else fold_schedule(
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


def launch_paged_decode(q, k_pool, v_pool, phys, logical, lens, q_lens, *, window=None, scale=None,
                        visit_out=None, splits=None):
    """Launch the CUDA kernel on folded operands (see :func:`fold_schedule`)
    on the current stream; returns the (B, C, Hq, D) bfloat16 output. The
    page ids in ``phys`` must lie in ``[0, n_pages)``: the pool's block
    tables always do, and checking them here would cost a device sync.
    ``splits`` (1, 2, 4 or 8) overrides the kernel's split count
    (:func:`paged_decode_splits`); ``visit_out``, an int32 tensor shaped as
    :func:`paged_decode_walks`'s result, receives the walk."""
    _check_cuda_operands(q, k_pool, v_pool, phys, logical, lens, q_lens)
    b, c, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    n_blocks = phys.shape[1]
    out = torch.empty_like(q)
    scale_ = float(d ** -0.5 if scale is None else scale)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), phys.data_ptr(),
            logical.data_ptr(), lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
            b, c, hq, hkv, d, n_blocks, page, -1 if window is None else int(window),
            scale_, torch.cuda.current_stream(q.device).cuda_stream)
    lib = cuda_lib.load("paged_decode")
    with torch.cuda.device(q.device):
        if visit_out is None and splits is None:
            err = getattr(lib, cuda_lib.KERNELS["paged_decode"].entry)(*args)
        else:
            n_split = _check_splits(splits) or paged_decode_splits(
                b, hkv, n_blocks, _sms(q.device), c * (hq // hkv))
            shape = (b * hkv, -(-c * (hq // hkv) // DECODE_ROW_TILE), n_split, n_blocks)
            _check_visit(visit_out, shape, q.device, "visit_out")
            err = lib.paged_decode_bf16_visit(
                *args, None if visit_out is None else visit_out.data_ptr(), splits or 0)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["paged_decode"] += 1
    return out
