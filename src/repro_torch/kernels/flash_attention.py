"""Flash attention forward and fused backward: the CUDA kernels' wrappers and
their plain versions.

``flash_attention_fwd`` is the port of the JAX package's wrapper of the same
name. For CUDA tensors it launches ``csrc/flash_fwd.cu``: one persistent CTA
per SM walking work items (batch x kv head, folded row), the folded row
``i`` being GQA group ``i // n_q`` and Q tile ``i % n_q``, at the forward's
own tile sizes (``FWD_BLOCK_M`` x ``FWD_BLOCK_N``). :func:`fwd_schedule` is
the host model of which CTA takes which item in which order; the k-th item
of a CTA walks its trimmed KV range in ``Traversal.kv_order(q_tile,
local_iter=k)`` (paper Alg. 4: the parity key is the worker-local pass
counter), and :func:`fwd_walks` is what the kernel records. For tensors on
the CPU it returns the plain version,
``repro_torch.core.attention.flash_attention``, at the same tile sizes and
order. It never falls back from CUDA to the plain version.

``flash_attention_bwd`` is the port of the JAX package's fused backward of
the same name. For CUDA tensors it launches three kernels on the current
stream: ``csrc/flash_bwd_delta.cu`` (delta = rowsum(dO * O)), then
``csrc/flash_bwd_dq.cu`` (dQ) and ``csrc/flash_bwd_dkv.cu`` (dK and dV),
both persistent like the forward, one CTA per SM. The dQ kernel takes the
forward's work items and order at ``DQ_BLOCK_M`` x ``DQ_BLOCK_N`` tiles
(its host model is :func:`fwd_schedule`); the dK/dV kernel takes items
(batch x kv head, KV tile) of ``DKV_BLOCK_N`` positions, the k-th item of
a CTA streaming every (GQA group, Q tile of ``DKV_BLOCK_M`` rows) that sees
it in ``Traversal.stream_sweep(kv_tile, local_iter=k)`` (host model
:func:`dkv_schedule`, record :func:`dkv_walks`). For tensors on the CPU
it returns the plain version,
``repro_torch.core.attention.flash_attention_bwd``, at one tiling,
``BLOCK_M`` x ``BLOCK_N``.

Both directions take head dims 64, 80, 96 and 128. At 80 (zamba2's shared
attention) and 96 (phi-3-vision's) the persistent kernels run their 128
layout: TMA fills columns D-127 of every tile with zeros, the products that
reduce over the head dim take the D / 16 k-steps that hold data (5, 6),
and the stores write D columns.

The tile sizes are the kernels', not the config's ``q_block``/``kv_block``
(512 there, sized for a TPU's vector memory): a 512 x 128 bf16 K tile alone
would be 128 KB of shared memory. Outputs agree across tile sizes up to
rounding; the visit orders are held to the host models at the kernels'.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import flash_attention
from repro_torch.core.attention import flash_attention_bwd as _plain_bwd
from repro_torch.core.schedule import DEFAULT_SNAKE_GROUP, Order, Traversal
from repro_torch.kernels import cuda_lib

__all__ = [
    "MASK_VALUE",
    "BLOCK_M",
    "BLOCK_N",
    "FWD_BLOCK_M",
    "FWD_BLOCK_N",
    "DQ_BLOCK_M",
    "DQ_BLOCK_N",
    "DKV_BLOCK_M",
    "DKV_BLOCK_N",
    "KERNEL_TILES",
    "flash_attention_fwd",
    "launch_flash_fwd",
    "flash_attention_bwd",
    "launch_flash_bwd_delta",
    "launch_flash_bwd_dq",
    "launch_flash_bwd_dkv",
    "kernel_traversal",
    "fwd_schedule",
    "fwd_walks",
    "fwd_workers",
    "dkv_schedule",
    "dkv_walks",
]

# Finite mask value of the reference kernels; a row that sees nothing ends
# with lse == MASK_VALUE (``l == 0 -> 1``) and an output of exact zeros.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK_M = 64   # Q rows per block of the plain backward (the CPU path)
BLOCK_N = 64   # KV positions per block of the plain backward
FWD_BLOCK_M = 128   # Q rows per work item of the forward (B2)
FWD_BLOCK_N = 128   # KV positions per tile of the forward
DQ_BLOCK_M = 128    # Q rows per work item of the dQ kernel (B5)
DQ_BLOCK_N = 128    # KV positions per tile of the dQ kernel
DKV_BLOCK_M = 64    # Q rows per streamed tile of the dK/dV kernel (B6)
DKV_BLOCK_N = 128   # KV positions per work item of the dK/dV kernel
# Kernel -> (Q rows, KV positions) of its tiles; the kernels report theirs
# through their ``*_attr`` entries, which ``chip_smoke.py`` holds to these.
KERNEL_TILES = {
    "flash_fwd": (FWD_BLOCK_M, FWD_BLOCK_N),
    "flash_bwd_dq": (DQ_BLOCK_M, DQ_BLOCK_N),
    "flash_bwd_dkv": (DKV_BLOCK_M, DKV_BLOCK_N),
}
# Head dims the kernels take; 80 (zamba2's shared attention) and 96
# (phi-3-vision's) run the 128 layout with the tensor maps' columns D-127
# zero-filled (csrc/flash_fwd.cu).
_HEAD_DIMS = (64, 80, 96, 128)        # the forward (B2)
_BWD_HEAD_DIMS = (64, 80, 96, 128)    # the backward (B4-B6)


def kernel_traversal(
    sq: int, skv: int, n_groups: int, *, kernel: str, order: Order | str, causal: bool,
    window: Optional[int], snake_group: Optional[int] = None,
) -> Traversal:
    """The Traversal CUDA kernel ``kernel`` (a key of ``KERNEL_TILES``) walks
    for these shapes, at its own tiles. The dQ kernel's walks are
    :func:`fwd_walks` of it, the dK/dV kernel's :func:`dkv_walks`."""
    q_block, kv_block = KERNEL_TILES[kernel]
    return Traversal(
        order=order, n_q=-(-sq // q_block), n_kv=-(-skv // kv_block), causal=causal,
        window=window, q_block=q_block, kv_block=kv_block, n_groups=n_groups,
        snake_group=snake_group,
    )


def fwd_schedule(tr: Traversal, n_slices: int,
                 n_workers: int) -> list[list[tuple[int, int]]]:
    """Host model of the persistent forward's work: for each of ``n_workers``
    CTAs, its (slice, folded row) items in the order it walks them; a slice
    is one (batch, kv head). The items are grouped into units of equal
    causal cost, unit p of GQA group grp being Q tile n_q - 1 - p then Q
    tile p (one item when they coincide); units are numbered slice-major and
    dealt round-robin, unit u to worker u % n_workers."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    half = -(-tr.n_q // 2)
    units = []
    for s in range(n_slices):
        for grp in range(tr.n_groups):
            for p in range(half):
                heavy, light = tr.n_q - 1 - p, p
                unit = [(s, grp * tr.n_q + heavy)]
                if light != heavy:
                    unit.append((s, grp * tr.n_q + light))
                units.append(unit)
    return [[item for unit in units[w::n_workers] for item in unit] for w in range(n_workers)]


def fwd_walks(tr: Traversal, n_slices: int, n_workers: int) -> list[list[list[int]]]:
    """What the forward kernel records in ``visit_out`` (n_slices,
    grid_rows, n_kv): the k-th item a worker walks visits
    ``tr.kv_order(q_tile, local_iter=k)``, padded with -1."""
    walks: list[list] = [[None] * tr.grid_rows for _ in range(n_slices)]
    for items in fwd_schedule(tr, n_slices, n_workers):
        for k, (s, i) in enumerate(items):
            row = tr.kv_order(i % tr.n_q, local_iter=k)
            walks[s][i] = row + [-1] * (tr.n_kv - len(row))
    return walks


def dkv_schedule(tr: Traversal, n_slices: int,
                 n_workers: int) -> list[list[tuple[int, int]]]:
    """Host model of the persistent dK/dV kernel's work: for each of
    ``n_workers`` CTAs, its (slice, KV tile) items in the order it takes
    them. Under causal trimming KV tile j is seen by the Q tiles from about
    j upward, so unit p of a slice pairs the heavy tile p with the light
    tile n_kv - 1 - p (one item when they coincide); units are numbered
    slice-major and dealt round-robin, unit u to worker u % n_workers."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    units = []
    for s in range(n_slices):
        for p in range(-(-tr.n_kv // 2)):
            light = tr.n_kv - 1 - p
            units.append([(s, p)] + ([(s, light)] if light != p else []))
    return [[item for unit in units[w::n_workers] for item in unit] for w in range(n_workers)]


def dkv_walks(tr: Traversal, n_slices: int, n_workers: int) -> list[list[list[int]]]:
    """What the dK/dV kernel records in ``visit_out`` (n_slices, n_kv,
    grid_rows): the k-th item a worker takes streams
    ``tr.stream_sweep(kv_tile, local_iter=k)``, folded as ``group * n_q +
    q_tile`` and padded with -1."""
    walks: list[list] = [[None] * tr.n_kv for _ in range(n_slices)]
    for items in dkv_schedule(tr, n_slices, n_workers):
        for k, (s, j) in enumerate(items):
            row = [grp * tr.n_q + qi for grp, qi in tr.stream_sweep(j, local_iter=k)]
            walks[s][j] = row + [-1] * (tr.grid_rows - len(row))
    return walks


def fwd_workers(device) -> int:
    """CTAs each persistent kernel (the forward, dQ and dK/dV) runs on
    ``device``: one per SM (the kernels read the same count with
    ``cudaDevAttrMultiProcessorCount``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_operands(q, k, v, *more, kernel: str = "flash_fwd") -> None:
    """bf16, contiguous, 16-byte aligned q, k, v (and ``more`` tensors of
    q's shape, such as o and dO) on one device, a head dim the kernels
    take, whole GQA groups."""
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel needs a 16-byte aligned {name}")
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    dims = _HEAD_DIMS if kernel == "flash_fwd" else _BWD_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"{kernel} kernel takes head dim in {dims}, got {d}")
    if hq % k.shape[2]:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {k.shape[2]}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    order: Order | str = Order.SAWTOOTH,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    snake_group: Optional[int] = None,
    return_lse: bool = False,
    visit_out: Optional[torch.Tensor] = None,
):
    """Flash attention forward: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D).
    Returns o (B, Sq, Hq, D), and lse (B, Sq, Hq) float32 with
    ``return_lse``. ``visit_out`` (CUDA only): an int32 tensor of shape
    (B*Hkv, G*n_q, n_kv) into which the kernel writes the KV tile ids each
    work item walked, in order, -1 past its range (n_q, n_kv at
    ``FWD_BLOCK_M``, ``FWD_BLOCK_N``; see :func:`fwd_walks`)."""
    order = Order.parse(order)
    if q.device.type == "cpu":
        if visit_out is not None:
            raise ValueError("visit_out records the CUDA kernel's walk; q is on the CPU")
        return flash_attention(
            q, k, v, order=order, causal=causal, window=window, q_block=FWD_BLOCK_M,
            kv_block=FWD_BLOCK_N, scale=scale, snake_group=snake_group, return_lse=return_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_cuda_operands(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device) if return_lse else None
    if b == 0 or sq == 0 or skv == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(MASK_VALUE)
        return (out, lse) if return_lse else out
    g = hq // hkv
    n_q, n_kv = -(-sq // FWD_BLOCK_M), -(-skv // FWD_BLOCK_N)
    _check_visit(visit_out, (b * hkv, g * n_q, n_kv), q.device, "visit_out")
    launch_flash_fwd(q, k, v, out, lse, visit_out, order=order, causal=causal, window=window,
                     scale=scale, snake_group=snake_group)
    return (out, lse) if return_lse else out


def launch_flash_fwd(q, k, v, out, lse=None, visit_out=None, *, order=Order.SAWTOOTH,
                     causal=False, window=None, scale=None, snake_group=None) -> None:
    """Launch the kernel on the current stream into preallocated ``out``
    (like q) and, when given, ``lse`` (B, Sq, Hq) float32 and ``visit_out``;
    the operands are those :func:`flash_attention_fwd` has checked."""
    fn = getattr(cuda_lib.load("flash_fwd"), cuda_lib.KERNELS["flash_fwd"].entry)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if visit_out is None else visit_out.data_ptr(),
            *_launch_args(q, k, order=order, causal=causal, window=window, scale=scale,
                          snake_group=snake_group),
        )
    _raise_on(err, "flash_fwd")


def _check_visit(visit, shape, device, name) -> None:
    if visit is not None and (visit.dtype != torch.int32 or tuple(visit.shape) != shape
                              or not visit.is_contiguous() or visit.device != device):
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor on {device}")


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    order: Order | str = Order.SAWTOOTH,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    snake_group: Optional[int] = None,
    visit_dq_out: Optional[torch.Tensor] = None,
    visit_dkv_out: Optional[torch.Tensor] = None,
):
    """Fused flash backward from the forward's ``o`` (B, Sq, Hq, D) and
    ``lse`` (B, Sq, Hq) float32: returns (dq, dk, dv) for the output
    gradient ``do``. CUDA only: ``visit_dq_out`` (B*Hkv, G*n_q, n_kv) at the
    dQ kernel's tiles and ``visit_dkv_out`` (B*Hkv, n_kv, G*n_q) at the
    dK/dV kernel's, int32, receive the tiles each work item walked (see
    :func:`fwd_walks`, :func:`dkv_walks`)."""
    order = Order.parse(order)
    if q.device.type == "cpu":
        if visit_dq_out is not None or visit_dkv_out is not None:
            raise ValueError("visit outputs record the CUDA kernels' walks; q is on the CPU")
        return _plain_bwd(q, k, v, o, lse, do, order=order, causal=causal, window=window,
                          q_block=BLOCK_M, kv_block=BLOCK_N, scale=scale, snake_group=snake_group)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_cuda_operands(q, k, v, ("o", o), ("do", do), kernel="flash_bwd")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, sq, hq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 {(b, sq, hq)} tensor on {q.device}")
    g = hq // hkv
    n_q, n_kv = -(-sq // DQ_BLOCK_M), -(-skv // DQ_BLOCK_N)
    _check_visit(visit_dq_out, (b * hkv, g * n_q, n_kv), q.device, "visit_dq_out")
    n_q, n_kv = -(-sq // DKV_BLOCK_M), -(-skv // DKV_BLOCK_N)
    _check_visit(visit_dkv_out, (b * hkv, n_kv, g * n_q), q.device, "visit_dkv_out")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    kw = dict(order=order, causal=causal, window=window, scale=scale, snake_group=snake_group)
    launch_flash_bwd_delta(o, do, delta)
    launch_flash_bwd_dq(q, k, v, do, lse, delta, dq, visit_dq_out, **kw)
    launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, visit_dkv_out, **kw)
    return dq, dk, dv


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts[name] += 1


def launch_flash_bwd_delta(o, do, delta) -> None:
    """B4 on the current stream: ``delta`` (B, Sq, Hq) float32 = rowsum(do
    * o); the operands are those :func:`flash_attention_bwd` has checked."""
    fn = getattr(cuda_lib.load("flash_bwd_delta"), cuda_lib.KERNELS["flash_bwd_delta"].entry)
    with torch.cuda.device(o.device):
        err = fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), delta.numel(), o.shape[-1],
                 torch.cuda.current_stream(o.device).cuda_stream)
    _raise_on(err, "flash_bwd_delta")


def _launch_args(q, k, *, order, causal, window, scale, snake_group) -> tuple:
    """The shape, mask, order and stream arguments the attention kernels
    share: B, Sq, Skv, Hq, Hkv, D, causal, window, order, snake, scale,
    stream."""
    b, sq, hq, d = q.shape
    snake = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    if snake < 1:
        raise ValueError(f"snake_group must be >= 1, got {snake_group}")
    return (b, sq, k.shape[1], hq, k.shape[2], d, int(causal),
            -1 if window is None else int(window), cuda_lib.ORDER_CODES[Order.parse(order).value],
            snake, float(d ** -0.5 if scale is None else scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def launch_flash_bwd_dq(q, k, v, do, lse, delta, dq, visit_out=None, *, order=Order.SAWTOOTH,
                        causal=False, window=None, scale=None, snake_group=None) -> None:
    """B5 on the current stream into preallocated ``dq`` (like q)."""
    fn = getattr(cuda_lib.load("flash_bwd_dq"), cuda_lib.KERNELS["flash_bwd_dq"].entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(),
                 None if visit_out is None else visit_out.data_ptr(),
                 *_launch_args(q, k, order=order, causal=causal, window=window, scale=scale,
                               snake_group=snake_group))
    _raise_on(err, "flash_bwd_dq")


def launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, visit_out=None, *,
                         order=Order.SAWTOOTH, causal=False, window=None, scale=None,
                         snake_group=None) -> None:
    """B6 on the current stream into preallocated ``dk``, ``dv`` (like k)."""
    fn = getattr(cuda_lib.load("flash_bwd_dkv"), cuda_lib.KERNELS["flash_bwd_dkv"].entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if visit_out is None else visit_out.data_ptr(),
                 *_launch_args(q, k, order=order, causal=causal, window=window, scale=scale,
                               snake_group=snake_group))
    _raise_on(err, "flash_bwd_dkv")
