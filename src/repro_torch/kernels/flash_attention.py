"""Split-Q flash attention forward: the CUDA kernel's wrapper and its plain
version.

``flash_attention_fwd`` is the port of the JAX package's wrapper of the same
name. For CUDA tensors it launches ``csrc/flash_fwd.cu``: one block per
(batch x kv head, folded row), the folded row ``i`` being GQA group
``i // n_q`` and Q tile ``i % n_q``, KV tiles walked in the Traversal's
order over the row's trimmed range at the kernel's own tile sizes
(``BLOCK_M`` x ``BLOCK_N``). For tensors on the CPU it returns the plain
version, ``repro_torch.core.attention.flash_attention``, at the same tile
sizes and order. It never falls back from CUDA to the plain version.

The tile sizes are the kernel's, not the config's ``q_block``/``kv_block``
(512 there, sized for a TPU's vector memory): a 512 x 128 bf16 K tile alone
would be 128 KB of shared memory. Outputs agree across tile sizes up to
rounding; the visit order is held to ``kernel_traversal`` at the kernel's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import flash_attention
from repro_torch.core.schedule import DEFAULT_SNAKE_GROUP, Order, Traversal
from repro_torch.kernels import cuda_lib

__all__ = [
    "MASK_VALUE",
    "BLOCK_M",
    "BLOCK_N",
    "flash_attention_fwd",
    "launch_flash_fwd",
    "kernel_traversal",
]

# Finite mask value of the reference kernels; a row that sees nothing ends
# with lse == MASK_VALUE (``l == 0 -> 1``) and an output of exact zeros.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK_M = 64   # Q rows per block
BLOCK_N = 64   # KV positions per tile
_HEAD_DIMS = (64, 128)


def kernel_traversal(
    sq: int, skv: int, n_groups: int, *, order: Order | str, causal: bool,
    window: Optional[int], snake_group: Optional[int] = None,
) -> Traversal:
    """The Traversal the CUDA kernel walks for these shapes: its folded row
    ``i`` visits ``kv_order(i % n_q, local_iter=i)``."""
    return Traversal(
        order=order, n_q=-(-sq // BLOCK_M), n_kv=-(-skv // BLOCK_N), causal=causal,
        window=window, q_block=BLOCK_M, kv_block=BLOCK_N, n_groups=n_groups,
        snake_group=snake_group,
    )


def _check_cuda_operands(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd kernel takes bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd kernel needs a 16-byte aligned {name}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dim in {_HEAD_DIMS}, got {d}")
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
    block walked, in order, -1 past its range (n_q, n_kv at ``BLOCK_M``,
    ``BLOCK_N``)."""
    order = Order.parse(order)
    if q.device.type == "cpu":
        if visit_out is not None:
            raise ValueError("visit_out records the CUDA kernel's walk; q is on the CPU")
        return flash_attention(
            q, k, v, order=order, causal=causal, window=window, q_block=BLOCK_M,
            kv_block=BLOCK_N, scale=scale, snake_group=snake_group, return_lse=return_lse,
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
    n_q, n_kv = -(-sq // BLOCK_M), -(-skv // BLOCK_N)
    if g * n_q > 65535:
        raise ValueError(f"flash_fwd grid rows G*n_q = {g * n_q} exceed 65535")
    if visit_out is not None:
        shape = (b * hkv, g * n_q, n_kv)
        if (visit_out.dtype != torch.int32 or tuple(visit_out.shape) != shape
                or not visit_out.is_contiguous() or visit_out.device != q.device):
            raise ValueError(f"visit_out must be a contiguous int32 {shape} tensor on {q.device}")
    launch_flash_fwd(q, k, v, out, lse, visit_out, order=order, causal=causal, window=window,
                     scale=scale, snake_group=snake_group)
    return (out, lse) if return_lse else out


def launch_flash_fwd(q, k, v, out, lse=None, visit_out=None, *, order=Order.SAWTOOTH,
                     causal=False, window=None, scale=None, snake_group=None) -> None:
    """Launch the kernel on the current stream into preallocated ``out``
    (like q) and, when given, ``lse`` (B, Sq, Hq) float32 and ``visit_out``;
    the operands are those :func:`flash_attention_fwd` has checked."""
    order = Order.parse(order)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    snake = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    if snake < 1:
        raise ValueError(f"snake_group must be >= 1, got {snake_group}")
    scale_ = float(d ** -0.5 if scale is None else scale)
    spec = cuda_lib.KERNELS["flash_fwd"]
    fn = getattr(cuda_lib.load("flash_fwd"), spec.entry)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if visit_out is None else visit_out.data_ptr(),
            b, sq, skv, hq, hkv, d, int(causal), -1 if window is None else int(window),
            cuda_lib.ORDER_CODES[order.value], snake, scale_,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["flash_fwd"] += 1
