"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

``ssd_fwd`` is the port of the JAX package's wrapper of the same name
(``repro.kernels.ssd.ssd_fwd``), with its layouts:

  x (B, S, H, P) bfloat16; dt (B, S, H) float32, post-softplus; a (H,)
  float32; b, c (B, S, N) bfloat16; init_state (B, H, P, N) float32 or
  None (zeros). Returns y (B, S, H, P) in x's dtype and the final state
  (B, H, P, N) float32.

For CUDA tensors it launches ``csrc/ssd.cu`` (B7): one block per (batch,
head), ``blockIdx = b * H + h``, walking the chunks of its sequence in order
with the state resident in shared memory. The kernel takes P = 64, N in {64,
128} and chunks of 128 positions; the wrapper raises on anything else. For
tensors on the CPU it returns the plain version, ``models.ssm.ssd_chunked``.
It never falls back from CUDA to the plain version.

Chunk rule: the wrapper follows ``ssd_chunked``'s, chunks of ``min(chunk,
S)`` positions from position 0. The kernel always tiles 128 positions and
masks those at or past S inside the chunk (dt = 0 there: no update, no
decay), which for S < 128 is the one chunk of S positions, so both give the
same sums up to their order. (The reference's Pallas wrapper rounds a short
sequence's chunk up to a power of two, ``ssd.py:118``: the same math.)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib

__all__ = ["CHUNK", "HEAD_DIM", "STATE_DIMS", "ssd_fwd", "launch_ssd"]

CHUNK = 128           # positions per chunk, the kernel's tile
HEAD_DIM = 64         # P
STATE_DIMS = (64, 128)


def ssd_fwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    init_state: Optional[torch.Tensor] = None,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD forward: (y (B, S, H, P), final state (B, H, P, N) float32)."""
    if x.device.type == "cpu":
        from repro_torch.models.ssm import ssd_chunked  # lazy: models import kernels

        return ssd_chunked(x, dt, a, b, c, chunk=chunk, init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_fwd: unsupported device {x.device}")
    if chunk != CHUNK:
        raise ValueError(f"ssd kernel takes chunk {CHUNK}, got {chunk}")
    _check_cuda_operands(x, dt, a, b, c, init_state)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, final
    if s == 0:
        if init_state is None:
            return y, final.zero_()
        return y, final.copy_(init_state)
    launch_ssd(x, dt, a, b, c, init_state, y, final)
    return y, final


def _check_cuda_operands(x, dt, a, b, c, init_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd kernel takes x (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = (
        ("x", x, torch.bfloat16, (bsz, s, h, p)),
        ("dt", dt, torch.float32, (bsz, s, h)),
        ("a", a, torch.float32, (h,)),
        ("b", b, torch.bfloat16, (bsz, s, n)),
        ("c", c, torch.bfloat16, (bsz, s, n)),
    )
    if init_state is not None:
        want += (("init_state", init_state, torch.float32, (bsz, h, p, n)),)
    for name, t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"ssd kernel takes {dtype} {name}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd kernel: {name} {tuple(t.shape)} does not fit x "
                             f"{tuple(x.shape)} (want {shape})")
        if not t.is_contiguous():
            raise ValueError(f"ssd kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd kernel needs a 16-byte aligned {name}")
    if p != HEAD_DIM:
        raise ValueError(f"ssd kernel takes head dim P = {HEAD_DIM}, got {p}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes state dim N in {STATE_DIMS}, got {n}")
    if bsz * h > 2**31 - 1:
        raise ValueError(f"ssd kernel grid B*H = {bsz * h} too large")


def launch_ssd(x, dt, a, b, c, init_state, y, final) -> None:
    """Launch B7 on the current stream into preallocated ``y`` (like x) and
    ``final`` (B, H, P, N) float32; the operands are those :func:`ssd_fwd`
    has checked (``init_state`` may be None: zeros)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    fn = getattr(cuda_lib.load("ssd"), cuda_lib.KERNELS["ssd"].entry)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if init_state is None else init_state.data_ptr(), y.data_ptr(),
            final.data_ptr(), bsz, s, h, p, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["ssd"] += 1
