"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

``ssd_fwd`` is the port of the JAX package's wrapper of the same name
(``repro.kernels.ssd.ssd_fwd``), with its layouts:

  x (B, S, H, P) bfloat16; dt (B, S, H) float32, post-softplus; a (H,)
  float32; b, c (B, S, N) bfloat16; init_state (B, H, P, N) float32 or
  None (zeros). Returns y (B, S, H, P) in x's dtype and the final state
  (B, H, P, N) float32.

For CUDA tensors it launches ``csrc/ssd.cu`` (B7), Hopper's TMA, wgmma and
mbarriers: persistent CTAs (:func:`ssd_grid`) take the work items, one
(batch row, head) each with all P = 64 columns, in order (:func:`ssd_walks`),
each walking its chunks in order with the state in accumulator registers; a
two-stage ring brings the next chunk's x, b and c by TMA and its dt by
cp.async while the current chunk computes; every product runs on the tensor
cores, the float32 operands (W, S, the scaled x) split into bf16 hi and lo
parts. The kernel takes P = 64, N in {64, 128} and chunks of 128 positions;
the wrapper raises on anything else. For tensors on the CPU it returns the
plain version, ``models.ssm.ssd_chunked``. It never falls back from CUDA to
the plain version.

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

__all__ = ["CHUNK", "HEAD_DIM", "STATE_DIMS", "ssd_fwd", "launch_ssd", "ssd_grid", "ssd_walks",
           "ssd_kernel_attr"]

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
    visit_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD forward: (y (B, S, H, P), final state (B, H, P, N) float32).

    On CUDA, ``visit_out``, an int32 tensor (grid, ceil(B H / grid)) at
    :func:`ssd_grid`'s grid, takes each CTA's items as the kernel walked
    them (:func:`ssd_walks` is the host model)."""
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
    if visit_out is not None:
        grid = ssd_grid(bsz, h, _sms(x.device))
        want = (grid, -(-bsz * h // grid))
        if (visit_out.dtype != torch.int32 or tuple(visit_out.shape) != want
                or not visit_out.is_contiguous() or visit_out.device != x.device):
            raise ValueError(f"visit_out must be a contiguous int32 {want} tensor on {x.device}")
    launch_ssd(x, dt, a, b, c, init_state, y, final, visit=visit_out)
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


def launch_ssd(x, dt, a, b, c, init_state, y, final, *, visit=None) -> None:
    """Launch B7 on the current stream into preallocated ``y`` (like x) and
    ``final`` (B, H, P, N) float32; the operands are those :func:`ssd_fwd`
    has checked (``init_state`` may be None: zeros). With ``visit``, the
    recording entry (as :func:`ssd_fwd` describes it)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lib = cuda_lib.load("ssd")
    with torch.cuda.device(x.device):
        args = (
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if init_state is None else init_state.data_ptr(), y.data_ptr(),
            final.data_ptr(), bsz, s, h, p, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if visit is None:
            err = getattr(lib, cuda_lib.KERNELS["ssd"].entry)(*args)
        else:
            err = lib.ssd_fwd_bf16_visit(*args, visit.data_ptr())
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["ssd"] += 1


def ssd_grid(bsz: int, heads: int, sms: int) -> int:
    """B7's persistent grid: one CTA an SM, at most one a work item
    (``launch`` in ``csrc/ssd.cu``)."""
    return max(1, min(sms, bsz * heads))


def ssd_walks(bsz: int, heads: int, grid: int) -> torch.Tensor:
    """What B7 records in ``visit_out``: (grid, ceil(B H / grid)) int32,
    CTA w's k-th item w + k * grid, -1 past its last. Item u is (batch row
    u // H, head u % H) with all P columns: an item's chunks carry the
    state, and the state update's 64 rows p are wgmma's least M, so a head
    is not cut smaller; the heads of one batch row are adjacent, so the
    CTAs in flight at once share its b and c."""
    n = bsz * heads
    ks = -(-n // grid)
    u = torch.arange(grid)[:, None] + grid * torch.arange(ks)[None, :]
    return torch.where(u < n, u, torch.full_like(u, -1)).to(torch.int32)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ssd_kernel_attr(bsz: int, heads: int, n: int, device=None) -> dict:
    """What B7's launch at (B, H, N) runs: registers (at launch, before
    setmaxnreg moves them) and local (spill) bytes a thread, dynamic shared
    memory and threads a CTA, the cluster size and the grid's CTAs."""
    import ctypes

    vals = (ctypes.c_int * 6)(*([-1] * 6))
    with torch.cuda.device(device):
        err = cuda_lib.load("ssd").ssd_attr(bsz, heads, n, vals)
    if err:
        raise RuntimeError(f"ssd_attr({bsz}, {heads}, {n}) returned cudaError_t {err}")
    return {"registers": vals[0], "dynamic_smem_bytes": vals[1], "threads": vals[2],
            "local_bytes": vals[3], "cluster_size": vals[4], "ctas": vals[5]}
