"""Device-dispatched ops that the model layers call.

A port of ``repro.kernels.ops``: ``attention`` (the full-sequence forward
of ``LM.prefill``), ``attention_decode`` (contiguous single-token decode
and ragged paged chunks) and ``ssd`` (the Mamba-2 chunked scan); and
``ragged_dot``, the MoE's grouped product (the reference's
``jax.lax.ragged_dot``, which XLA compiles outside any Pallas kernel).
``impl``:

  * ``"auto"``      — by the tensors' device: the CUDA kernel for CUDA
    tensors, the plain PyTorch version for CPU tensors;
  * ``"cuda"``      — the hand-written kernel (CUDA tensors only);
  * ``"torch"``     — the plain PyTorch version (blockwise, traversal
    order kept) on any device;
  * ``"reference"`` — the full-materialization oracle (small shapes);
  * ``"recompute"`` — ``attention`` only: the plain blockwise forward, and a
    backward that differentiates through that same forward run again (the
    counterpart of the reference's ``impl="jnp"``). It runs no kernel on any
    device, and ``auto`` never picks it; decode treats it as ``torch``.

The JAX package's backend names (``pallas``, ``pallas_interpret``, ``xla``,
``jnp``) are not impls of the port and raise.

``attention`` is a ``torch.autograd.Function`` (the reference's
``custom_vjp``). When a gradient is needed, its forward also returns the
per-row log-sum-exp and saves ``(q, k, v, o, lse)``, and the backward is the
fused flash backward from those residuals, without re-running the forward:
the three CUDA kernels (delta, dQ, dK/dV) for ``cuda``, the plain blockwise
backward at ``bwd_q_block``/``bwd_kv_block`` for ``torch``. ``reference``
recomputes through the full-materialization oracle under autograd, and
``recompute`` through the plain blockwise forward: both save only ``(q, k,
v)``, at the cost of one more attention pass a backward. Serving runs under
``torch.no_grad`` and saves nothing.

``ssd`` is a ``torch.autograd.Function`` too (the reference's
``custom_vjp``): ``cuda`` runs kernel B7 (``kernels.ssd``), ``torch`` the
plain chunked scan (``models.ssm.ssd_chunked``) and ``reference`` the
sequential oracle (``kernels.ref.ssd_ref``). The JAX package has no backward
kernel for the SSD, so neither has the port: whatever the forward impl, the
backward re-runs ``ssd_chunked`` under autograd on the saved inputs, as the
reference's does (``repro/kernels/ops.py:316-321``).

``rope_kv_write`` is the paged decode step's attention prologue: q and k
roped and the K/V written into the pools, one launch of the hand-written
kernel for CUDA tensors (``csrc/rope_kv_write.cu``), the composed ops it
fuses (``models.layers.rope_rotate`` and the pool's index write) for CPU
tensors and for ``torch``; ``reference`` and ``recompute`` are ``torch``.

``ragged_dot`` takes ``auto``, ``cuda`` and ``torch`` only: ``cuda`` is one
``torch.nn.functional.grouped_mm`` (bf16, offsets on the device; a library
call, counted in ``cuda_lib.library_counts`` apart from the hand-written
kernels), ``torch`` a masked product per group that reads no value on the
host, so a captured step could hold either. Both return zeros for the rows
past the last group when the sizes sum to less than M, as
``jax.lax.ragged_dot`` does (``grouped_mm`` leaves them unwritten; a
device-side mask zeroes them).
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.attention import (
    decode_attention,
    flash_attention,
    flash_attention_bwd,
    merge_decode_partials,
)
from repro_torch.core.schedule import Order
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels.flash_decode import flash_decode_fwd
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref
from repro_torch.kernels.ssd import ssd_fwd

__all__ = ["attention", "attention_decode", "rope_kv_write", "ssd", "ragged_dot"]

_IMPLS = ("auto", "cuda", "torch", "reference")
_VALID = {"attention": _IMPLS + ("recompute",), "ragged_dot": ("auto", "cuda", "torch")}
_JAX_IMPLS = ("pallas", "pallas_interpret", "xla", "jnp")


def _resolve(impl: str, q: torch.Tensor, what: str) -> str:
    valid = _VALID.get(what, _IMPLS)
    if impl in _JAX_IMPLS:
        raise ValueError(
            f"unknown {what} impl {impl!r}: that is a backend of the JAX package; "
            f"the port's impls are {valid}"
        )
    if impl not in valid:
        raise ValueError(f"unknown {what} impl {impl!r}; valid: {valid}")
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    if impl == "cuda" and not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def _recompute_fn(cfg, kw):
    """The forward that impls ``reference`` and ``recompute`` differentiate
    in their backward (and run as their forward)."""
    if cfg["impl"] == "reference":
        return lambda q, k, v: flash_attention_ref(q, k, v, causal=kw["causal"],
                                                   window=kw["window"], scale=kw["scale"])
    return lambda q, k, v: flash_attention(q, k, v, q_block=cfg["q_block"],
                                           kv_block=cfg["kv_block"],
                                           score_dtype=cfg["score_dtype"], **kw)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg):
        impl, grad = cfg["impl"], cfg["grad"]
        kw = dict(order=cfg["order"], causal=cfg["causal"], window=cfg["window"],
                  scale=cfg["scale"], snake_group=cfg["snake_group"])
        ctx.cfg, ctx.kw = cfg, kw
        if impl in ("reference", "recompute"):
            if grad:
                ctx.save_for_backward(q, k, v)
            return _recompute_fn(cfg, kw)(q, k, v)
        if impl == "cuda":
            out = kflash.flash_attention_fwd(q, k, v, return_lse=grad, **kw)
        else:
            out = flash_attention(q, k, v, q_block=cfg["q_block"], kv_block=cfg["kv_block"],
                                  score_dtype=cfg["score_dtype"], return_lse=grad, **kw)
        if not grad:
            return out
        o, lse = out
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad):
        cfg, kw = ctx.cfg, ctx.kw
        if cfg["impl"] in ("reference", "recompute"):
            q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
            with torch.enable_grad():
                out = _recompute_fn(cfg, kw)(q, k, v)
                dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
            return dq, dk, dv, None
        q, k, v, o, lse = ctx.saved_tensors
        if cfg["impl"] == "cuda":
            dq, dk, dv = kflash.flash_attention_bwd(q, k, v, o, lse, grad.contiguous(), **kw)
        else:
            dq, dk, dv = flash_attention_bwd(
                q, k, v, o, lse, grad, q_block=cfg["bwd_q_block"], kv_block=cfg["bwd_kv_block"],
                score_dtype=cfg["score_dtype"], **kw,
            )
        return dq, dk, dv, None


def _mesh_of(*ts):
    """The mesh of the first DTensor among ``ts``, or None when none is one
    (no mesh: the call runs as it always has)."""
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    for t in ts:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def _local_placements(t, mesh, *, batch: bool, heads: tuple = ()) -> tuple:
    """The placements a kernel's operands take on each rank: a mesh dim that
    shards the batch dim (0) of ``t`` stays on it where ``batch``; one that
    shards the head dim (2) stays on it where every head count in ``heads``
    divides its size (GQA groups then stay whole on a rank); every other
    mesh dim is replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    given = t.placements if isinstance(t, DTensor) else (Replicate(),) * mesh.ndim
    out = []
    for i, pl in enumerate(given):
        n = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == 0 and batch:
            out.append(pl)
        elif isinstance(pl, Shard) and pl.dim == 2 and heads and all(h % n == 0 for h in heads):
            out.append(pl)
        else:
            out.append(Replicate())
    return tuple(out)


def _to_local(t, mesh, pl=None):
    """This rank's block of ``t`` at placements ``pl`` (default: whole).
    ``t`` is a DTensor, or a plain tensor every rank holds whole (an index,
    a length, a pool); anything else passes through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, torch.Tensor):
        return t
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, rep, run_check=False)
    return t.redistribute(mesh, pl or rep).to_local()


def _from_local(t, mesh, pl=None):
    """The DTensor of this rank's block ``t`` at placements ``pl`` (default:
    every rank holds it whole)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, pl or (Replicate(),) * mesh.ndim, run_check=False)


def _blocks(names, pl) -> tuple:
    """``_on_local_blocks``'s plan: the operands ``names`` and the output
    at placements ``pl``."""
    return dict.fromkeys(names, pl), pl


def _on_local_blocks(plan):
    """A kernel boundary under a mesh: when any argument is a DTensor, the
    decorated op runs on this rank's local blocks and its output (each
    output of a tuple) comes back as a DTensor. ``plan(mesh, **arguments)``
    gives ``(placements by argument name, the output's placements)``; an
    argument it does not name is taken whole. Without a DTensor the op runs
    as it always has."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def run(*args, **kw):
            mesh = _mesh_of(*args, *kw.values())
            if mesh is None:
                return fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            pls, out_pl = plan(mesh, **bound.arguments)
            for name, t in bound.arguments.items():
                bound.arguments[name] = _to_local(t, mesh, pls.get(name))
            out = fn(*bound.args, **bound.kwargs)
            if isinstance(out, tuple):
                return tuple(_from_local(o, mesh, out_pl) for o in out)
            return _from_local(out, mesh, out_pl)

        return run

    return wrap


@_on_local_blocks(lambda mesh, q, k, **_: _blocks(
    "qkv", _local_placements(q, mesh, batch=True, heads=(q.shape[2], k.shape[2]))))
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    order: Order | str = Order.SAWTOOTH,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_block: int = 256,
    kv_block: int = 256,
    impl: str = "auto",
    score_dtype: str = "float32",
    bwd_q_block: Optional[int] = None,
    bwd_kv_block: Optional[int] = None,
    snake_group: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention, layout (B, S, H, D); GQA via Hq > Hkv. ``q_block``
    and ``kv_block`` tile the plain version; the CUDA kernels use their own
    tiles. ``bwd_q_block``/``bwd_kv_block`` tile the plain backward
    (default: the forward's). ``snake_group`` sizes the ``block_snake``
    reversal window.

    DTensor operands (a step under a mesh) run on each rank's local block:
    batch shards stay, head shards stay where the head counts divide them,
    the rest is replicated, and the same kernel runs on the block as on a
    whole tensor; the output is a DTensor of those placements."""
    cfg = dict(
        impl=_resolve(impl, q, "attention"), order=Order.parse(order), causal=causal,
        window=window, scale=scale, q_block=q_block, kv_block=kv_block,
        bwd_q_block=bwd_q_block or q_block, bwd_kv_block=bwd_kv_block or kv_block,
        score_dtype=score_dtype, snake_group=snake_group,
        grad=torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)),
    )
    return _Attention.apply(q, k, v, cfg)


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
    fold=None,
) -> torch.Tensor:
    """Decode attention vs a KV cache. Contiguous (no ``block_table``): q
    (B, 1, Hq, D) against caches (B, S_max, Hkv, D) with valid length
    ``cache_len``. Paged: ragged q (B, C, Hq, D) against pools (n_pages,
    page, Hkv, D) through ``block_table`` (B, n_blocks), pages visited in
    schedule order (``order_group`` overrides ``order``; ``fold``, the
    walk folded once for a step, overrides both). ``reference``
    computes what ``torch`` does (the reference's decode oracle is the
    same function), and so does ``recompute``, whose only difference from
    ``torch`` is its backward.

    Under a mesh (DTensor operands) each rank runs on its local blocks
    (:func:`_decode_on_mesh`): over a cache placed by
    ``dist.sharding.cache_shardings``, on its batch and head shards, and
    where the cache's sequence is split, on its slice, the ranks' partial
    results merged by log-sum-exp; over a pool placed by
    ``dist.sharding.pool_shardings``, on its local head shard; over a plain
    pool or cache, on its head shard; the indices and lengths whole."""
    impl = _resolve("torch" if impl == "recompute" else impl, q, "decode")
    kw = dict(
        window=window, scale=scale, block_table=block_table, q_lens=q_lens, order=order,
        snake_group=snake_group, order_group=order_group, fold=fold,
    )
    mesh = _mesh_of(q, k_cache, v_cache)
    if mesh is not None:
        return _decode_on_mesh(mesh, impl, q, k_cache, v_cache, cache_len, kw)
    return _decode(impl, q, k_cache, v_cache, cache_len, kw)


def _decode(impl, q, k_cache, v_cache, cache_len, kw, return_lse=False):
    if impl == "cuda":
        return flash_decode_fwd(q, k_cache, v_cache, cache_len, return_lse=return_lse, **kw)
    return decode_attention(q, k_cache, v_cache, cache_len, return_lse=return_lse, **kw)


def _decode_on_mesh(mesh, impl, q, k_cache, v_cache, cache_len, kw):
    """``attention_decode`` on each rank's local blocks. The plan follows
    the cache's placements, one mesh dim at a time: a batch shard (dim 0)
    keeps q, the lengths and the output on this rank's rows; a head shard
    (dim 2) keeps q and the output on this rank's heads; a sequence shard
    (dim 1, fewer KV heads than the tensor axis) gives this rank a slice of
    the positions, on which it decodes every head of its rows with its
    local lengths ``clamp(len - offset, 0, S_local)`` and an lse, and the
    slices' results are all-gathered over those mesh dims and merged in
    float32 (``core.attention.merge_decode_partials``). A placed pool
    (:func:`_paged_on_mesh`) is read on this rank's head shard. A plain
    cache or pool (every rank holds it whole) is read on this rank's head
    shard, as q's placements allow, with the indices and lengths whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rep = (Replicate(),) * mesh.ndim
    if not isinstance(k_cache, DTensor):
        pl = _local_placements(q, mesh, batch=False, heads=(q.shape[2], k_cache.shape[2]))
        o = _decode(impl, _to_local(q, mesh, pl), _to_local(k_cache, mesh, pl),
                    _to_local(v_cache, mesh, pl), _to_local(cache_len, mesh),
                    {k: _to_local(v, mesh) for k, v in kw.items()})
        return _from_local(o, mesh, pl)
    if kw["block_table"] is not None:
        return _paged_on_mesh(mesh, impl, q, k_cache, v_cache, cache_len, kw)
    q_pl, len_pl, split = [], [], []
    for i, p in enumerate(k_cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            split.append(i)
            p = Replicate()
        q_pl.append(p)
        len_pl.append(p if isinstance(p, Shard) and p.dim == 0 else Replicate())
    q_pl = tuple(q_pl)
    lens = cache_len
    if not isinstance(lens, torch.Tensor):
        lens = torch.as_tensor(lens, dtype=torch.int32, device=k_cache.device)
    lens = _to_local(lens, mesh, tuple(len_pl) if lens.ndim else None)
    kl, vl = k_cache.to_local(), _to_local(v_cache, mesh, tuple(k_cache.placements))
    ql = _to_local(q, mesh, q_pl)
    local_kw = {k: _to_local(v, mesh) for k, v in kw.items()}
    if not split:
        return _from_local(_decode(impl, ql, kl, vl, lens, local_kw), mesh, q_pl)
    if kw["window"] is not None:
        raise ValueError("a sequence-split cache takes no window: the ring buffer of a "
                         "windowed cache holds the window already")
    n_local = kl.shape[1]
    part = 0
    for i in split:  # this rank's slice: its coordinate on each splitting dim
        part = part * mesh.size(i) + mesh.get_local_rank(i)
    local_lens = torch.clamp(lens - part * n_local, 0, n_local).to(torch.int32)
    o, lse = _decode(impl, ql, kl, vl, local_lens, local_kw, return_lse=True)
    b, _, hq, d = o.shape
    packed = torch.cat([o.float().reshape(b, hq * d), lse], dim=1)[None]
    gather_pl = tuple(Shard(0) if i in split else Replicate() for i in range(mesh.ndim))
    parts = DTensor.from_local(packed, mesh, gather_pl, run_check=False)
    parts = parts.redistribute(mesh, rep).to_local()            # (n, B, Hq (D + 1))
    merged, _ = merge_decode_partials(parts[:, :, :hq * d].reshape(-1, b, 1, hq, d),
                                      parts[:, :, hq * d:])
    return _from_local(merged.to(o.dtype), mesh, q_pl)


def _paged_on_mesh(mesh, impl, q, k_pool, v_pool, cache_len, kw):
    """B1 (or the plain version) on this rank's head shard of a pool placed
    by ``dist.sharding.distribute_pools``: q's local heads, Hq/t against
    the pool's Hkv/t (whole GQA groups, since t divides Hkv), the block
    table, lengths, ``q_lens`` and ``fold`` whole; the output a DTensor on
    those heads. A pool's dim 0 is pages and dim 1 in-page offsets, not a
    batch or a sequence, so a pool placed any other way raises."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(k_pool.placements)
    heads = all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 2) for p in pl)
    if not heads or tuple(v_pool.placements) != pl:
        raise ValueError(f"a paged pool splits its KV heads (Shard(2) of (n_pages, page, Hkv, "
                         f"D)) or nothing; got k {pl}, v {tuple(v_pool.placements)}")
    o = _decode(impl, _to_local(q, mesh, pl), k_pool.to_local(), v_pool.to_local(),
                _to_local(cache_len, mesh), {k: _to_local(v, mesh) for k, v in kw.items()})
    return _from_local(o, mesh, pl)


def rope_kv_write(q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len, *,
                  impl: str = "auto") -> torch.Tensor:
    """The paged decode step's attention prologue, in place: q (B, C, Hq,
    D) and k (B, C, Hkv, D) rotated by the half-split RoPE of ``cos`` and
    ``sin`` (B, C, D // 2) float32 (``models.layers.rope_angles``), in
    float32 and rounded to their dtype; q rotated in its own buffer
    (returned), the rotated k and v written into the pools ``k_pages`` and
    ``v_pages`` (n_pages, page, Hkv, D) at the slots ``phys``, ``offset``
    (B, C) int64 (``models.transformer._page_slots``). Rows ``t >=
    q_len[b]`` are sent to the dummy page 0 by ``phys``: the plain version
    writes them there, the kernel writes nothing for them. Every q row is
    rotated. The caller owns q's buffer: nothing else may read it unroped."""
    impl = _resolve("torch" if impl in ("recompute", "reference") else impl, q, "rope_kv_write")
    if impl == "cuda":
        return _launch_rope_kv_write(q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len)
    return _rope_kv_write_plain(q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len)


def _rope_kv_write_plain(q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len):
    """:func:`rope_kv_write` as the composed ops it fuses (``q_len`` is
    in ``phys`` already)."""
    from repro_torch.models.layers import rope_rotate  # lazy: models import this module

    q.copy_(rope_rotate(q, cos, sin))
    k_pages[phys, offset] = rope_rotate(k, cos, sin).to(k_pages.dtype)
    v_pages[phys, offset] = v.to(v_pages.dtype)
    return q


def _launch_rope_kv_write(q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len):
    b, c, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    for name, t, dtype, shape in (
        ("q", q, torch.bfloat16, (b, c, hq, d)), ("k", k, torch.bfloat16, (b, c, hkv, d)),
        ("v", v, torch.bfloat16, (b, c, hkv, d)),
        ("k_pages", k_pages, torch.bfloat16, tuple(k_pages.shape)),
        ("v_pages", v_pages, torch.bfloat16, tuple(k_pages.shape)),
        ("cos", cos, torch.float32, (b, c, d // 2)), ("sin", sin, torch.float32, (b, c, d // 2)),
        ("phys", phys, torch.int64, (b, c)), ("offset", offset, torch.int64, (b, c)),
        ("q_len", q_len, torch.int32, (b,)),
    ):
        if t.device != q.device:
            raise ValueError(f"rope_kv_write: {name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"rope_kv_write kernel takes a contiguous {dtype} {name} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if d % 16:
        raise ValueError(f"rope_kv_write kernel takes a head dim that 16 divides, got {d}")
    if b * c == 0:
        return q
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), phys.data_ptr(), offset.data_ptr(), q_len.data_ptr(),
            b, c, hq, hkv, d, page, torch.cuda.current_stream(q.device).cuda_stream)
    lib = cuda_lib.load("rope_kv_write")
    with torch.cuda.device(q.device):
        err = getattr(lib, cuda_lib.KERNELS["rope_kv_write"].entry)(*args)
    if err != 0:
        raise RuntimeError(f"rope_kv_write kernel launch failed: cudaError_t {err}")
    cuda_lib.launch_counts["rope_kv_write"] += 1
    return q


def _ssd_chunked(x, dt, a, b, c, init_state, chunk):
    from repro_torch.models.ssm import ssd_chunked  # lazy: models import this module

    return ssd_chunked(x, dt, a, b, c, chunk=chunk, init_state=init_state)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, init_state, impl, chunk, grad):
        ctx.chunk = chunk
        if grad:
            ctx.save_for_backward(x, dt, a, b, c, init_state)
        if impl == "cuda":
            # The kernel takes contiguous operands; x, b and c are slices of
            # the in-projection's output.
            return ssd_fwd(x.contiguous(), dt.contiguous(), a.contiguous(), b.contiguous(),
                           c.contiguous(), chunk=chunk,
                           init_state=None if init_state is None else init_state.contiguous())
        if impl == "reference":
            return ssd_ref(x, dt, a, b, c, init_state=init_state)
        return _ssd_chunked(x, dt, a, b, c, init_state, chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        # A None initial state (zeros) is saved as None and gets no gradient.
        saved = [None if t is None else t.detach().requires_grad_(True)
                 for t in ctx.saved_tensors]
        inputs = [t for t in saved if t is not None]
        with torch.enable_grad():
            y, s = _ssd_chunked(*saved, ctx.chunk)
            grads = iter(torch.autograd.grad((y, s), inputs, (gy, gs), allow_unused=True))
        return (*(None if t is None else next(grads) for t in saved), None, None, None)


@_on_local_blocks(lambda mesh, x, **_: _blocks(
    ("x", "dt", "b", "c", "init_state"), _local_placements(x, mesh, batch=True)))
def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    init_state: Optional[torch.Tensor] = None,
    chunk: int = 128,
    impl: str = "auto",
):
    """Mamba-2 SSD scan: (y (B, S, H, P) in x's dtype, final state (B, H,
    P, N) float32). Layouts as ``kernels.ref.ssd_ref``; ``init_state`` None
    means zeros, and goes to the impl as None: B7 then starts from zeros
    without reading a state. Under a mesh (DTensor operands) each rank
    scans its batch shard."""
    impl = _resolve(impl, x, "ssd")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, a, b, c, init_state))
    return _SSD.apply(x, dt, a, b, c, init_state, impl, chunk, grad)


def _ragged_dot_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Each row's product with its group's matrix, one masked product a
    group: the row-to-group map comes from the offsets on the device, so
    nothing is read on the host. Rows past the last group stay zero."""
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int64)
    group = torch.searchsorted(offs, torch.arange(x.shape[0], device=x.device), right=True)
    out = x.new_zeros((x.shape[0], w.shape[2]))
    for g in range(w.shape[0]):
        out = torch.where((group == g)[:, None], x @ w[g], out)
    return out


@_on_local_blocks(lambda mesh, **_: ({}, None))
def ragged_dot(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
               impl: str = "auto") -> torch.Tensor:
    """Grouped product, as ``jax.lax.ragged_dot``: x (M, K) with its rows
    sorted by group, w (G, K, N), group_sizes (G,) ints summing to at most
    M -> (M, N) in x's dtype, rows of group g times ``w[g]``. ``cuda`` takes
    bf16 CUDA tensors only and raises on anything else. Under a mesh
    (DTensor operands) every rank runs the whole product on its replicas."""
    impl = _resolve(impl, x, "ragged_dot")
    if impl == "torch":
        return _ragged_dot_plain(x, w, group_sizes)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"ragged_dot impl='cuda' takes bfloat16 operands, got {x.dtype} and "
                         f"{w.dtype}")
    if not (w.is_cuda and group_sizes.is_cuda):
        raise ValueError("ragged_dot impl='cuda' needs w and group_sizes on the card too")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    cuda_lib.library_counts["ragged_dot"] += 1
    return _zero_past_groups(F.grouped_mm(x, w, offs=offs), offs)


def _zero_past_groups(out: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``out`` with its rows at or past ``offs[-1]`` (past the last group,
    which ``grouped_mm`` leaves unwritten) set to zero, as
    ``jax.lax.ragged_dot`` returns them: a mask made on the device, so
    nothing is read on the host."""
    rows = torch.arange(out.shape[0], device=out.device)
    return out.masked_fill((rows >= offs[-1])[:, None], 0)
