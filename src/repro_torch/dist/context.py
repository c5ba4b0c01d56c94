"""Context-local activation-sharding rules.

A port of ``repro.dist.context``. Model code annotates intermediate
activations by *role*::

    h = constrain(h, "residual")          # transformer residual stream
    buf = constrain(buf, "moe_buffer")    # (E, C, d) dispatch buffer
    x = constrain(x, "moe_tokens")        # dropless sorted token stream
    logits = constrain(logits, "logits")  # before the loss's gather
    table = constrain(table, "embed_table")  # the embedding as the lookup reads it

Outside an :func:`activation_rules` context (unit tests, CPU runs,
single-device serving) ``constrain`` is an exact no-op: it returns ``x``
itself. Inside one, a role present in the rules is applied to a DTensor:
it is redistributed to the role's placements (the counterpart of
``with_sharding_constraint``). A rule is a spec (:class:`sharding.P`, one
entry a tensor dim, tightened to the tensor's shape as param specs are and
resolved on the DTensor's own mesh: an axis that does not divide its dim
is dropped) or a tuple of placements, one a mesh dim. Plain tensors and
unknown roles pass through: a rules dict only names the activations it
cares about.

The helpers below the rules (``placed_like``, ``grad_placed_like``,
``replicated``, ``reduce_partial``, ``split_last``, ``seq_gathered``,
``gathered_on``) set placements where DTensor's own
choice fails downstream (on torch 2.11 or on fake tensors; ROADMAP §C).
Each is an exact no-op on plain tensors. ``write_local`` writes a step's
new K/V rows or recurrent state into a serving cache in place: into this
rank's shard of a cache placed by ``dist.sharding.distribute_caches``, or
into a plain cache as before; ``write_pages`` writes them into a paged
pool, on this rank's head shard of one placed by
``dist.sharding.distribute_pools``.

``logits`` and ``embed_table`` are the port's own roles: DTensor cannot
reduce the gather of a label's logit from a vocab-sharded dim, nor (on
some torch versions) differentiate a lookup into a vocab-sharded table, so
the sharded train step replicates the vocab dim of both.
"""

from __future__ import annotations

import contextlib
import functools
from contextvars import ContextVar
from typing import Mapping, Optional

import torch

__all__ = ["activation_rules", "cache_layout", "constrain", "current_rules", "gathered_on",
           "is_dtensor", "local", "on_mesh", "placed_as", "placed_like", "grad_placed_like",
           "reduce_partial",
           "replicated", "seq_gathered", "split_last", "whole", "write_local", "write_pages"]

# role -> spec or placements. ContextVar (not a module global) so rules stay
# scoped under async/threaded drivers.
_RULES: ContextVar[Optional[Mapping[str, object]]] = ContextVar(
    "activation_rules", default=None
)
# (mesh, ParallelConfig) the serving caches made in an ``on_mesh(pcfg=)``
# block are placed on, or None.
_CACHES: ContextVar[Optional[tuple]] = ContextVar("cache_layout", default=None)


def current_rules() -> Optional[Mapping[str, object]]:
    """The active role->rule mapping, or None when no context is installed."""
    return _RULES.get()


@contextlib.contextmanager
def activation_rules(rules: Optional[Mapping[str, object]]):
    """Install ``rules`` for the dynamic extent of the block.

    ``rules=None`` (or ``{}``) explicitly disables constraining. Nesting
    replaces (does not merge) the outer rules.
    """
    token = _RULES.set(dict(rules) if rules else None)
    try:
        yield
    finally:
        _RULES.reset(token)


def constrain(x, role: str):
    """Redistribute the DTensor ``x`` to the rule registered for ``role``,
    if any; ``x`` itself otherwise."""
    rules = _RULES.get()
    if not rules:
        return x
    rule = rules.get(role)
    if rule is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.sharding import P, placements, tighten

    if isinstance(rule, P):
        spec = (tuple(rule) + (None,) * (x.ndim - len(rule)))[: x.ndim]
        rule = placements(tighten(tuple(x.shape), spec, x.device_mesh), x.device_mesh)
    if tuple(x.placements) == tuple(rule):
        return x
    return x.redistribute(x.device_mesh, rule)


@contextlib.contextmanager
def on_mesh(mesh, rules: Optional[Mapping[str, object]] = None, *, pcfg=None):
    """The context a step runs in on ``mesh`` (a ``DeviceMesh``): plain
    tensors meeting DTensors (positions, masks, pools) are replicated
    implicitly, the embedding lookup reads its table whole (``embed_table``,
    its gradient going back to the table's shards), and ``rules`` apply, on
    top of those of an enclosing :func:`activation_rules` (the dry-run's
    sequence-sharded residuals). With ``pcfg`` (a ``ParallelConfig``) the
    serving caches a prefill makes in the block are placed by
    ``dist.sharding.cache_shardings`` (:func:`cache_layout`). Without a
    mesh, nothing."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import P

    token = _CACHES.set(None if pcfg is None else (mesh, pcfg))
    try:
        with implicit_replication(), activation_rules({"embed_table": P(None, None),
                                                       **(current_rules() or {}),
                                                       **(rules or {})}):
            yield
    finally:
        _CACHES.reset(token)


def cache_layout() -> dict:
    """``{"mesh": ..., "pcfg": ...}`` inside an ``on_mesh(pcfg=)`` block
    (what a prefill passes to the caches it allocates), ``{}`` elsewhere."""
    got = _CACHES.get()
    return {} if got is None else {"mesh": got[0], "pcfg": got[1]}


def whole(x):
    """The full value of a DTensor ``x`` (every rank of its mesh takes
    part), ``x`` itself otherwise: what model code writes into a buffer
    that every rank holds whole (a KV cache, a pool, a recurrent state),
    which DTensor cannot write into in place."""
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return x.full_tensor()
    return x


@functools.cache
def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False where torch has no distributed
    package)."""
    dt = _dtensor_type()
    return dt is not None and isinstance(x, dt)


def local(x):
    """This rank's block of the DTensor ``x`` (the same memory), ``x``
    itself otherwise."""
    return x.to_local() if is_dtensor(x) else x


def _placements_of(ref) -> tuple:
    """``ref``'s placements, a partial sum replicated."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in ref.placements)


def placed_like(x, ref):
    """The DTensor ``x`` redistributed to the placements of the DTensor
    ``ref`` (same mesh; a partial sum there replicated here), ``x`` itself
    otherwise: undoes a shard DTensor chose for an intermediate that a later
    reshape back to ``ref``'s shape could not follow."""
    dt = _dtensor_type()
    if dt is not None and isinstance(x, dt) and isinstance(ref, dt):
        want = _placements_of(ref)
        if tuple(x.placements) != want:
            return x.redistribute(ref.device_mesh, want)
    return x


def replicated(x):
    """The DTensor ``x`` replicated on every mesh dim (its shards gathered,
    its partial sums reduced; still a DTensor, so autograd and DTensor
    operands around it keep working), ``x`` itself otherwise."""
    dt = _dtensor_type()
    if dt is not None and isinstance(x, dt):
        from torch.distributed.tensor import Replicate

        want = (Replicate(),) * x.device_mesh.ndim
        if tuple(x.placements) != want:
            return x.redistribute(x.device_mesh, want)
    return x


def reduce_partial(x):
    """The DTensor ``x`` with its partial sums reduced (all-reduced, so
    replicated on those mesh dims), ``x`` itself otherwise."""
    return placed_like(x, x)


def split_last(x, n: int, size: int):
    """x (..., n·size) viewed as (..., n, size). On a mesh, a mesh dim that
    shards the last dim into parts that do not hold whole groups of
    ``size`` (n not a multiple of its count: 8 KV heads on a 16-way tensor
    axis) is replicated first, since DTensor cannot split the groups
    otherwise (a no-op off a mesh)."""
    dt = _dtensor_type()
    if dt is not None and isinstance(x, dt):
        from torch.distributed.tensor import Replicate, Shard

        last = x.ndim - 1
        parts, want = 1, []
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim in (last, -1):
                parts *= x.device_mesh.size(i)
                if n % parts:
                    p = Replicate()
            want.append(p)
        if tuple(want) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, tuple(want))
    return x.reshape(*x.shape[:-1], n, size)


def seq_gathered(x):
    """The DTensor activation ``x`` (B, S, ...) with every mesh dim that
    shards its sequence dim (1) replicated, ``x`` itself otherwise: the
    all-gather of Megatron's sequence parallelism before a column-parallel
    product (a flattened sequence shard is a strided one, which DTensor
    cannot plan on fake tensors)."""
    if is_dtensor(x) and x.ndim >= 3:
        from torch.distributed.tensor import Replicate, Shard

        want = tuple(Replicate() if isinstance(p, Shard) and p.dim in (1, 1 - x.ndim) else p
                     for p in x.placements)
        if want != tuple(x.placements):
            return x.redistribute(x.device_mesh, want)
    return x


def gathered_on(tree, dims: tuple):
    """Every DTensor leaf of ``tree`` (nested dicts and lists) with the mesh
    dims named in ``dims`` replicated; the tree itself when ``dims`` is
    empty. A step whose batch those data axes do not divide runs its whole
    batch on every rank of them, as the reference's tightened batch spec
    says: its params are gathered there (FSDP's all-gather), so no
    activation takes a shard of the sequence in the batch's place, and
    their gradients go back to the shards through the redistribution."""
    if not dims:
        return tree
    if isinstance(tree, dict):
        return {k: gathered_on(v, dims) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered_on(v, dims) for v in tree]
    if is_dtensor(tree):
        from torch.distributed.tensor import Replicate

        names = tree.device_mesh.mesh_dim_names
        want = tuple(Replicate() if names[i] in dims else p
                     for i, p in enumerate(tree.placements))
        if want != tuple(tree.placements):
            return tree.redistribute(tree.device_mesh, want)
    return tree


def write_local(dst, val, rows=None) -> None:
    """Write ``val`` into the serving-cache leaf ``dst`` in place: the whole
    of it (a recurrent state), or with ``rows`` (s,) int64, a device tensor
    of consecutive cache rows, ``val`` (B, s, ...) at those rows of dim 1.

    A plain ``dst`` (every rank holds it whole) takes the whole value of
    ``val`` (:func:`whole`) as before: on one device, exactly the write it
    always was. A DTensor ``dst`` (placed by
    ``dist.sharding.distribute_caches``) is written on this rank's shard
    only, from ``val``'s block at the same placements (a projection's
    output is there already, so nothing moves). Where a mesh dim shards the
    rows (the sequence split), this rank writes only those of ``rows`` in
    its range: a window of ``min(s, rows here)`` consecutive local rows
    placed from ``rows[0]`` on the device, holding ``val``'s rows where they
    land and the rows' old values elsewhere, so a captured step reads no
    host value and no two writes meet."""
    if not is_dtensor(dst):
        val = whole(val)
        if rows is None:
            dst.copy_(val)
        else:
            dst.index_copy_(1, rows, val.to(dst.dtype))
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = dst.device_mesh
    seq = [i for i, p in enumerate(dst.placements)
           if rows is not None and isinstance(p, Shard) and p.dim == 1]
    want = tuple(Replicate() if i in seq else p for i, p in enumerate(dst.placements))
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    val = val.redistribute(mesh, want).to_local().to(dst.dtype)
    local = dst.to_local()
    if rows is None:
        local.copy_(val)
        return
    if not seq:
        local.index_copy_(1, rows, val)
        return
    n_local, s = local.shape[1], val.shape[1]
    off = 0
    for i in seq:  # this rank's first row: its coordinate on each splitting dim
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    off *= n_local
    w = min(s, n_local)
    start = torch.clamp(rows[:1] - off, 0, n_local - w)            # (1,) on the device
    here = start + torch.arange(w, device=rows.device)             # local rows written
    src = here + off - rows[:1]                                    # val's row for each
    keep = (src >= 0) & (src < s)
    new = val.index_select(1, torch.clamp(src, 0, s - 1))
    old = local.index_select(1, here)
    mask = keep.reshape((1, w) + (1,) * (val.ndim - 2))
    local.index_copy_(1, here, torch.where(mask, new, old))


def placed_as(val, dst):
    """``val`` as the pool leaf ``dst`` takes it: for a DTensor ``dst`` a
    DTensor at ``dst``'s placements (a partial sum reduced, a head shard
    kept where it is; a plain ``val`` is taken as every rank's whole
    value), for a plain ``dst`` the whole value (:func:`whole`)."""
    if not is_dtensor(dst):
        return whole(val)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dst.device_mesh
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    want = tuple(dst.placements)
    return val if tuple(val.placements) == want else val.redistribute(mesh, want)


def write_pages(dst, val, pages, offsets) -> None:
    """Write ``val`` (B, C, H, ...) into the pool leaf ``dst`` (n_pages,
    page, H, ...) in place: row (b, t) at page ``pages[b, t]``, offset
    ``offsets[b, t]`` ((B, C) int64 device tensors, so a captured step
    reads no host value). Duplicate indices (the invalid rows sent to the
    dummy page 0) land in no fixed order.

    A plain ``dst`` (every rank holds it whole) takes the whole value of
    ``val``: on one device, exactly the write it always was. A DTensor
    ``dst`` (placed by ``dist.sharding.distribute_pools``, its heads on the
    tensor axis) is written on this rank's head shard only, from ``val``'s
    block at the same placements (:func:`placed_as`): ``val``'s dims after
    the first two are ``dst``'s, so a projection's output is there already
    and nothing moves."""
    local(dst)[pages, offsets] = local(placed_as(val, dst)).to(dst.dtype)


class _GradPlacedLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, _placements_of(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def grad_placed_like(x):
    """``x`` unchanged, its gradient redistributed to ``x``'s placements
    (:func:`placed_like` for the backward) where ``x`` is a DTensor that
    needs one; ``x`` itself otherwise."""
    dt = _dtensor_type()
    if dt is not None and isinstance(x, dt) and x.requires_grad:
        return _GradPlacedLike.apply(x)
    return x
