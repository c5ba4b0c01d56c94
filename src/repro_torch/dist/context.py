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
``replicated``, ``reduce_partial``, ``split_last``) set placements where
DTensor's own choice fails downstream (on torch 2.11 or on fake tensors;
ROADMAP §C). Each is an exact no-op on plain tensors.

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

__all__ = ["activation_rules", "constrain", "current_rules", "on_mesh", "placed_like",
           "grad_placed_like", "reduce_partial", "replicated", "split_last", "whole"]

# role -> spec or placements. ContextVar (not a module global) so rules stay
# scoped under async/threaded drivers.
_RULES: ContextVar[Optional[Mapping[str, object]]] = ContextVar(
    "activation_rules", default=None
)


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
def on_mesh(mesh, rules: Optional[Mapping[str, object]] = None):
    """The context a step runs in on ``mesh`` (a ``DeviceMesh``): plain
    tensors meeting DTensors (positions, masks, pools) are replicated
    implicitly, the embedding lookup reads its table whole (``embed_table``,
    its gradient going back to the table's shards), and ``rules`` apply, on
    top of those of an enclosing :func:`activation_rules` (the dry-run's
    sequence-sharded residuals). Without a mesh, nothing."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import P

    with implicit_replication(), activation_rules({"embed_table": P(None, None),
                                                   **(current_rules() or {}),
                                                   **(rules or {})}):
        yield


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
