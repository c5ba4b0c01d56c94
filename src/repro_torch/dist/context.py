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
entry a tensor dim, resolved on the DTensor's own mesh) or a tuple of
placements, one a mesh dim. Plain tensors and unknown roles pass through:
a rules dict only names the activations it cares about.

``logits`` and ``embed_table`` are the port's own roles: DTensor cannot
reduce the gather of a label's logit from a vocab-sharded dim, nor (on
some torch versions) differentiate a lookup into a vocab-sharded table, so
the sharded train step replicates the vocab dim of both.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Mapping, Optional

import torch

__all__ = ["activation_rules", "constrain", "current_rules", "on_mesh", "whole"]

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
    from repro_torch.dist.sharding import P, placements

    if isinstance(rule, P):
        spec = tuple(rule) + (None,) * (x.ndim - len(rule))
        rule = placements(spec[: x.ndim], x.device_mesh)
    if tuple(x.placements) == tuple(rule):
        return x
    return x.redistribute(x.device_mesh, rule)


@contextlib.contextmanager
def on_mesh(mesh, rules: Optional[Mapping[str, object]] = None):
    """The context a step runs in on ``mesh`` (a ``DeviceMesh``): plain
    tensors meeting DTensors (positions, masks, pools) are replicated
    implicitly, the embedding lookup reads its table whole (``embed_table``,
    its gradient going back to the table's shards), and ``rules`` apply.
    Without a mesh, nothing."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import P

    with implicit_replication(), activation_rules({"embed_table": P(None, None),
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
