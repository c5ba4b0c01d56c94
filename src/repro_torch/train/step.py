"""The train state and the train step: loss, gradients, optimizer update.

A port of ``repro.train.step`` for one card. ``make_train_step`` returns
``step(state, batch) -> (state, metrics)``, the unit ``run_training``
repeats: the loss of ``LM.loss`` and its gradients by autograd (the
attention backward is the fused flash backward of ``ops.attention``), then
the optimizer's in-place update.

Gradient accumulation: the global batch is split into
``pcfg.microbatches`` equal parts along its first axis; their gradients are
summed in float32 and averaged, as are their losses and metrics. There is
no mesh and no sharding (ROADMAP A14): ``make_train_step`` refuses a
``ParallelConfig`` whose sharding fields differ from their defaults, and
the reference's ``shard_state`` and compiled-step plumbing have nothing to
do here.

The reference's state is functional, so a failed step leaves step i-1's
state intact. Here the optimizer writes the params and moments in place,
leaf after leaf; a ``RuntimeError`` raised once that pass has begun (an
out-of-memory on its float32 temporaries, say) is re-raised as
``PartialUpdate``, and ``run_training`` then writes no checkpoint of that
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.train.optimizer import make_optimizer, named_leaves

__all__ = ["TrainState", "PartialUpdate", "make_train_state", "make_train_step",
           "check_device"]


TrainState = dict  # {"params": nested dict of tensors, "opt": OptState}


class PartialUpdate(RuntimeError):
    """The optimizer failed during its in-place update: the state holds
    neither the step before nor the step after."""


def check_device(lm: LM, device) -> torch.device:
    """The resolved ``device`` (raises without a GPU unless it names the
    CPU), which must be the one ``lm`` was built for."""
    dev = resolve_device(device)
    if dev.type != lm.device.type:
        raise ValueError(f"the model was built for {lm.device}, training asked for {dev}")
    return dev


def make_train_state(lm: LM, tcfg: TrainConfig, seed=0, *, device="cuda") -> TrainState:
    """Random params from ``seed`` and a fresh optimizer state."""
    check_device(lm, device)
    params = lm.init(seed)
    opt_init, _ = make_optimizer(tcfg)
    return {"params": params, "opt": opt_init(params)}


def _split(batch: dict, n: int) -> list[dict]:
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} of {k!r} does not split into {n} microbatches")
        for i, part in enumerate(np.split(x, n) if isinstance(x, np.ndarray) else x.chunk(n)):
            out[i][k] = part
    return out


def make_train_step(lm: LM, tcfg: TrainConfig, pcfg: ParallelConfig = ParallelConfig()):
    """Returns ``step(state, batch) -> (state, metrics)``: the state's
    params and moments are updated in place; metrics are 0-d tensors (the
    loss metrics of ``LM.loss``, the optimizer's ``lr``, ``grad_norm`` and
    ``clip``, and ``loss_mean``)."""
    default = ParallelConfig()
    sharded = [f.name for f in dataclasses.fields(pcfg)
               if f.name != "microbatches" and getattr(pcfg, f.name) != getattr(default, f.name)]
    if sharded:
        raise NotImplementedError(
            f"ParallelConfig fields {sharded} shard or compress across a mesh; the port trains "
            "on one card without one (ROADMAP A14)")
    _, opt_update = make_optimizer(tcfg)
    n_micro = max(1, pcfg.microbatches)

    def grads_of(params, leaves, batch):
        loss, metrics = lm.loss(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step(state: TrainState, batch: dict):
        params = state["params"]
        leaves = list(named_leaves(params))
        for _, p in leaves:
            p.requires_grad_(True)
        if n_micro == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for _, p in leaves]
            loss = 0.0
            parts = []
            for mb in _split(batch, n_micro):
                l, m, g = grads_of(params, leaves, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                loss = loss + l
                parts.append(m)
            grads = [a.div_(n_micro) for a in acc]
            loss = loss / n_micro
            metrics = {k: torch.stack([m[k] for m in parts]).mean(0) for k in parts[0]}
        gtree = _unflatten(params, leaves, grads)
        del grads
        try:
            params, opt, stats = opt_update(gtree, state["opt"], params)
        except RuntimeError as e:
            raise PartialUpdate(
                f"the optimizer failed part way through its in-place update: {e}") from e
        metrics = dict(metrics, **stats, loss_mean=loss)
        return {"params": params, "opt": opt}, metrics

    return step


def _unflatten(like, leaves, values):
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order."""
    by_path = {path: v for (path, _), v in zip(leaves, values)}

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(tree)]
        return by_path[prefix]

    return build(like, ())
