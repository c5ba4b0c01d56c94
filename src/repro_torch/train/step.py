"""Train/serve step factories: the loss, gradients and optimizer update,
sharded over a mesh or on one device, with gradient accumulation.

A port of ``repro.train.step``. ``make_train_step`` returns ``step(state,
batch) -> (state, metrics)``, the unit ``run_training`` repeats: the loss
of ``LM.loss`` and its gradients by autograd (the attention backward is the
fused flash backward of ``ops.attention``), then the optimizer's in-place
update.

Gradient accumulation: the global batch is split into
``pcfg.microbatches`` equal parts along its first axis; their gradients are
summed in float32 and averaged, as are their losses and metrics.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with named dims)
the step is the reference's GSPMD step on DTensors: the state is placed by
:func:`shard_state` (params on ``dist.sharding.param_specs``, the moments
mirroring them, ZeRO-style), each microbatch is placed on
``batch_shardings`` (its batch dim on the data axes), and the model runs on
DTensors, which insert the collectives; plain tensors the model makes
(positions, masks) are replicated implicitly. The kernels run on each
rank's local block (``kernels.ops``). The step adds the activation rule
``{"logits": batch on the data axes}`` to ``dist.context.on_mesh``'s. A
batch that the data axes do not divide stays replicated on them (its spec
tightened, as in the reference), and every rank of those axes runs it
whole: the step reads its params gathered there
(``dist.context.gathered_on``; the gradients go back to the shards), so no
activation takes a shard of the sequence in the batch's place.
``pcfg.grad_compression`` and ``zero_grads`` are accepted and, as in the
reference's step, read by nothing.

The reference's state is functional, so a failed step leaves step i-1's
state intact. Here the optimizer writes the params and moments in place,
leaf after leaf; a ``RuntimeError`` raised once that pass has begun (an
out-of-memory on its float32 temporaries, say) is re-raised as
``PartialUpdate``, and ``run_training`` then writes no checkpoint of that
state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.context import gathered_on, on_mesh, whole
from repro_torch.models.model import LM
from repro_torch.train.optimizer import OptState, make_optimizer, named_leaves

__all__ = ["TrainState", "PartialUpdate", "make_train_state", "make_train_step",
           "make_serve_steps", "state_shardings", "shard_state", "place_batch", "check_device"]


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


def state_shardings(state, pcfg: ParallelConfig, mesh):
    """Specs of every leaf of ``state`` (``dist.sharding.P``): params on
    their rules, each moment leaf like its param (tightened for the
    factored statistics), the step count replicated. Works on a
    ``DeviceMesh`` and a device-free ``MeshShape``."""
    def mirror(tree, prefix):
        return shd.tree_map_with_path(
            lambda path, x: shd.spec_for(shd.path_str(path), tuple(x.shape), pcfg, mesh), tree,
            prefix)

    opt = state["opt"]
    return {
        "params": shd.param_specs(state["params"], pcfg, mesh),
        "opt": OptState(step=shd.P(), m=mirror(opt.m, ()), v=mirror(opt.v, ())),
    }


def shard_state(state: TrainState, pcfg: ParallelConfig, mesh) -> TrainState:
    """Place a (whole, the same on every rank) state onto its target
    shardings on ``mesh``: every tensor becomes a DTensor holding this
    rank's shard. Call it once after init or restore."""
    specs = state_shardings(state, pcfg, mesh)
    opt = state["opt"]
    return {
        "params": shd.distribute(state["params"], specs["params"], mesh),
        "opt": OptState(step=opt.step, m=shd.distribute(opt.m, specs["opt"].m, mesh),
                        v=shd.distribute(opt.v, specs["opt"].v, mesh)),
    }


def place_batch(batch: dict, pcfg: ParallelConfig, mesh, device) -> dict:
    """Every leaf of ``batch`` (tensors or numpy arrays, the whole batch on
    every rank) as a DTensor on ``mesh``, its batch dim on the data axes."""
    from torch.distributed.tensor import distribute_tensor

    placements = shd.batch_shardings(batch, pcfg, mesh)
    return {k: distribute_tensor(torch.as_tensor(x, device=device), mesh, placements[k],
                                 src_data_rank=None)
            for k, x in batch.items()}


def _loss_rules(pcfg: ParallelConfig, mesh) -> dict:
    data = tuple(a for a in pcfg.data_axes if a in mesh.mesh_dim_names)
    return {"logits": shd.P(data or None)}


def _split(batch: dict, n: int) -> list[dict]:
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} of {k!r} does not split into {n} microbatches")
        for i, part in enumerate(np.split(x, n) if isinstance(x, np.ndarray) else x.chunk(n)):
            out[i][k] = part
    return out


def make_train_step(lm: LM, tcfg: TrainConfig, pcfg: ParallelConfig = ParallelConfig(),
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: the state's
    params and moments are updated in place; metrics are 0-d tensors (the
    loss metrics of ``LM.loss``, the optimizer's ``lr``, ``grad_norm`` and
    ``clip``, and ``loss_mean``), plain tensors also under a mesh. With
    ``mesh`` the state must come from :func:`shard_state` and ``batch`` is
    the whole global batch on every rank."""
    _, opt_update = make_optimizer(tcfg)
    n_micro = max(1, pcfg.microbatches)
    rules = None if mesh is None else _loss_rules(pcfg, mesh)

    def grads_of(params, leaves, batch):
        loss, metrics = lm.loss(_on_batch(params, batch, pcfg, mesh), batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def place(mb):
        return mb if mesh is None else place_batch(mb, pcfg, mesh, lm.device)

    def step(state: TrainState, batch: dict):
        params = state["params"]
        leaves = list(named_leaves(params))
        for _, p in leaves:
            p.requires_grad_(True)
        with on_mesh(mesh, rules):
            if n_micro == 1:
                loss, metrics, grads = grads_of(params, leaves, place(batch))
            else:
                acc = [torch.zeros_like(p, dtype=torch.float32) for _, p in leaves]
                loss = 0.0
                parts = []
                for mb in _split(batch, n_micro):
                    l, m, g = grads_of(params, leaves, place(mb))
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
        if mesh is not None:
            metrics = {k: whole(v) for k, v in metrics.items()}
        return {"params": params, "opt": opt}, metrics

    return step


def _on_batch(params, batch: dict, pcfg: ParallelConfig, mesh):
    """``params`` as a step over ``batch`` reads them on ``mesh``: gathered
    on the data axes the batch's size does not divide (none: the params
    themselves)."""
    if mesh is None:
        return params
    b = next(iter(batch.values())).shape[0]
    return gathered_on(params, shd.batch_replica_axes(b, pcfg, mesh))


def make_serve_steps(lm: LM, pcfg: ParallelConfig, mesh, *, max_len: int):
    """``prefill(params, batch) -> (logits, caches)`` and ``decode(params,
    tokens, caches) -> (logits, caches)`` on ``mesh`` (None: one device):
    params from ``shard_state``'s placement (``dist.sharding.distribute``
    with ``param_specs``), the batch placed on its data axes. Under a mesh
    the prefill's caches are placed by ``dist.sharding.cache_shardings``
    (``distribute_caches``: each rank holds its shard), and the decode step
    writes into them in place. Logits come back whole."""
    def prefill(params, batch):
        if mesh is not None:
            batch = place_batch(batch, pcfg, mesh, lm.device)
        with on_mesh(mesh, pcfg=pcfg):
            logits, caches = lm.prefill(_on_batch(params, batch, pcfg, mesh), batch, max_len)
            return whole(logits), caches

    def decode(params, tokens, caches):
        with on_mesh(mesh, pcfg=pcfg):
            logits, caches = lm.decode_step(_on_batch(params, {"tokens": tokens}, pcfg, mesh),
                                            tokens, caches)
            return whole(logits), caches

    return prefill, decode


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
