"""Optimizers on dicts of tensors: AdamW and memory-factored AdamW.

A port of ``repro.train.optimizer``. ``adamw_factored`` keeps the first
moment in bf16 and replaces the second moment of rank >= 2 leaves with
Adafactor-style row and column statistics; it is what lets full-width
deepseek-7b train on one 80 GB card (13.8 GB of bf16 params and as much of
grads, 13.8 GB of bf16 first moment, a few MB of statistics).

Two differences from the reference, neither visible in the results:

* The update runs in place: params and moments are overwritten leaf by leaf
  instead of returned as new trees, so a step holds one copy of them (the
  functional form would need 27.6 GB more at full width) and float32
  temporaries of one leaf at a time.
* The params keep their layers as a list of per-layer dicts (the hybrid's
  Mamba layers as a list of groups, each a list of layers), but the
  moments keep them stacked on leading axes, as the reference's scanned
  params do: (L, ...) for a stack of layers, (groups, layers a group, ...)
  for the hybrid's. That keeps the reference's checkpoint layout and its
  factoring: a stacked rank-1 leaf (a norm scale, (L, d)) is factored there,
  with a column statistic shared by the layers of its innermost stack, and
  so it is here. Each layer updates through views of the stacked moments.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig

__all__ = ["OptState", "make_optimizer", "cosine_schedule", "global_norm", "named_leaves",
           "stack_members"]


class OptState(NamedTuple):
    step: int
    m: dict
    v: dict


def cosine_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup to ``cfg.lr``, then cosine decay to a tenth of it."""

    def lr(step: int) -> float:
        warm = min(step / max(cfg.warmup_steps, 1), 1.0)
        prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        prog = min(max(prog, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * prog))
        return cfg.lr * warm * (0.1 + 0.9 * cos)

    return lr


def named_leaves(tree, prefix: tuple = ()):
    """(key path, tensor) of every leaf of a nested dict of tensors; list
    entries (the per-layer dicts) are keyed by their index."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, prefix + (k,))


def stack_members(stack: list) -> tuple[tuple, list]:
    """(lead shape, member dicts in row-major order) of a stack of layers:
    a list of per-layer dicts, or a list of such lists (the hybrid's groups
    of Mamba layers), which the reference stacks on leading axes."""
    if not isinstance(stack[0], list):
        return (len(stack),), list(stack)
    inner = [stack_members(s) for s in stack]
    return (len(stack),) + inner[0][0], [m for _, ms in inner for m in ms]


def _stacks_and_leaves(tree, prefix: tuple = ()):
    """Walk a params tree: ``("stack", path, lead, members)`` for every
    non-empty stack of layers (see :func:`stack_members`), ``("leaf",
    path, tensor)`` for every leaf outside one."""
    if isinstance(tree, list):
        if tree:
            yield ("stack", prefix, *stack_members(tree))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _stacks_and_leaves(v, prefix + (k,))
    else:
        yield "leaf", prefix, tree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = [leaf.float().square().sum() for _, leaf in named_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


_NO_DECAY = {"b", "bias", "scale", "a_log", "dt_bias", "d_skip", "conv_b"}


def _decay_mask(name: str) -> bool:
    """Weight decay only on weight matrices (skip norms, biases, scalars)."""
    return name not in _NO_DECAY


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_optimizer(cfg: TrainConfig):
    """Returns (init, update). ``init(params) -> OptState``;
    ``update(grads, state, params) -> (params, state, stats)`` with params
    and moments updated in place and ``stats`` {"lr", "grad_norm",
    "clip"}."""
    if cfg.optimizer not in ("adamw", "adamw_factored"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; valid: adamw, adamw_factored")
    factored = cfg.optimizer == "adamw_factored"
    lr_fn = cosine_schedule(cfg)
    b1, b2, eps = cfg.b1, cfg.b2, 1e-8

    def moments(shape, device) -> tuple:
        m = torch.zeros(shape, dtype=torch.bfloat16 if factored else torch.float32,
                        device=device)
        if factored and len(shape) >= 2:
            v = {"row": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                 "col": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                    device=device)}
        else:
            v = torch.zeros(shape, dtype=torch.float32, device=device)
        return m, v

    def init(params: dict) -> OptState:
        m, v = {}, {}
        for kind, prefix, *rest in _stacks_and_leaves(params):
            if kind == "leaf":
                leaves, lead = [(prefix, rest[0])], ()
            else:
                lead, members = rest
                leaves = [(prefix + path, p) for path, p in named_leaves(members[0])]
            for path, p in leaves:
                mm, vv = moments(lead + tuple(p.shape), p.device)
                _put(m, path, mm)
                _put(v, path, vv)
        return OptState(step=0, m=m, v=v)

    def leaf_update(name, p, g, m, v, *, lr, clip, bc1, bc2) -> None:
        """The reference's per-leaf update on one (possibly stacked) leaf,
        written into ``p``, ``m`` and ``v`` in place."""
        g = g.float() * clip
        m_new = m.float().mul_(b1).add_(g, alpha=1 - b1)
        if isinstance(v, dict):  # factored second moment
            g2 = g * g + 1e-30
            v["row"].mul_(b2).add_(g2.mean(-1), alpha=1 - b2)
            v["col"].mul_(b2).add_(g2.mean(-2), alpha=1 - b2)
            del g2
            # rank-1 reconstruction: v_ij ~ row_i * col_j / mean(row)
            denom = torch.clamp(v["row"].mean(-1, keepdim=True), min=1e-30)
            nu = (v["row"][..., :, None] * v["col"][..., None, :]) / denom[..., None]
        else:
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            nu = v.clone()
        del g
        delta = m_new.div(bc1).div_(nu.div_(bc2).sqrt_().add_(eps))
        del nu
        m.copy_(m_new)
        del m_new
        if _decay_mask(name):
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(delta, alpha=lr))

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict):
        step = state.step + 1
        lr = lr_fn(step)
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        kw = dict(lr=lr, clip=clip, bc1=1.0 - b1 ** step, bc2=1.0 - b2 ** step)
        for kind, prefix, *rest in _stacks_and_leaves(params):
            if kind == "leaf":
                leaf_update(prefix[-1], rest[0], _get(grads, prefix), _get(state.m, prefix),
                            _get(state.v, prefix), **kw)
                continue
            lead, layers = rest
            _, glayers = stack_members(_get(grads, prefix))
            # A stacked moment seen one layer at a time: (layers, *leaf shape).
            flat = lambda t: t.reshape((-1,) + tuple(t.shape[len(lead):]))  # noqa: E731
            for path, p0 in named_leaves(layers[0]):
                m = _get(state.m, prefix + path)
                v = _get(state.v, prefix + path)
                ps = [_get(lp, path) for lp in layers]
                gs = [_get(gp, path) for gp in glayers]
                if isinstance(v, dict) and p0.dim() == 1:
                    # Stacked (*lead, d): the column statistic spans the
                    # layers of the innermost stack.
                    stacked = torch.stack(ps).reshape(lead + tuple(p0.shape))
                    leaf_update(path[-1], stacked, torch.stack(gs).reshape(stacked.shape),
                                m, v, **kw)
                    for p, row in zip(ps, stacked.reshape(len(ps), -1)):
                        p.copy_(row)
                    continue
                # One layer at a time, through views of the stacked moments.
                mf = flat(m)
                vf = {k: flat(t) for k, t in v.items()} if isinstance(v, dict) else flat(v)
                for i, (p, g) in enumerate(zip(ps, gs)):
                    vi = {k: t[i] for k, t in vf.items()} if isinstance(vf, dict) else vf[i]
                    leaf_update(path[-1], p, g, mf[i], vi, **kw)
        stats = {"lr": torch.tensor(lr, dtype=torch.float32), "grad_norm": gnorm, "clip": clip}
        return params, OptState(step=step, m=state.m, v=state.v), stats

    return init, update
