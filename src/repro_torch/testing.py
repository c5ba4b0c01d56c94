"""Loading the JAX package's weights into the port, for the parity tests,
and the tie rule that holds two bf16 runs whose sums ran in another order.

``params_from_jax`` takes the reference's param pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``; this module
never imports jax). The reference stacks layer params on leading axes (its
inits vmap the layer init); the port keeps lists of per-layer dicts, so the
layer stacks are unstacked here: ``"layers"`` (every family but enc-dec)
in one of two layouts, and enc-dec's ``"encoder"`` and ``"decoder"`` as
the first:

  * stacked (dense, MoE, SSM, VLM; the enc-dec stacks): every leaf
    (n_layers, ...) -> a list of n_layers dicts (an MoE layer's router a
    float32 ``dense`` dict, its expert weights (E, d, ff) and (E, ff, d));
  * hybrid, ``{"mamba": leaves (groups, every, ...), "shared": {...}}`` ->
    ``{"mamba": groups lists of every dicts, "shared": as it is}``.

Everything else (the embeddings, heads, norms, the VLM's ``vision_proj``)
is converted as it is. Any other layout raises: params with no layer stack,
or a stack whose leaves do not share their leading axes. Dense weights keep
their (in, out) layout: the port applies them as ``x @ w`` too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["params_from_jax", "to_torch", "bf16_ulp", "top2_margin", "within_tie_rule"]


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor on ``device``; bfloat16 arrays (ml_dtypes) are
    reinterpreted bit for bit."""
    a = np.array(a)  # a writable contiguous copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def params_from_jax(params: dict, *, device="cpu") -> dict:
    """The port's params (nested dicts of tensors on ``device``, layer
    stacks as lists) from the reference's numpy param pytree."""
    stacks = [k for k in _STACKS if k in params]
    if stacks not in (["layers"], ["encoder", "decoder"]):
        raise ValueError(
            f"params_from_jax: expected a 'layers' stack or the enc-dec 'encoder' and "
            f"'decoder' stacks, found top-level keys {sorted(params)}")
    out = {k: _convert(v, device) for k, v in params.items() if k not in _STACKS}
    for name in stacks:
        layers = params[name]
        if name == "layers" and isinstance(layers, dict) and set(layers) == {"mamba", "shared"}:
            g, e = _lead(layers["mamba"], 2)
            out[name] = {
                "mamba": [[_convert(_index(layers["mamba"], (i, j)), device) for j in range(e)]
                          for i in range(g)],
                "shared": _convert(layers["shared"], device),
            }
        else:
            (n_layers,) = _lead(layers, 1)
            out[name] = [_convert(_index(layers, i), device) for i in range(n_layers)]
    return out


_STACKS = ("layers", "encoder", "decoder")


def _lead(tree, k: int) -> tuple:
    """The leading ``k`` axes that every leaf of ``tree`` shares; raises if
    they differ (a leaf that is not stacked like the others)."""
    shapes = {tuple(np.shape(leaf)[:k]) if np.ndim(leaf) >= k else None for leaf in _leaves(tree)}
    if len(shapes) != 1 or None in shapes:
        raise ValueError(
            f"params_from_jax: the layer leaves do not share {k} stacked leading axes "
            f"(found {sorted(map(str, shapes))}); expected the dense/SSM stack or the hybrid "
            "{'mamba', 'shared'} layout"
        )
    return shapes.pop()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def bf16_ulp(x: float) -> float:
    """One unit in the last place of bfloat16 (8 significant bits) at
    magnitude ``|x|``: ``2**(floor(log2|x|) - 7)``; 0 at 0."""
    x = abs(float(x))
    return 0.0 if x == 0.0 else 2.0 ** (math.floor(math.log2(x)) - 7)


def top2_margin(logits: torch.Tensor) -> tuple[float, float]:
    """(top logit, top minus second) of one row of logits, in the logits'
    own values (bf16 stays bf16, read as float)."""
    top2 = torch.topk(logits.float(), 2).values
    return float(top2[0]), float(top2[0] - top2[1])


def within_tie_rule(margins, top: float, steps: int = 1) -> bool:
    """Whether two greedy runs that differ at a token were tied there, to
    bf16's resolution. ``margins`` are the two runs' top-2 logit margins at
    the first differing token, ``top`` the top logit there. Two runs of one
    model whose attention adds the same float32 terms in another order
    (another KV visit order) can round a logit one bf16 step apart, so a
    flip is allowed where the smaller margin is at most one ulp of ``top``
    (:func:`bf16_ulp`) and the larger is below two: one step of rounding
    in each run, and no more. ``steps`` rounding steps a run (int8 caches
    add one, a K/V value's int8 code) allow ``steps`` and ``steps + 1``."""
    u = bf16_ulp(top)
    lo, hi = sorted(float(m) for m in margins)
    return lo <= steps * u and hi < (steps + 1) * u
