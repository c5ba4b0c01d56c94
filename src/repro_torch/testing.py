"""Loading the JAX package's weights into the port, for the parity tests.

``params_from_jax`` takes the reference's param pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``; this module
never imports jax). The reference stacks layer params on leading axes (its
inits vmap the layer init); the port keeps lists of per-layer dicts, so
``"layers"`` is unstacked here, in one of two layouts:

  * stacked (dense, SSM): every leaf (n_layers, ...) -> a list of n_layers
    dicts;
  * hybrid, ``{"mamba": leaves (groups, every, ...), "shared": {...}}`` ->
    ``{"mamba": groups lists of every dicts, "shared": as it is}``.

Any other layout (leaves that do not share their leading axes) raises.
Dense weights keep their (in, out) layout: the port applies them as ``x @ w``
too.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "to_torch"]


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
    """The port's params (nested dicts of tensors on ``device``, layers as a
    list) from the reference's numpy param pytree."""
    out = {k: _convert(v, device) for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    if isinstance(layers, dict) and set(layers) == {"mamba", "shared"}:
        g, e = _lead(layers["mamba"], 2)
        out["layers"] = {
            "mamba": [[_convert(_index(layers["mamba"], (i, j)), device) for j in range(e)]
                      for i in range(g)],
            "shared": _convert(layers["shared"], device),
        }
    else:
        (n_layers,) = _lead(layers, 1)
        out["layers"] = [_convert(_index(layers, i), device) for i in range(n_layers)]
    return out


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
