"""Loading the JAX package's weights into the port, for the parity tests.

``params_from_jax`` takes the reference's param pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``; this module
never imports jax). The reference stacks layer params on a leading axis
(``stack_init`` vmaps the layer init); the port keeps a list of per-layer
dicts, so ``"layers"`` is unstacked here. Dense weights keep their (in, out)
layout: the port applies them as ``x @ w`` too.
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
    stacked = params["layers"]
    n_layers = len(next(iter(_leaves(stacked))))
    out["layers"] = [_convert(_index(stacked, i), device) for i in range(n_layers)]
    return out


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
