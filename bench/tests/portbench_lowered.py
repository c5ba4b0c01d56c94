"""A configuration module for the CPU tests (``test_portbench_module.py``):
the default port config and weights, each under a name of its own, and a
plain reference that puts the logit of each row's next token 1 below the
best of the others. A served stream the default reference ranks first
then reads a gap of at least 1 wherever a row's next token is known (every
served token but the last)."""

import torch

from bench import weights
from bench.reference import model


def port_config(c: dict):
    from bench.harness import port_config as default

    return default(c)


class Weights(weights.Weights):
    """The default layout, as a class of this module."""


def logits_at(params: dict, config: dict, seqs, *, fp8: bool = False) -> list[torch.Tensor]:
    out = model.logits_at(params, config, seqs, fp8=fp8)
    for (tokens, start), rows in zip(seqs, out):
        nxt = tokens[start + 1:].to(rows.device)
        at = torch.arange(len(nxt), device=rows.device)
        others = rows[at].clone()
        others[at, nxt] = float("-inf")
        rows[at, nxt] = others.max(dim=-1).values - 1
    return out
