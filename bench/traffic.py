"""The one traffic generator: it reads a mix file of ``bench/mixes`` and
makes waves of requests from ``--seed``.

A mix gives the distributions of prompt and output lengths
(``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or ``{"dist":
"uniform", "min", "max"}``) and a ``pairing_seed``. A wave of n requests
takes its lengths at the n evenly spaced quantiles ``(i + 0.5) / n`` of
each distribution, prompts and outputs paired by a permutation drawn from
``pairing_seed``. Wave w takes them in an order drawn from ``pairing_seed``
and w: which requests share the slots decides the engine's steps, so every
run serves the same sizes in the same orders, and the seed draws only the
token ids (and the weights), not the work. Outputs are cut so that prompt
+ output fits ``max_len``.

Optional keys: ``"prefixes": {"count", "length", "share"}`` puts one of
``count`` shared prefixes of ``length`` tokens (drawn once a run from the
seed) before the prompts of ``share`` of the requests, the same requests
of the size set in every wave (spread evenly over the sizes), the
prefixes dealt round-robin;
``"motif": {"length"}`` makes each prompt one random motif of that many
tokens repeated (text an n-gram drafter can copy).
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

__all__ = ["WaveRequest", "Size", "request_sizes", "make_wave", "rng_for"]

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class WaveRequest:
    tokens: np.ndarray     # prompt, int32
    max_new: int           # output length the request runs to


@dataclasses.dataclass(frozen=True)
class Size:
    prompt: int            # prompt length, a shared prefix included
    output: int
    prefix: int = -1       # the shared prefix it starts with, or -1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([int(seed) & _MASK64, *stream])


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        v = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    elif kind == "uniform":
        v = float(dist["min"]) + u * (float(dist["max"]) - float(dist["min"]))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)


def request_sizes(mix: dict, n: int, max_len: int) -> list[Size]:
    """The sizes of a wave of ``n`` requests."""
    pre = mix.get("prefixes")
    plen = int(pre["length"]) if pre else 0
    shared = round(float(pre["share"]) * n) if pre else 0
    prompts = _quantiles(mix["prompt"], n)
    outputs = _quantiles(mix["output"], n)
    perm = np.random.default_rng(int(mix["pairing_seed"])).permutation(n)
    sizes = []
    dealt = 0
    for i in range(n):
        # shared requests spread evenly over the sizes, prefixes round-robin
        take = pre is not None and (i + 1) * shared // n > i * shared // n
        prefix = dealt % int(pre["count"]) if take else -1
        dealt += take
        p = min(int(prompts[i]) + (plen if prefix >= 0 else 0), max_len - 1)
        sizes.append(Size(p, int(min(outputs[perm[i]], max_len - p)), prefix))
    return sizes


def make_wave(mix: dict, sizes: list[Size], seed: int, index: int,
              vocab: int) -> list[WaveRequest]:
    """Wave ``index`` of a run with ``seed``: the sizes in the wave's order,
    each prompt's own tokens drawn from the seed, uniform over the
    vocabulary (or a repeated motif), after its shared prefix if it has
    one."""
    order = np.random.default_rng([int(mix["pairing_seed"]), 1, index]).permutation(len(sizes))
    rng = rng_for(seed, 1, index)
    pre = mix.get("prefixes")
    prefixes = (rng_for(seed, 3).integers(0, vocab, size=(int(pre["count"]), int(pre["length"])),
                                          dtype=np.int32) if pre else None)
    motif = int(mix["motif"]["length"]) if mix.get("motif") else 0
    wave = []
    for i in order:
        s = sizes[i]
        head = prefixes[s.prefix] if s.prefix >= 0 else np.zeros(0, np.int32)
        own = s.prompt - len(head)
        if motif:
            tokens = np.resize(rng.integers(0, vocab, size=motif, dtype=np.int32), own)
        else:
            tokens = rng.integers(0, vocab, size=own, dtype=np.int32)
        wave.append(WaveRequest(np.concatenate([head, tokens]), s.output))
    return wave
