"""Random weights for a configuration, made on the device from the seed in a
few large calls, in the nested-dict layout the port's ``LM`` takes and the
plain reference reads (a dense weight ``w`` is (in, out); expert weights
(E, in, out); the router float32).

Every matrix of one kind, over all layers, is one segment of one flat
buffer, filled by ``normal_`` from one ``torch.Generator`` on the device
and scaled once: 1/sqrt(fan-in) for projections, 0.02 for the embedding,
as the port's own initializers scale them. Norm scales are ones.
"""

from __future__ import annotations

import math

import torch

from bench.counts import Shapes

__all__ = ["Weights"]

_CHUNK = 1 << 30   # elements a fill call takes at most


class Weights:
    """The flat buffers and the params dict of views into them. ``fill(seed)``
    draws every weight anew in place, so a step graph that baked their
    pointers sees the new values. The configuration file ``config`` adds
    nothing to this layout: the shapes give all of it."""

    def __init__(self, s: Shapes, config: dict, *, device, dtype=torch.bfloat16):
        self.shapes = s
        L, d, hd = s.layers, s.d, s.head_dim
        qd, kvd = s.heads * hd, s.kv_heads * hd
        segs = [("embed", (s.vocab, d), 0.02), ("lm_head", (d, s.vocab), d ** -0.5),
                ("wq", (L, d, qd), d ** -0.5), ("wk", (L, d, kvd), d ** -0.5),
                ("wv", (L, d, kvd), d ** -0.5), ("wo", (L, qd, d), qd ** -0.5)]
        if s.experts:
            e, ff = s.experts, s.d_ff_expert
            segs += [("w_gate", (L, e, d, ff), d ** -0.5), ("w_up", (L, e, d, ff), d ** -0.5),
                     ("w_down", (L, e, ff, d), ff ** -0.5)]
        else:
            ff = s.d_ff
            segs += [("w_gate", (L, d, ff), d ** -0.5), ("w_up", (L, d, ff), d ** -0.5),
                     ("w_down", (L, ff, d), ff ** -0.5)]
        total = sum(math.prod(shape) for _, shape, _ in segs)
        self.flat = torch.empty(total, dtype=dtype, device=device)
        self.device = self.flat.device
        self.segments: dict[str, tuple[torch.Tensor, float]] = {}
        at = 0
        for name, shape, scale in segs:
            n = math.prod(shape)
            self.segments[name] = (self.flat[at:at + n].view(shape), scale)
            at += n
        self.norms = torch.ones((2 * L + 1, d), dtype=dtype, device=device)
        self.router = (torch.empty((L, d, s.experts), dtype=torch.float32, device=device)
                       if s.experts else None)
        self.params = self._tree()

    def fill(self, seed: int) -> "Weights":
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) & ((1 << 63) - 1))
        for buf in [self.flat] + ([self.router] if self.router is not None else []):
            flat = buf.view(-1)
            for a in range(0, flat.numel(), _CHUNK):
                flat[a:a + _CHUNK].normal_(generator=gen)
        for seg, scale in self.segments.values():
            seg.mul_(scale)
        if self.router is not None:
            self.router.mul_(self.shapes.d ** -0.5)
        return self

    def _tree(self) -> dict:
        s = self.shapes
        seg = {name: t for name, (t, _) in self.segments.items()}
        layers = []
        for i in range(s.layers):
            if s.experts:
                ffn = {"router": {"w": self.router[i]}, "w_gate": seg["w_gate"][i],
                       "w_up": seg["w_up"][i], "w_down": seg["w_down"][i]}
            else:
                ffn = {k: {"w": seg[k][i]} for k in ("w_gate", "w_up", "w_down")}
            layers.append({
                "ln_attn": {"scale": self.norms[2 * i]},
                "attn": {k: {"w": seg[k][i]} for k in ("wq", "wk", "wv", "wo")},
                "ln_ffn": {"scale": self.norms[2 * i + 1]},
                "ffn": ffn,
            })
        return {"embed": {"table": seg["embed"]}, "lm_head": {"w": seg["lm_head"]},
                "layers": layers, "ln_f": {"scale": self.norms[2 * s.layers]}}
