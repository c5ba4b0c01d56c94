"""OLMoE-1B-7B as published (allenai/OLMoE-1B-7B-0924): what its
configuration file runs and is judged by, where it departs from the
benchmark's defaults.

* ``port_config``: the port's ``olmoe-1b-7b-0924`` (``port_arch``) at the
  file's sizes, with the published routing (``norm_topk_prob`` false) and
  q/k norm on, and the file's ``eos_token_id``.
* ``Weights``: the default layout (``bench.weights``) plus each layer's
  ``attn/q_norm`` (heads x head dim) and ``attn/k_norm`` (KV heads x head
  dim) scales, drawn around one (1 + 0.1 N(0, 1)) so that a program that
  drops a scale, or applies it per head, reads wrong.
* ``logits_at``: the plain float32 forward (TF32 off) of the published
  layer: pre-norm; q and k projected, each RMS-normed over the whole
  projection by its own scale, then split into heads and roped (half-split,
  positions 0..S-1); causal softmax attention; a float32 router whose
  softmax over all E logits gives each token's top-k experts their
  weights, not renormalized; each chosen expert a SwiGLU; final RMSNorm and
  the LM head. ``fp8=True`` is the e4m3 control of ``reference/model.py``.

It imports nothing of the port when it is imported (``port_config``
imports the port's registry inside the function): ``logits_at`` is a
reference independent of the program it judges.
"""

from __future__ import annotations

import dataclasses

import torch

from bench.counts import Shapes
from bench.reference.model import RefConfig, _attention, _mlp, _mm, _rmsnorm, _rope, no_tf32
from bench.weights import Weights as _DefaultWeights

__all__ = ["port_config", "Weights", "logits_at", "QK_SCALE_SPREAD"]

QK_SCALE_SPREAD = 0.1   # the q/k norm scales' standard deviation about one


def port_config(c: dict):
    """The port's config for the file: the harness's mapping of its sizes
    onto ``port_arch``, the routing of ``norm_topk_prob``, q/k norm on, and
    its eos."""
    from bench.harness import port_config as sized

    cfg = sized(c)
    return cfg.with_(qk_norm=True, eos_id=int(c["eos_token_id"]),
                     moe=dataclasses.replace(cfg.moe, norm_topk_prob=bool(c["norm_topk_prob"])))


class Weights(_DefaultWeights):
    """The default weights plus the q/k norm scales, one (L, (H + Hkv) x
    hd) buffer whose rows' two parts are each layer's ``q_norm`` and
    ``k_norm``; ``fill(seed)`` draws them too, in place."""

    def __init__(self, s: Shapes, config: dict, *, device, dtype=torch.bfloat16):
        self.qk = torch.empty((s.layers, (s.heads + s.kv_heads) * s.head_dim), dtype=dtype,
                              device=device)
        super().__init__(s, config, device=device, dtype=dtype)

    def fill(self, seed: int) -> "Weights":
        super().fill(seed)
        gen = torch.Generator(device=self.device)
        # a stream of its own, not the one the other weights were drawn from
        gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + 0x0123456789) & ((1 << 63) - 1))
        self.qk.normal_(generator=gen).mul_(QK_SCALE_SPREAD).add_(1.0)
        return self

    def _tree(self) -> dict:
        tree = super()._tree()
        qd = self.shapes.heads * self.shapes.head_dim
        for i, layer in enumerate(tree["layers"]):
            layer["attn"]["q_norm"] = {"scale": self.qk[i, :qd]}
            layer["attn"]["k_norm"] = {"scale": self.qk[i, qd:]}
        return tree


def _moe(x: torch.Tensor, p: dict, s: Shapes, fp8: bool) -> torch.Tensor:
    """OLMoE's sparse block: softmax over all E router logits, the top k of
    those probabilities as the experts' weights (``norm_topk_prob``
    false: no renormalization)."""
    probs = torch.softmax(_mm(x, p["router"]["w"].float(), fp8), dim=-1)
    weights, sel = torch.topk(probs, s.top_k, dim=-1)
    out = torch.zeros_like(x)
    for e in range(s.experts):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _mlp(x[rows], p["w_gate"][e].float(), p["w_up"][e].float(),
                 p["w_down"][e].float(), fp8)
        out.index_add_(0, rows, y * weights[rows, slot, None])
    return out


@torch.no_grad()
def logits_at(params: dict, config: dict, seqs, *, fp8: bool = False) -> list[torch.Tensor]:
    """For each ``(tokens, start)`` in ``seqs``, the float32 logits (S -
    start, vocab) of rows ``start..S-1``: row i predicts the token at i +
    1 (as ``reference.model.logits_at``)."""
    rc = RefConfig.from_config(config)
    s = rc.shapes
    eps = rc.norm_eps
    with no_tf32():
        table = params["embed"]["table"]
        hs = [table[t.long()].float() for t, _ in seqs]
        lens = [h.shape[0] for h in hs]
        for lp in params["layers"]:
            a = lp["attn"]
            wq, wk, wv, wo = (a[n]["w"].float() for n in ("wq", "wk", "wv", "wo"))
            q_scale, k_scale = a["q_norm"]["scale"].float(), a["k_norm"]["scale"].float()
            scale = lp["ln_attn"]["scale"].float()
            for i, h in enumerate(hs):
                xn = _rmsnorm(h, scale, eps)
                n = h.shape[0]
                q = _rmsnorm(_mm(xn, wq, fp8), q_scale, eps)
                k = _rmsnorm(_mm(xn, wk, fp8), k_scale, eps)
                q = _rope(q.view(n, s.heads, s.head_dim), rc.rope_theta)
                k = _rope(k.view(n, s.kv_heads, s.head_dim), rc.rope_theta)
                v = _mm(xn, wv, fp8).view(n, s.kv_heads, s.head_dim)
                hs[i] = h + _mm(_attention(q, k, v, fp8).reshape(n, -1), wo, fp8)
            del wq, wk, wv, wo
            x = torch.cat(hs)
            xn = _rmsnorm(x, lp["ln_ffn"]["scale"].float(), eps)
            x = x + _moe(xn, lp["ffn"], s, fp8)
            hs = list(torch.split(x, lens))
        head = params["lm_head"]["w"].float()
        final = params["ln_f"]["scale"].float()
        return [_mm(_rmsnorm(h[start:], final, eps), head, fp8)
                for h, (_, start) in zip(hs, seqs)]
