"""Plain forward of the dense decoder (deepseek-7b) and of a top-k MoE
decoder whose router softmaxes its top-k logits (Mixtral's routing, the
port's), computed layer by layer in float32 with TF32 off: the reference of
every configuration file whose module, if it names one, defines no
``logits_at`` of its own.

It follows the published layer equations, with the departures that the
configuration files list (those of the program it judges): pre-norm RMSNorm
layers, half-split RoPE at positions ``0..S-1``, causal softmax attention
scaled by 1/sqrt(head dim) (grouped query heads share their KV head), a
SwiGLU MLP, or a float32 router whose top-k logits are softmaxed into the
experts' weights, each chosen expert a SwiGLU; final RMSNorm and the LM
head. It reads the weights the benchmark made (bf16 tensors, upcast a
layer at a time) and nothing the program made.

``fp8=True`` is the control: the same forward with every matrix product's
operands rounded to float8 e4m3 (activations per row, weights per output
column, scaled to the format's range; float32 accumulation), as an fp8
serving path would compute, attention's q, k and v per head vector too.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from bench.counts import Shapes

__all__ = ["RefConfig", "logits_at", "no_tf32"]

_FP8_MAX = 448.0
_Q_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class RefConfig:
    shapes: Shapes
    norm_eps: float
    rope_theta: float

    @classmethod
    def from_config(cls, c: dict) -> "RefConfig":
        return cls(Shapes.from_config(c), float(c["rms_norm_eps"]), float(c["rope_theta"]))


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3, scaled per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = _q8(x, -1), _q8(w, -2)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1, half-split rotation."""
    s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., 2 * half:]], dim=-1)


def _attention(q, k, v, fp8: bool) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, D), k, v (S, Hkv, D)."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    if fp8:
        q, k, v = _q8(q, -1), _q8(k, -1), _q8(v, -1)
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for a in range(0, s, _Q_BLOCK):
        b = min(a + _Q_BLOCK, s)
        scores = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * d ** -0.5
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v[:b])
    return out


def _mlp(x, w_gate, w_up, w_down, fp8: bool) -> torch.Tensor:
    g = _mm(x, w_gate, fp8)
    return _mm(torch.nn.functional.silu(g) * _mm(x, w_up, fp8), w_down, fp8)


def _moe(x: torch.Tensor, p: dict, s: Shapes, fp8: bool) -> torch.Tensor:
    top, sel = torch.topk(_mm(x, p["router"]["w"].float(), fp8), s.top_k, dim=-1)
    weights = torch.softmax(top, dim=-1)
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
    """For each ``(tokens, start)`` in ``seqs`` (tokens a 1-D integer tensor
    on the weights' device), the float32 logits (S - start, vocab) of rows
    ``start..S-1`` of the model of configuration file ``config``: row i
    predicts the token at i + 1."""
    rc = RefConfig.from_config(config)
    s = rc.shapes
    with no_tf32():
        table = params["embed"]["table"]
        hs = [table[t.long()].float() for t, _ in seqs]
        lens = [h.shape[0] for h in hs]
        for lp in params["layers"]:
            a = lp["attn"]
            wq, wk, wv, wo = (a[n]["w"].float() for n in ("wq", "wk", "wv", "wo"))
            scale = lp["ln_attn"]["scale"].float()
            for i, h in enumerate(hs):
                xn = _rmsnorm(h, scale, rc.norm_eps)
                n = h.shape[0]
                q = _rope(_mm(xn, wq, fp8).view(n, s.heads, s.head_dim), rc.rope_theta)
                k = _rope(_mm(xn, wk, fp8).view(n, s.kv_heads, s.head_dim), rc.rope_theta)
                v = _mm(xn, wv, fp8).view(n, s.kv_heads, s.head_dim)
                hs[i] = h + _mm(_attention(q, k, v, fp8).reshape(n, -1), wo, fp8)
            del wq, wk, wv, wo
            x = torch.cat(hs)
            xn = _rmsnorm(x, lp["ln_ffn"]["scale"].float(), rc.norm_eps)
            f = lp["ffn"]
            if s.experts:
                x = x + _moe(xn, f, s, fp8)
            else:
                x = x + _mlp(xn, f["w_gate"]["w"].float(), f["w_up"]["w"].float(),
                             f["w_down"]["w"].float(), fp8)
            hs = list(torch.split(x, lens))
        head = params["lm_head"]["w"].float()
        final = params["ln_f"]["scale"].float()
        return [_mm(_rmsnorm(h[start:], final, rc.norm_eps), head, fp8)
                for h, (_, start) in zip(hs, seqs)]
