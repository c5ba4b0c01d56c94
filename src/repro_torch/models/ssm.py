"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

A port of ``repro.models.ssm``: the chunked SSD form for training and
prefill (quadratic within a chunk, a linear state pass between chunks) and
the exact recurrent step for decode. ``ssd_chunked`` is the plain version of
kernel B7 (``repro_torch.kernels.ssd``), as ``ops._ssd_jnp`` makes it in the
reference; ``ops.ssd`` dispatches between them.

Rounding points kept from the reference: the prefill convolution runs in the
activation dtype, the decode convolution is a float32 einsum cast
afterwards; the SSD runs in float32 and returns y in x's dtype; the gate
``(y * silu(z))`` is cast to z's dtype before the norm. The conv state that
prefill saves is the raw pre-convolution ``xbc``.

``mamba_decode`` writes the new conv and SSD states into the state it is
given, in place (the reference returns new arrays), so decode over states
stacked for all layers allocates nothing per step but its temporaries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import grad_placed_like, placed_like, write_local
from repro_torch.dist.sharding import distribute_caches
from repro_torch.kernels import ops
from repro_torch.models import layers as L

__all__ = [
    "ssd_chunked",
    "mamba_init",
    "mamba_apply",
    "mamba_decode",
    "mamba_init_state",
    "mamba_prefill",
    "d_inner",
    "n_ssm_heads",
]


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    di = d_inner(cfg)
    assert di % cfg.ssm.head_dim == 0, (di, cfg.ssm.head_dim)
    return di // cfg.ssm.head_dim


# --------------------------------------------------------------------------
# chunked SSD scan
# --------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  post-softplus, >= 0
    a: torch.Tensor,   # (H,)       negative decay rates
    b: torch.Tensor,   # (B, S, N)
    c: torch.Tensor,   # (B, S, N)
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32); float32 inside. Chunks of ``min(chunk, S)`` positions."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))  # dt = 0: no update, no decay
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)
    af = a.float()

    da = dtf * af[None, None, None, :]                 # (b,nc,c,h), <= 0
    cum = torch.cumsum(da, dim=2)                      # inclusive within a chunk
    cum_h = cum.permute(0, 1, 3, 2)                    # (b,nc,h,c)

    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (c_i.b_j) x_j
    diff = cum_h[..., :, None] - cum_h[..., None, :]   # (b,nc,h,c,c)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # double where: the masked (upper-triangle) diffs are >= 0 and can
    # overflow exp to inf, which the backward turns into 0 * inf = NaN; zero
    # the exponent under the mask too so both passes stay finite.
    decay = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    cb = torch.einsum("bzin,bzjn->bzij", cf, bf)       # (b,nc,c,c)
    w = cb[:, :, None] * decay * dtf.permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", w, xf)

    # chunk state contributions: S_c = sum_j exp(cum_last - cum_j) dt_j x_j b_j^T
    cum_last = cum[:, :, -1:, :]                       # (b,nc,1,h)
    decay_end = torch.exp(cum_last - cum)              # (b,nc,c,h)
    s_c = torch.einsum("bzch,bzcn,bzchp->bzhpn", dtf * decay_end, bf, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (b,nc,h)

    # inter-chunk: the running state, chunk by chunk (the reference's scan)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    s_in = []
    for z in range(nc):
        s_in.append(state)
        state = chunk_decay[:, z, :, None, None] * state + s_c[:, z]
    s_in = torch.stack(s_in, dim=1)                    # (b,nc,h,p,n)

    y_inter = torch.einsum("bzcn,bzch,bzhpn->bzchp", cf, torch.exp(cum), s_in)
    y = (y_intra + y_inter).reshape(bsz, sp, h, p)[:, :s]
    return y.to(x.dtype), state


# --------------------------------------------------------------------------
# Mamba-2 block
# --------------------------------------------------------------------------


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random block params on ``gen``'s device at the reference's scales."""
    m = cfg.ssm
    d = cfg.d_model
    di = d_inner(cfg)
    h = n_ssm_heads(cfg)
    n = m.state_dim
    conv_ch = di + 2 * n
    pd = cfg.parameter_dtype()
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * n + h, dtype=pd),
        "conv_w": (torch.randn((m.conv_width, conv_ch), generator=gen, device=dev) * 0.2).to(pd),
        "conv_b": torch.zeros((conv_ch,), dtype=pd, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev)),  # A in [-16, -1]
        "d_skip": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.rand((h,), generator=gen, device=dev, dtype=f32) * 2.0 - 4.0,
        "norm": L.rmsnorm_init(di, pd, dev),
        "out_proj": L.dense_init(gen, di, d, dtype=pd),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of width ``w.shape[0]`` over xbc (B, S, Ch),
    in xbc's dtype."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = sum(pad[:, u : u + s, :] * w[u][None, None, :].to(xbc.dtype) for u in range(width))
    return out + bias[None, None, :].to(xbc.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di = d_inner(cfg)
    n = cfg.ssm.state_dim
    h = n_ssm_heads(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : 2 * di + 2 * n]
    dt_raw = zxbcdt[..., 2 * di + 2 * n :]
    assert dt_raw.shape[-1] == h
    return z, xbc, dt_raw


def _ssm_inputs(cfg: ModelConfig, p: dict, xbc_conv: torch.Tensor, dt_raw: torch.Tensor):
    di = d_inner(cfg)
    n = cfg.ssm.state_dim
    h = n_ssm_heads(cfg)
    xbc_act = F.silu(xbc_conv)
    x_in = xbc_act[..., :di]
    b_in = xbc_act[..., di : di + n]
    c_in = xbc_act[..., di + n :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])
    shp = x_in.shape[:-1] + (h, cfg.ssm.head_dim)
    return x_in.reshape(shp), b_in, c_in, dt, a


def _finish(cfg: ModelConfig, p: dict, y_heads, x_heads, z):
    di = d_inner(cfg)
    y = y_heads + p["d_skip"][None, None, :, None] * x_heads.float()
    y = y.reshape(y.shape[0], y.shape[1], di)
    y = L.rmsnorm(p["norm"], (y * F.silu(z.float())).to(z.dtype), cfg.norm_eps)
    # on a mesh, out_proj's input takes z's placements (the in-projection's):
    # DTensor's norm would otherwise hand it a shard of the sequence, whose
    # strided form the product cannot plan on fake tensors (a no-op off a mesh)
    y = placed_like(y, z)
    return L.dense(p["out_proj"], y, dtype=cfg.activation_dtype())


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, init_state=None) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x (B, S, d) -> (B, S, d)."""
    # on a mesh the projection's gradient comes back in its placements: the
    # causal conv's sequence slices would hand in_proj's weight gradient a
    # shard of the sequence it cannot plan on fake tensors (a no-op off a mesh)
    zxbcdt = grad_placed_like(L.dense(p["in_proj"], x, dtype=cfg.activation_dtype()))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    x_h, b_in, c_in, dt, a = _ssm_inputs(cfg, p, xbc, dt_raw)
    y, _ = ops.ssd(x_h, dt, a, b_in, c_in, chunk=cfg.ssm.chunk, init_state=init_state,
                   impl=cfg.ssd_impl)
    return _finish(cfg, p, y.float(), x_h, z)


def mamba_init_state(cfg: ModelConfig, batch: int, *, device="cpu", lead: tuple = (),
                     mesh=None, pcfg=None) -> dict:
    """Zero decode state: ``conv`` (B, width - 1, d_inner + 2N) in the
    activation dtype and ``ssd`` (B, H, P, N) float32, each with the leading
    dims ``lead`` (one allocation for a stack of layers). With ``mesh`` and
    ``pcfg`` each is a DTensor holding this rank's batch shard
    (``dist.sharding.distribute_caches``)."""
    m = cfg.ssm
    di = d_inner(cfg)
    h = n_ssm_heads(cfg)
    lead = tuple(lead)
    shapes = {"conv": (lead + (batch, m.conv_width - 1, di + 2 * m.state_dim),
                       cfg.activation_dtype()),
              "ssd": (lead + (batch, h, m.head_dim, m.state_dim), torch.float32)}
    if mesh is None:
        return {k: torch.zeros(shp, dtype=dt, device=device) for k, (shp, dt) in shapes.items()}
    return distribute_caches({k: torch.zeros((), dtype=dt, device=device).expand(shp)
                              for k, (shp, dt) in shapes.items()}, pcfg, mesh)


def mamba_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode state: the raw
    ``xbc`` of the last ``width - 1`` positions (left-padded with zeros for
    a shorter prompt) and the SSD's final state."""
    zxbcdt = L.dense(p["in_proj"], x, dtype=cfg.activation_dtype())
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x_h, b_in, c_in, dt, a = _ssm_inputs(cfg, p, xbc, dt_raw)
    y, final = ops.ssd(x_h, dt, a, b_in, c_in, chunk=cfg.ssm.chunk, impl=cfg.ssd_impl)
    out = _finish(cfg, p, y.float(), x_h, z)
    w = cfg.ssm.conv_width
    conv_state = xbc_raw[:, -(w - 1) :, :]
    pad = (w - 1) - conv_state.shape[1]
    if pad > 0:
        conv_state = F.pad(conv_state, (0, 0, pad, 0))
    return out, {"conv": conv_state, "ssd": final}


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
    """One-token step, x (B, 1, d), with the exact recurrence (the
    sequential oracle's). Writes the new ``conv`` and ``ssd`` into
    ``state`` in place and returns (out (B, 1, d), state)."""
    dt_act = cfg.activation_dtype()
    zxbcdt = L.dense(p["in_proj"], x, dtype=dt_act)
    z, xbc_t, dt_raw = _split_proj(cfg, zxbcdt)

    hist = torch.cat([state["conv"], xbc_t], dim=1)  # (B, w, Ch)
    conv_out = (
        torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float()) + p["conv_b"].float()
    )[:, None, :].to(dt_act)

    x_h, b_in, c_in, dt, a = _ssm_inputs(cfg, p, conv_out, dt_raw)
    dtf = dt[:, 0]                                                   # (B, H)
    decay = torch.exp(dtf * a[None, :])[..., None, None]
    upd = (dtf[..., None] * x_h[:, 0].float())[..., :, None] * b_in[:, 0, None, None, :].float()
    # on a mesh the new state takes the state's placements (its batch shard)
    # here, not at the write below: its head shard, flattened by the einsum,
    # cannot be planned on fake tensors (a no-op off a mesh)
    s_new = placed_like(decay * state["ssd"] + upd, state["ssd"])
    y = torch.einsum("bhpn,bn->bhp", s_new, c_in[:, 0].float())[:, None]
    out = _finish(cfg, p, y, x_h, z)
    write_local(state["conv"], hist[:, 1:])
    write_local(state["ssd"], s_new)
    return out, state
