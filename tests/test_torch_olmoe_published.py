"""OLMoE-1B-7B as published (``olmoe-1b-7b-0924``, the port's own id) on the
CPU, reduced, in float32, against plain torch versions written here:

* the routing (``MoEConfig.norm_topk_prob`` off): a softmax over all E
  router logits, the top k of it as the weights, not renormalized, on the
  dropless and the capacity paths; the aux losses as the default routing's;
* the q/k norm (``ModelConfig.qk_norm``) in ``_qkv``: the whole q and k
  projections RMS-normed by their own scales before the heads are split
  and roped;
* prefill then decode, through the contiguous and the paged cache, against
  a plain full forward at every position;
* greedy streams of ``ServeEngine``, continuous (the compact wide step at
  R = 2 by a lowered ``WIDE_POSITIONS``) and static, each token's logit
  within float32 rounding (1e-4) of the plain forward's best;
* the expert counters: the instant ``serve.moe`` holds rows = positions x
  k x L for the plan the engine ran, groups at most E x launches, the
  registry's counters the same; a dense model records none; each captured
  step of both widths adds its rows under ``test_torch_step_graph``'s
  host-read guard;
* the q/k scales on a head-split mesh (2 gloo ranks, the harness of
  ``test_torch_dist.py``): kept whole, and the sharded prefill and streams
  the unsharded ones.

The q/k scales are drawn around one: scales of one would hide a dropped
scale.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import engine as engine_mod
from test_torch_step_graph import NoHostRead

ARCH = "olmoe-1b-7b-0924"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg():
    return get_config(ARCH).reduced()


def _params(cfg, seed=0):
    """The port's init, with every q/k norm scale drawn around one."""
    p = build_model(cfg, device="cpu").init(seed)
    gen = torch.Generator().manual_seed(seed + 100)
    for lp in p["layers"]:
        for name in ("q_norm", "k_norm"):
            s = lp["attn"][name]["scale"]
            s.copy_(1.0 + 0.3 * torch.randn(s.shape, generator=gen))
    return p


# ---- plain versions -------------------------------------------------------------


def _plain_rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _plain_rope(x, pos, theta):
    """x (S, H, D) at positions pos (S,), half-split."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _plain_qk(a, cfg, x, pos):
    """q (S, H, hd), k (S, Hkv, hd) of x (S, d): each projection normed
    whole, then split and roped."""
    s = x.shape[0]
    q = _plain_rms(x @ a["wq"]["w"], a["q_norm"]["scale"], cfg.norm_eps)
    k = _plain_rms(x @ a["wk"]["w"], a["k_norm"]["scale"], cfg.norm_eps)
    return (_plain_rope(q.view(s, cfg.n_heads, cfg.hd), pos, cfg.rope_theta),
            _plain_rope(k.view(s, cfg.n_kv_heads, cfg.hd), pos, cfg.rope_theta))


def _plain_moe(f, cfg, x):
    """OLMoE's block on x (T, d): softmax over all E, top k of it, no
    renormalization, each chosen expert a SwiGLU."""
    probs = torch.softmax(x @ f["router"]["w"], -1)
    w, sel = torch.topk(probs, cfg.moe.top_k, -1)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(sel[t, j])
            h = F.silu(x[t] @ f["w_gate"][e]) * (x[t] @ f["w_up"][e])
            out[t] += w[t, j] * (h @ f["w_down"][e])
    return out


def _plain_logits(p, cfg, tokens):
    """(S, vocab) logits of the whole sequence ``tokens`` (S,)."""
    s = len(tokens)
    pos = torch.arange(s)
    h = p["embed"]["table"][torch.as_tensor(tokens).long()]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    rep = cfg.n_heads // cfg.n_kv_heads
    for lp in p["layers"]:
        xn = _plain_rms(h, lp["ln_attn"]["scale"], cfg.norm_eps)
        a = lp["attn"]
        q, k = _plain_qk(a, cfg, xn, pos)
        v = (xn @ a["wv"]["w"]).view(s, cfg.n_kv_heads, cfg.hd)
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(cfg.hd)
        o = torch.einsum("hqk,khd->qhd", torch.softmax(sc.masked_fill(~mask, -1e30), -1), v)
        h = h + o.reshape(s, -1) @ a["wo"]["w"]
        h = h + _plain_moe(lp["ffn"], cfg, _plain_rms(h, lp["ln_ffn"]["scale"], cfg.norm_eps))
    return _plain_rms(h, p["ln_f"]["scale"], cfg.norm_eps) @ p["lm_head"]["w"]


# ---- routing and q/k norm ---------------------------------------------------------


@pytest.mark.parametrize("path", ["dropless", "capacity"])
def test_published_routing(path):
    """Both paths route as OLMoE (the capacity path with room for every
    choice); the aux losses are the default routing's, which reads the
    same logits."""
    cfg = _cfg()
    cfg = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "capacity_factor": 8.0}))
    f = _params(cfg)["layers"][0]["ffn"]
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(2))
    y, aux = MOE.moe_apply(f, cfg, x, dropless=path == "dropless")
    want = _plain_moe(f, cfg, x.reshape(-1, cfg.d_model)).reshape(x.shape)
    torch.testing.assert_close(y, want, atol=TOL, rtol=TOL)
    base = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "norm_topk_prob": True}))
    y_base, aux_base = MOE.moe_apply(f, base, x, dropless=path == "dropless")
    assert float(aux) == pytest.approx(float(aux_base), rel=1e-6)
    assert not torch.allclose(y, y_base, atol=1e-3)   # the routing tells


def test_qk_norm_in_qkv():
    cfg = _cfg()
    a = _params(cfg)["layers"][1]["attn"]
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(7, dtype=torch.int32)[None].expand(2, 7)
    q, k, v = T._qkv(a, cfg, x, x, pos, pos)
    for b in range(2):
        pq, pk = _plain_qk(a, cfg, x[b], pos[b])
        torch.testing.assert_close(q[b], pq, atol=TOL, rtol=TOL)
        torch.testing.assert_close(k[b], pk, atol=TOL, rtol=TOL)
    assert set(a) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert a["q_norm"]["scale"].shape == (cfg.n_heads * cfg.hd,)
    assert a["k_norm"]["scale"].shape == (cfg.n_kv_heads * cfg.hd,)
    assert "q_norm" not in T.attn_init(torch.Generator(), cfg.with_(qk_norm=False))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_then_decode_equals_the_full_forward(layout):
    cfg = _cfg().with_(kv_layout=layout, page_size=8 if layout == "paged" else None)
    p = _params(cfg, 1)
    lm = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(4).integers(2, cfg.vocab, size=(2, 15)).astype(np.int32)
    prompt = 9
    full = [_plain_logits(p, cfg, t) for t in tokens]
    logits, caches = lm.prefill(p, {"tokens": torch.as_tensor(tokens[:, :prompt])}, 32)
    got = [logits[:, -1]]
    for i in range(prompt, tokens.shape[1]):
        logits, caches = lm.decode_step(p, torch.as_tensor(tokens[:, i:i + 1]), caches)
        got.append(logits[:, -1])
    got = torch.stack(got, 1)
    want = torch.stack([f[prompt - 1:] for f in full])
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


# ---- the engines ------------------------------------------------------------------


def _gaps(p, cfg, results, prompts) -> float:
    """The widest gap, over every served token, between the plain
    forward's best logit and its logit of the token."""
    worst = 0.0
    for r, prompt in zip(results, prompts):
        seq = np.concatenate([prompt, r.tokens[:-1]])
        lg = _plain_logits(p, cfg, seq)[len(prompt) - 1:]
        best = lg.max(-1).values
        worst = max(worst, float((best - lg[torch.arange(len(r.tokens)),
                                            torch.as_tensor(r.tokens).long()]).max()))
    return worst


def _prompts(cfg, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab, size=n).astype(np.int32) for n in lens]


def _rows(eng) -> int:
    return eng._moe.read()["rows"]


def _moe_instant(eng) -> dict:
    got = [e.args for e in eng.tracer.events() if e.name == "serve.moe"]
    assert len(got) == 1
    return got[0]


def test_continuous_streams_and_counters(monkeypatch):
    """Six slots, chunk 8, R = 2: prompts of one to three chunks arriving
    at steps 0, 2 and 4, so steps carry 1, 2 and 3 wide rows. Every token
    is the plain forward's best; ``serve.moe`` counts k x L rows a
    position the steps computed, and L launches a replay."""
    monkeypatch.setattr(engine_mod, "WIDE_POSITIONS", 2 * 8)
    cfg = _cfg()
    p = _params(cfg, 2)
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, p, scheduler="continuous", batch_size=6, max_len=64, page_size=8,
                      prefill_chunk=8, token_budget=6 * 8, device="cpu")
    assert eng._rows == 2
    prompts = _prompts(cfg, [20, 9, 17, 5, 12, 24])
    reqs = [Request(tokens=t, max_new_tokens=5, rid=i, arrival=[0, 0, 0, 2, 2, 4][i], eos_id=-1)
            for i, t in enumerate(prompts)]
    results = eng.generate(reqs)
    assert all(len(r.tokens) == 5 and r.status == "ok" for r in results)
    assert _gaps(p, cfg, results, prompts) < TOL
    steps = [e.args for e in eng.tracer.events() if e.name == "serve.device_step"]
    assert any(s.get("replays", 0) >= 2 for s in steps)
    positions = sum(s["positions"] for s in steps)
    replays = sum(s.get("replays", 1) for s in steps)
    got = _moe_instant(eng)
    k, n_layers, e = cfg.moe.top_k, cfg.n_layers, cfg.moe.num_experts
    assert got["layers"] == n_layers and got["launches"] == n_layers * replays
    assert got["rows"] == positions * k * n_layers
    assert 0 < got["groups"] <= e * got["launches"]
    assert got["rows"] / n_layers / e <= got["rows_max"] <= got["rows"]
    assert eng.obs.value("serve.moe.rows") == got["rows"]
    assert eng.obs.value("serve.moe.groups") == got["groups"]
    # zeroed at every generate(): the same plan counts the same again
    eng.generate(reqs)
    again = [e.args for e in eng.tracer.events() if e.name == "serve.moe"][-1]
    assert again == got and eng.obs.value("serve.moe.rows") == 2 * got["rows"]


def test_static_streams_and_counters():
    cfg = _cfg()
    p = _params(cfg, 3)
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, p, scheduler="static", batch_size=2, max_len=64, device="cpu")
    prompts = _prompts(cfg, [9, 9, 13, 13])
    results = eng.generate([Request(tokens=t, max_new_tokens=4, rid=i, eos_id=-1)
                            for i, t in enumerate(prompts)])
    assert all(len(r.tokens) == 4 for r in results)
    assert _gaps(p, cfg, results, prompts) < TOL
    events = eng.tracer.events()
    prefill = sum(e.args["positions"] for e in events if e.name == "serve.prefill")
    decode = sum(1 for e in events if e.name == "serve.decode_step")
    got = _moe_instant(eng)
    assert prefill == 2 * 9 + 2 * 13 and decode == 2 * 3
    assert got["rows"] == (prefill + 2 * decode) * cfg.moe.top_k * cfg.n_layers
    assert got["launches"] == (2 + decode) * cfg.n_layers
    assert 0 < got["groups"] <= cfg.moe.num_experts * got["launches"]


def test_a_dense_model_records_no_expert_counters():
    cfg = get_config("deepseek-7b").reduced()
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, lm.init(0), scheduler="continuous", batch_size=2, max_len=64,
                      page_size=8, prefill_chunk=16, device="cpu")
    eng.generate([Request(tokens=t, max_new_tokens=3, rid=i)
                  for i, t in enumerate(_prompts(cfg, [6, 11]))])
    assert eng._moe is None
    assert not [e for e in eng.tracer.events() if e.name == "serve.moe"]
    assert eng.obs.find("serve.moe.rows") is None and eng.obs.find("serve.moe.groups") is None


@pytest.mark.parametrize("width", ["mixed/1", "mixed/16"])
def test_captured_steps_count_and_read_no_host_value(width):
    """The step the card captures, with the counters' adds in it, under
    the host-read guard: it adds its rows x width x k x L rows."""
    cfg = _cfg()
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, _params(cfg), scheduler="continuous", batch_size=2, max_len=96,
                      page_size=8, prefill_chunk=16, device="cpu")
    eng.generate([Request(tokens=t, max_new_tokens=4, rid=i)
                  for i, t in enumerate(_prompts(cfg, [20, 7]))])
    step = eng.step_graphs()[width]
    before = _rows(eng)
    with NoHostRead():
        logits, greedy = step()
    assert torch.isfinite(logits).all()
    n, c = step.inputs["tokens"].shape
    assert _rows(eng) - before == n * c * cfg.moe.top_k * cfg.n_layers


# ---- a head-split mesh -------------------------------------------------------------

_MESH_BODY = '''
def body(rank, world, out):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.dist.context import on_mesh, whole
    from repro_torch.dist.sharding import distribute, param_specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    inp = torch.load("inputs.pt", weights_only=False)
    cfg = get_config("olmoe-1b-7b-0924").reduced()
    lm = build_model(cfg, device="cpu")
    mesh = make_local_mesh(1, 2, device="cpu")
    pcfg = ParallelConfig(fsdp_axes=("data",), data_axes=("data",))
    params = inp["params"]
    dp = distribute(params, param_specs(params, pcfg, mesh), mesh)
    attn = dp["layers"][0]["attn"]
    res = {n: [str(p) for p in attn[n]["scale"].placements] for n in ("q_norm", "k_norm")}
    res["wq"] = [str(p) for p in attn["wq"]["w"].placements]
    with on_mesh(mesh, pcfg=pcfg):
        logits, _ = lm.prefill(dp, {"tokens": inp["tokens"]}, 32)
    res["prefill"] = whole(logits)
    eng = ServeEngine(lm, params, batch_size=2, max_len=64, mesh=mesh, scheduler="continuous",
                      device="cpu", page_size=8, prefill_chunk=16)
    res["streams"] = [r.tokens.tolist() for r in eng.generate(
        [Request(tokens=t, max_new_tokens=4, rid=i) for i, t in enumerate(inp["prompts"])])]
    return res
'''


def test_qk_norm_on_a_head_split_mesh(tmp_path):
    """On a (1, 2) mesh every projection's heads are split over the tensor
    axis; the scales stay whole and the norm reduces over the whole
    projection, so the sharded prefill and streams are the unsharded
    ones."""
    from test_torch_dist import _run_ranks

    cfg = _cfg()
    params = _params(cfg, 4)
    lm = build_model(cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(6).integers(2, cfg.vocab, (2, 11)),
                             dtype=torch.int32)
    prompts = _prompts(cfg, [10, 13], seed=7)
    ranks = _run_ranks(tmp_path, _MESH_BODY,
                       {"params": params, "tokens": tokens, "prompts": prompts}, world=2)
    want, _ = lm.prefill(params, {"tokens": tokens}, 32)
    eng = ServeEngine(lm, params, batch_size=2, max_len=64, scheduler="continuous",
                      device="cpu", page_size=8, prefill_chunk=16)
    streams = [r.tokens.tolist() for r in eng.generate(
        [Request(tokens=t, max_new_tokens=4, rid=i) for i, t in enumerate(prompts)])]
    for res in ranks:
        assert res["q_norm"] == res["k_norm"] == ["R", "R"]
        assert res["wq"][1] == "S(1)"   # the heads split on "model"
        torch.testing.assert_close(res["prefill"], want, atol=1e-5, rtol=1e-5)
        assert res["streams"] == streams
