"""The port's SSM (mamba2-130m) and hybrid (zamba2-2.7b) models against the
JAX package's, on the same weights.

The reference's params (``LM.init`` of the ``.reduced()`` configs, float32)
are loaded into the port with ``params_from_jax``; inputs are drawn with
numpy from a seed. Covered: the weight layouts, the Mamba-2 block
(``mamba_apply``, ``mamba_prefill`` with both states, ``mamba_decode``),
``LM.prefill`` logits and caches then ``decode_step``, prefill followed by
decode against the full forward, ``LM.loss`` and its gradients, greedy
static ``ServeEngine`` streams (with a prompt longer than ``max_len``) and
the launcher on the CPU. Tolerances (float32), relative to the output's
scale as in ``test_torch_ssd.py``: 1e-5 for a block and for states, 1e-4
for logits, the loss and its gradients; greedy streams equal token for
token.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm
from repro_torch.serve import Request, ServeEngine
from repro_torch.testing import params_from_jax
from repro_torch.train.optimizer import named_leaves

BLOCK = 1e-5    # a block's output and the states
LOGITS = 1e-4   # logits, loss and gradients
ARCHS = ["mamba2-130m", "zamba2-2_7b"]


def _close(got, want, tol, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=err_msg)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jlm = ref_build_model(ref_get_config(request.param).reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config(request.param).reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


# ---- weights -------------------------------------------------------------------


def test_params_from_jax_layouts(models):
    """Stacked SSM layers become a list; the hybrid's (groups, every)
    stacked Mamba layers become nested lists and its unstacked shared block
    is converted as it is, not indexed."""
    _, jparams, lm, params = models
    cfg = lm.cfg
    jl = jax.tree.map(np.asarray, jparams["layers"])
    if cfg.family == "ssm":
        assert isinstance(params["layers"], list) and len(params["layers"]) == cfg.n_layers
        for i, lp in enumerate(params["layers"]):
            np.testing.assert_array_equal(lp["mamba"]["in_proj"]["w"].numpy(),
                                          jl["mamba"]["in_proj"]["w"][i])
            np.testing.assert_array_equal(lp["ln"]["scale"].numpy(), jl["ln"]["scale"][i])
        return
    g, e = HY.n_groups(cfg), cfg.ssm.shared_attn_every
    mamba = params["layers"]["mamba"]
    assert len(mamba) == g and all(len(gp) == e for gp in mamba)
    for i in range(g):
        for j in range(e):
            np.testing.assert_array_equal(mamba[i][j]["mamba"]["conv_w"].numpy(),
                                          jl["mamba"]["mamba"]["conv_w"][i, j])
    shared = params["layers"]["shared"]
    for path in (("proj_in", "w"), ("attn", "wq", "w"), ("ffn", "w_down", "w"),
                 ("ln_attn", "scale")):
        got, want = shared, jl["shared"]
        for k in path:
            got, want = got[k], want[k]
        np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_rejects_other_layouts():
    base = {"embed": {"table": np.zeros((4, 2), np.float32)}}
    ragged = {"a": {"w": np.zeros((3, 2), np.float32)}, "b": np.zeros((2, 5), np.float32)}
    with pytest.raises(ValueError, match="stacked leading axes"):
        params_from_jax(dict(base, layers=ragged))
    hybrid = {"mamba": {"w": np.zeros((2, 3, 4), np.float32), "v": np.zeros((2, 2, 4),
                                                                             np.float32)},
              "shared": {"w": np.zeros((4, 4), np.float32)}}
    with pytest.raises(ValueError, match="stacked leading axes"):
        params_from_jax(dict(base, layers=hybrid))


# ---- the Mamba-2 block ------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """mamba2-130m reduced: one block's params from the JAX init, and an
    input (2, 33, d)."""
    cfg = get_config("mamba2-130m").reduced()
    jcfg = ref_get_config("mamba2-130m").reduced()
    jp = ref_ssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax({"layers": jax.tree.map(lambda a: np.asarray(a)[None], jp)})["layers"][0]
    x = np.random.default_rng(1).normal(size=(2, 33, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, jp, x


def test_mamba_apply_matches_reference(block):
    cfg, jcfg, p, jp, x = block
    _close(ssm.mamba_apply(p, cfg, torch.from_numpy(x)),
           ref_ssm.mamba_apply(jp, jcfg, jnp.asarray(x)), BLOCK)


def test_mamba_prefill_and_decode_match_reference(block):
    """Prefill's output, its conv state (the raw pre-convolution xbc of the
    last width - 1 positions) and SSD state; then a decode step from the
    same state: output and both new states, written in place."""
    cfg, jcfg, p, jp, x = block
    out, st = ssm.mamba_prefill(p, cfg, torch.from_numpy(x[:, :-1]))
    jout, jst = ref_ssm.mamba_prefill(jp, jcfg, jnp.asarray(x[:, :-1]))
    _close(out, jout, BLOCK)
    for name in ("conv", "ssd"):
        _close(st[name], jst[name], BLOCK, err_msg=name)
    state = {name: t.clone() for name, t in st.items()}
    out, new = ssm.mamba_decode(p, cfg, torch.from_numpy(x[:, -1:]), state)
    jout, jnew = ref_ssm.mamba_decode(jp, jcfg, jnp.asarray(x[:, -1:]), jst)
    _close(out, jout, BLOCK)
    for name in ("conv", "ssd"):
        assert new[name] is state[name]
        _close(state[name], jnew[name], BLOCK, err_msg=name)


def test_mamba_prefill_of_a_short_prompt_pads_the_conv_state(block):
    cfg, jcfg, p, jp, x = block
    _, st = ssm.mamba_prefill(p, cfg, torch.from_numpy(x[:, :2]))
    _, jst = ref_ssm.mamba_prefill(jp, jcfg, jnp.asarray(x[:, :2]))
    assert st["conv"].shape == (2, cfg.ssm.conv_width - 1, st["conv"].shape[-1])
    _close(st["conv"], jst["conv"], BLOCK)


def test_mamba_prefill_then_decode_matches_full(block):
    """The reference's own check (test_ssd.py:45), on the port."""
    cfg, _, p, _, x = block
    xt = torch.from_numpy(x)
    full = ssm.mamba_apply(p, cfg, xt)
    out_pre, state = ssm.mamba_prefill(p, cfg, xt[:, :-1])
    np.testing.assert_allclose(out_pre.numpy(), full[:, :-1].numpy(), atol=2e-3, rtol=2e-3)
    out_dec, _ = ssm.mamba_decode(p, cfg, xt[:, -1:], state)
    np.testing.assert_allclose(out_dec.numpy(), full[:, -1:].numpy(), atol=2e-3, rtol=2e-3)


# ---- LM ---------------------------------------------------------------------------


def test_prefill_and_decode_match_reference(models):
    jlm, jparams, lm, params = models
    cfg = lm.cfg
    b, s, max_len = 3, 45, 60
    toks = _tokens(cfg.vocab, (b, s), 2)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    pl, pc = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len)
    assert pl.shape == (b, 1, cfg.vocab)
    _close(pl, jl, LOGITS)

    def check_caches():
        for name in ("conv", "ssd"):
            _close(pc["mamba"][name], jc["mamba"][name], BLOCK, err_msg=name)
        if cfg.family == "hybrid":
            for name in ("k", "v"):
                _close(pc["attn"][name], jc["attn"][name], BLOCK, err_msg=name)
            assert int(pc["attn"]["len"]) == int(pc["len"])
        assert pc["len"].dim() == 0 and pc["len"].dtype == torch.int32  # on the device
        assert int(pc["len"]) == int(jc["len"])

    assert tuple(pc["mamba"]["ssd"].shape) == tuple(np.shape(jc["mamba"]["ssd"]))
    check_caches()
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        _close(pl, jl, LOGITS)
    check_caches()
    assert int(pc["len"]) == s + 5


def test_prefill_then_decode_equals_a_longer_prefill(models):
    """Decoding tokens one at a time after a prefill gives the logits a
    prefill of the longer prompt gives (the states carry exactly)."""
    _, _, lm, params = models
    toks = torch.from_numpy(_tokens(lm.cfg.vocab, (2, 30), 3))
    logits, caches = lm.prefill(params, {"tokens": toks[:, :24]}, 40)
    for t in range(24, 30):
        logits, caches = lm.decode_step(params, toks[:, t : t + 1], caches)
        want, _ = lm.prefill(params, {"tokens": toks[:, : t + 1]}, 40)
        _close(logits, want, LOGITS)


def test_loss_and_grads_match_reference(models):
    jlm, jparams, lm, params = models
    toks = _tokens(lm.cfg.vocab, (2, 40), 4)
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)}),
                                             has_aux=True)(jparams)
    leaves = list(named_leaves(params))
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss, m = lm.loss(params, {"tokens": toks})
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    _close(loss, jloss, LOGITS)
    _close(m["total_loss"], jm["total_loss"], LOGITS)
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads))))
    assert set(want) == {path for path, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        _close(g, want[path], LOGITS, err_msg=str(path))


def test_ops_ssd_reference_impl_through_the_model(models):
    """The model with the sequential oracle as its SSD (impl "reference")
    gives the chunked scan's logits, within the oracle's 3e-4."""
    _, _, lm, params = models
    toks = torch.from_numpy(_tokens(lm.cfg.vocab, (2, 20), 5))
    ref_lm = build_model(lm.cfg.with_(ssd_impl="reference"), device="cpu")
    _close(ref_lm.prefill(params, {"tokens": toks}, 32)[0],
           lm.prefill(params, {"tokens": toks}, 32)[0].numpy(), 3e-4)


# ---- serving ----------------------------------------------------------------------


def _specs(vocab, seed=3):
    rng = np.random.default_rng(seed)
    lens_new = [(5, 6), (40, 8), (17, 0), (70, 9), (3, 5), (22, 7), (9, 4)]
    return [dict(tokens=rng.integers(2, vocab, size=n).astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(lens_new)]


def test_static_engine_greedy_streams_equal_reference(models):
    """Groups of 3 (the last one short), a 0-token request and a 70-token
    prompt over max_len 64. The reference counts an SSM's state as
    unbounded, so mamba2-130m serves that prompt whole and unclamped; the
    hybrid has attention caches, so it keeps the prompt's tail and clamps
    its limit, in both packages."""
    jlm, jparams, lm, params = models
    specs = _specs(lm.cfg.vocab)
    kw = dict(batch_size=3, max_len=64)
    want = RefEngine(jlm, jparams, scheduler="static", **kw).generate(
        [RefRequest(**s) for s in specs])
    eng = ServeEngine(lm, params, device="cpu", **kw)
    got = eng.generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert b.rid == a.rid and b.status == a.status == "ok" and b.steps == a.steps
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert got[2].steps == 0
    assert got[3].steps == (9 if lm.cfg.family == "ssm" else 1)


def test_ssm_prompt_longer_than_max_len_is_served_whole():
    """One mamba2-130m request alone: its 50-token prompt over max_len 16
    is not left-truncated (the reference's SSM capacity), so its greedy
    stream equals the reference's and differs from that of the prompt's
    16-token tail."""
    jlm = ref_build_model(ref_get_config("mamba2-130m").reduced())
    jparams = jlm.init(jax.random.PRNGKey(1))
    lm = build_model(get_config("mamba2-130m").reduced(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = _tokens(lm.cfg.vocab, (50,), 6)
    kw = dict(batch_size=1, max_len=16)
    want = RefEngine(jlm, jparams, scheduler="static", **kw).generate(
        [RefRequest(tokens=prompt, max_new_tokens=20)])[0]
    eng = ServeEngine(lm, params, device="cpu", **kw)
    got = eng.generate([Request(tokens=prompt, max_new_tokens=20)])[0]
    tail = eng.generate([Request(tokens=prompt[-16:], max_new_tokens=20)])[0]
    assert got.steps == want.steps == 20
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert eng.obs.value("serve.step.tokens", kind="prefill") == 50 + 16
    assert not np.array_equal(tail.tokens, got.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                       "--batch-size", "2", "--max-new", "4", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "using static groups" in out
    with pytest.raises(ValueError, match="continuous"):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--scheduler", "continuous"])
