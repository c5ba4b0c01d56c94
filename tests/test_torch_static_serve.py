"""The port's static serve path against the JAX package, on the same weights.

deepseek-7b ``.reduced()`` (f32), with the reference's init loaded into the
port by ``params_from_jax``:

* ``LM.prefill``: last-position logits and the caches of every layer, for
  full attention, a sliding window (``window=32``, a ring buffer that the
  prompt overfills) and the paged layout (``fill_cache`` through the
  identity block table); then decode steps over those caches. Tolerance:
  f32, atol = rtol = 2e-4 (the layers sum in other orders).
* ``ServeEngine(scheduler="static")``: greedy streams equal to the
  reference's token for token for the three traversal orders, with left
  padding into a shared bucket, a cancelled request, an expired deadline, a
  0-limit row, a prompt longer than ``max_len`` and a short last group.
* The launcher's ``--scheduler static`` and ``auto`` on the CPU.

The other dense configs (qwen2-72b, codeqwen1_5-7b, llama3-405b, paper-gb10
``.reduced()``, each with its own reference init) and the MoE configs
(olmoe-1b-7b, mixtral-8x7b, whose window makes a ring buffer) are cases of
the prefill and the engine tests.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.testing import params_from_jax

TOL = dict(atol=2e-4, rtol=2e-4)
B, S, MAX_LEN = 3, 45, 60
# The other dense configs, held to the reference as cases of the tests below.
OTHER_DENSE = ["qwen2-72b", "codeqwen1_5-7b", "llama3-405b", "paper-gb10"]
# The MoE configs (mixtral through its window's ring buffer), cases of the same.
MOE = ["olmoe-1b-7b", "mixtral-8x7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _models(weights, arch="deepseek-7b", **kw):
    """Reference and port models of ``arch`` (its ``.reduced()`` config
    with ``kw``) and their weights: deepseek-7b's shared ones, another
    arch's from its own reference init."""
    if arch == "deepseek-7b":
        jparams, params = weights
    else:
        jparams = ref_build_model(ref_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
    jlm = ref_build_model(ref_get_config(arch).reduced().with_(**kw))
    lm = build_model(get_config(arch).reduced().with_(**kw), device="cpu")
    return jlm, jparams, lm, params


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window=32),
    dict(attn_order="cyclic"),
    dict(attn_order="block_snake", snake_group=2, q_block=16, kv_block=16),
    *[dict(arch=arch) for arch in OTHER_DENSE + MOE],
], ids=["full", "swa", "cyclic", "block_snake", *OTHER_DENSE, *MOE])
def test_prefill_and_decode_match_reference(weights, kw):
    jlm, jparams, lm, params = _models(weights, **kw)
    rng = np.random.default_rng(len(kw))
    toks = rng.integers(2, lm.cfg.vocab, size=(B, S)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    pl, pc = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert pl.shape == (B, 1, lm.cfg.vocab)
    _close(pl, jl)
    size = min(MAX_LEN, lm.cfg.window or MAX_LEN)   # a window's ring buffer
    assert pc["k"].shape == (lm.cfg.n_layers, B, size, lm.cfg.n_kv_heads, lm.cfg.hd)
    for name in ("k", "v"):
        _close(pc[name], jc[name])
    assert pc["len"].dim() == 0 and pc["len"].dtype == torch.int32  # on the device
    assert int(pc["len"]) == S and np.all(np.asarray(jc["len"]) == S)
    # Decode steps (past the ring buffer's wrap with a window).
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        _close(pl, jl)
    for name in ("k", "v"):
        _close(pc[name], jc[name])
    assert int(pc["len"]) == S + 4


def test_paged_prefill_fills_pages_like_reference(weights):
    """``fill_cache`` into a paged cache (identity block table), then two
    decode steps through the paged chunk step."""
    _paged_prefill_and_decode(*_models(weights, kv_layout="paged", page_size=8))


@pytest.mark.parametrize("arch", MOE)
def test_moe_paged_prefill_and_decode_like_reference(weights, arch):
    """The same for the MoE configs: the prefill's dropless FFN over the
    whole prompt, then the paged chunk steps. mixtral's window has no paged
    layout: both packages refuse its paged prefill alike."""
    models = _models(weights, arch, kv_layout="paged", page_size=8)
    if models[2].cfg.window is None:
        _paged_prefill_and_decode(*models)
        return
    for lm, p, toks in ((models[0], models[1], jnp.zeros((B, S), jnp.int32)),
                        (models[2], models[3], torch.zeros((B, S), dtype=torch.int32))):
        with pytest.raises(ValueError, match="paged KV layout requires full attention"):
            lm.prefill(p, {"tokens": toks}, MAX_LEN)


def _paged_prefill_and_decode(jlm, jparams, lm, params):
    rng = np.random.default_rng(5)
    toks = rng.integers(2, lm.cfg.vocab, size=(B, S)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    pl, pc = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    _close(pl, jl)
    for name in ("k_pages", "v_pages"):
        _close(pc[name], jc[name])
    np.testing.assert_array_equal(pc["block_table"].numpy(), np.asarray(jc["block_table"])[0])
    np.testing.assert_array_equal(pc["len"].numpy(), np.asarray(jc["len"])[0])
    for _ in range(2):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        _close(pl, jl)
    np.testing.assert_array_equal(pc["len"].numpy(), np.asarray(jc["len"])[0])


def _specs(vocab, seed=3):
    rng = np.random.default_rng(seed)
    lens_new = [(5, 6), (40, 8), (17, 0), (70, 9), (3, 5), (22, 7), (9, 4)]
    return [dict(tokens=rng.integers(2, vocab, size=n).astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(lens_new)]


@pytest.mark.parametrize("order,arch", [
    ("cyclic", "deepseek-7b"), ("sawtooth", "deepseek-7b"), ("block_snake", "deepseek-7b"),
    *[("sawtooth", arch) for arch in OTHER_DENSE + MOE],
], ids=["cyclic", "sawtooth", "block_snake", *OTHER_DENSE, *MOE])
def test_static_engine_greedy_streams_equal_reference(weights, order, arch):
    """Groups of 3 (the last one short); rid 2 asks for 0 tokens, rid 3's
    prompt is longer than max_len (its tail is kept and its limit clamped),
    rid 5 is cancelled before the run and rid 6's deadline has passed at
    the first boundary."""
    jlm, jparams, lm, params = _models(weights, arch, attn_order=order, snake_group=2)
    specs = _specs(lm.cfg.vocab)
    specs[6]["deadline_s"] = 0.0
    kw = dict(batch_size=3, max_len=64)
    ref = RefEngine(jlm, jparams, scheduler="static", **kw)
    eng = ServeEngine(lm, params, device="cpu", **kw)
    assert eng.scheduler == "static"
    ref.cancel(5)
    eng.cancel(5)
    want = ref.generate([RefRequest(**s) for s in specs])
    got = eng.generate([Request(**s) for s in specs])
    assert [r.status for r in got] == [r.status for r in want]
    assert [r.status for r in got][5:] == ["cancelled", "deadline"]
    for a, b in zip(want, got):
        assert b.rid == a.rid and b.steps == a.steps
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert got[2].steps == 0 and got[3].steps >= 1
    for name, labels in [("serve.step.tokens", {"kind": "prefill"}),
                         ("serve.step.tokens", {"kind": "decode"}),
                         ("serve.tokens.generated", {}), ("serve.cancelled", {}),
                         ("serve.deadline_miss", {})]:
        assert eng.obs.value(name, **labels) == ref.obs.value(name, **labels), (name, labels)
    spans = [ev.name for ev in eng.tracer.events()]
    assert spans.count("serve.prefill") == 3 and "serve.decode_step" in spans


def test_static_engine_sliding_window_equals_reference(weights):
    """A window config is unbounded on the static path: the ring buffer
    takes any prompt and any number of new tokens."""
    jlm, jparams, lm, params = _models(weights, window=32)
    specs = _specs(lm.cfg.vocab, seed=4)[:4]
    kw = dict(batch_size=2, max_len=48)
    want = RefEngine(jlm, jparams, scheduler="static", **kw).generate(
        [RefRequest(**s) for s in specs])
    got = ServeEngine(lm, params, device="cpu", **kw).generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert b.status == a.status == "ok" and b.steps == a.steps
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert got[3].steps == 9   # 70-token prompt, not clamped by max_len


def test_static_sampled_streams_are_deterministic_per_seed(weights):
    _, _, lm, params = _models(weights)
    specs = _specs(lm.cfg.vocab)[:4]

    def run(engine_seed, which):
        eng = ServeEngine(lm, params, device="cpu", batch_size=2, max_len=64, seed=engine_seed)
        reqs = [Request(**dict(specs[i], temperature=1.3, seed=100 + i)) for i in which]
        return {r.rid: r.tokens.tolist() for r in eng.generate(reqs)}

    a = run(0, range(4))
    assert a == run(0, range(4))
    assert run(1, range(4)) != a


def test_launcher_static_and_auto_on_cpu(capsys):
    launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                       "--scheduler", "static", "--requests", "3", "--batch-size", "2",
                       "--max-new", "4", "--max-len", "64"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    assert launch_serve.pick_scheduler("auto", get_config("deepseek-7b")) == "continuous"
    swa = get_config("deepseek-7b").with_(window=4096)
    assert launch_serve.pick_scheduler("auto", swa) == "static"
    assert "using static groups" in capsys.readouterr().out
