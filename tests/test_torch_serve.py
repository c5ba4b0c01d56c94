"""The port's continuous ServeEngine against the JAX package's.

Both engines serve deepseek-7b ``.reduced()`` (f32) with the same weights
(the reference's init, loaded by ``params_from_jax``) on the same requests:
mixed prompt lengths, a shared system prefix and one request that adopts a
partial page. Greedy streams must be equal token for token, and the
deterministic work counters (mixed and wide steps, adopted pages, CoW forks)
must be equal. Sampled streams cannot match ``jax.random``; the port's are
held to its own invariants: the same seeds give the same stream whatever the
neighbours, and draws follow ``softmax(logits / T)`` (a chi-square check).
The other dense configs (qwen2-72b, codeqwen1_5-7b, llama3-405b, paper-gb10)
and olmoe-1b-7b (MoE, dropless grouped products in every mixed step) are
cases of the stream test.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import sample_seed, sample_token
from repro_torch.testing import params_from_jax

KW = dict(batch_size=2, max_len=96, page_size=8, prefill_chunk=16)
# The other dense configs, held to the reference as cases of the stream test.
OTHER_DENSE = ["qwen2-72b", "codeqwen1_5-7b", "llama3-405b", "paper-gb10"]
# The MoE config the continuous engine serves (mixtral has a window).
MOE = ["olmoe-1b-7b"]
# Series of the port's own mechanisms, which the reference has not: the
# compact wide step's replays.
PORT_ONLY_SERIES = {"serve.wide_replays", "serve.moe.rows", "serve.moe.groups"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcfg = ref_get_config("deepseek-7b").reduced()
    jlm = ref_build_model(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jlm, jparams, lm, params


def _specs(vocab, n=6, new=6, seed=7):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(2, vocab, size=40).astype(np.int32)
    specs = []
    for i in range(n):
        if i == 3:
            toks = sysp[:30].copy()          # adopts a partial page, then forks
        else:
            toks = np.concatenate([sysp, rng.integers(2, vocab, size=3 + 5 * i).astype(np.int32)])
        specs.append(dict(tokens=toks, max_new_tokens=new, rid=i, arrival=i))
    return specs


@pytest.mark.parametrize("order,arch", [
    ("sawtooth", "deepseek-7b"), ("cyclic", "deepseek-7b"),
    *[("sawtooth", arch) for arch in OTHER_DENSE + MOE],
], ids=["sawtooth", "cyclic", *OTHER_DENSE, *MOE])
def test_greedy_streams_and_counters_equal_reference(models, order, arch):
    jlm, jparams, lm, params = models
    if arch != "deepseek-7b":
        jlm = ref_build_model(ref_get_config(arch).reduced())
        jparams = jlm.init(jax.random.PRNGKey(0))
        lm = build_model(get_config(arch).reduced(), device="cpu")
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
    jlm = ref_build_model(jlm.cfg.with_(attn_order=order))
    lm = build_model(lm.cfg.with_(attn_order=order), device="cpu")
    specs = _specs(lm.cfg.vocab)
    ref = RefEngine(jlm, jparams, scheduler="continuous", **KW)
    want = ref.generate([RefRequest(**s) for s in specs])
    eng = ServeEngine(lm, params, scheduler="continuous", device="cpu", **KW)
    got = eng.generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert b.rid == a.rid and b.status == a.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.steps == a.steps
    rs, ps = ref.last_stats, eng.last_stats
    for key in ("mixed_steps", "wide_steps", "pages_adopted", "prompt_tokens_adopted",
                "cow_forks"):
        assert getattr(ps, key) == getattr(rs, key), key
    assert ps.pages_adopted > 0 and ps.cow_forks > 0
    assert eng.compiled_step_count() == ref.compiled_step_count() <= 2
    eng.last_pool.check_invariants()
    # Same series names as the reference engine (the port records a subset,
    # beside the series of what only the port does).
    names = {m.name for m in eng.obs.series()}
    assert names - PORT_ONLY_SERIES <= {m.name for m in ref.obs.series()}
    for name, labels in [("serve.steps", {"width": "wide"}), ("serve.steps", {"width": "narrow"}),
                         ("serve.step.tokens", {"kind": "prefill"}),
                         ("serve.tokens.generated", {}), ("pool.cow_forks", {})]:
        assert eng.obs.value(name, **labels) == ref.obs.value(name, **labels), (name, labels)


def test_sampled_streams_are_deterministic_per_seed(models):
    _, _, lm, params = models
    specs = _specs(lm.cfg.vocab, n=4, new=8)

    def run(engine_seed, which):
        eng = ServeEngine(lm, params, scheduler="continuous", device="cpu", seed=engine_seed, **KW)
        reqs = [Request(**dict(specs[i], temperature=1.3, seed=100 + i)) for i in which]
        return {r.rid: r.tokens.tolist() for r in eng.generate(reqs)}

    a = run(0, range(4))
    assert a == run(0, range(4))
    alone = run(0, [2])                         # other slot, no neighbours
    assert alone[2] == a[2]
    assert run(1, range(4)) != a                # the engine seed matters


def test_sample_token_follows_softmax():
    """Chi-square of 4000 draws against softmax(logits / T): 7 degrees of
    freedom, fail above 24.32 (p = 0.001). The seeds are fixed, so the
    check is deterministic."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=8).astype(np.float32) * 2)
    temp = 0.7
    n = 4000
    counts = np.zeros(8)
    for i in range(n):
        counts[int(sample_token(logits, temp, sample_seed(0, 5, i)))] += 1
    p = torch.softmax(logits / temp, -1).numpy().astype(np.float64)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts, n * p)
    assert sample_seed(0, 5, 1) != sample_seed(0, 5, 2) != sample_seed(1, 5, 2)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "mesh_dim_names"),
    (dict(shards=2), "unexpected keyword argument 'shards'"),
])
def test_unported_engine_arguments_raise(models, kwargs, item):
    """Every argument of the reference's engine is ported (``mesh`` and
    ``pcfg`` since A14): what still raises is a mesh that is not a
    ``DeviceMesh`` and an argument the reference does not have either."""
    _, _, lm, params = models
    with pytest.raises((TypeError, AttributeError), match=item):
        ServeEngine(lm, params, device="cpu", **kwargs)


def test_mesh_and_pcfg_are_accepted(models):
    """``pcfg`` without a mesh changes nothing; ``mesh`` is served in
    ``tests/test_torch_dist.py`` on gloo meshes."""
    _, _, lm, params = models
    reqs = [Request(tokens=np.arange(2, 9, dtype=np.int32), max_new_tokens=3, rid=0)]
    a = ServeEngine(lm, params, device="cpu", batch_size=1, max_len=32,
                    pcfg=ParallelConfig(fsdp_axes=("data",), data_axes=("data",)))
    b = ServeEngine(lm, params, device="cpu", batch_size=1, max_len=32)
    assert a.mesh is None and a.params is params
    assert a.generate(reqs)[0].tokens.tolist() == b.generate(reqs)[0].tokens.tolist()


@pytest.mark.parametrize("kwargs,match", [
    (dict(drafter=object()), "scheduler='continuous'"),
    (dict(scheduler="continuous", draft_len=0), "draft_len"),
    (dict(scheduler="continuous", host_pages=4, spill_watermark=0.0), "spill_watermark"),
    (dict(scheduler="continuous", host_pages=4, spill_watermark=1.5), "spill_watermark"),
], ids=["drafter_static", "draft_len", "watermark_zero", "watermark_above_one"])
def test_tier_and_speculation_argument_checks(models, kwargs, match):
    """The reference's checks of the A10 and A11 arguments."""
    _, _, lm, params = models
    with pytest.raises(ValueError, match=match):
        ServeEngine(lm, params, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(adapt_order=True), dict(llc_every=4), dict(llc_capacity_bytes=2**20),
    dict(adapt_order=True, adapt_epoch=3, adapt_hysteresis=0.2, adapt_confirm=1,
         adapt_shared_threshold=0.5, autotune_cache="missing.jsonl"),
], ids=["adapt_order", "llc_every", "llc_capacity_bytes", "adapt_all"])
def test_order_adaptation_arguments_are_accepted(models, kwargs):
    """The A8 arguments build the controller and the sampler on the
    continuous path and leave the greedy streams as they were."""
    _, _, lm, params = models
    specs = _specs(lm.cfg.vocab, n=3, new=4)
    plain = ServeEngine(lm, params, scheduler="continuous", device="cpu", **KW)
    want = [r.tokens.tolist() for r in plain.generate([Request(**s) for s in specs])]
    eng = ServeEngine(lm, params, scheduler="continuous", device="cpu", **KW, **kwargs)
    assert eng.order_ctl.enabled == kwargs.get("adapt_order", False)
    assert eng.llc.capacity_bytes == kwargs.get("llc_capacity_bytes", 3 * 2**20)
    assert [r.tokens.tolist() for r in eng.generate([Request(**s) for s in specs])] == want
    assert eng.obs.find("serve.order_switches") is not None


def test_engine_argument_checks(models):
    _, _, lm, params = models
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServeEngine(lm, params, device="cpu", no_such_option=1)
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(lm, params, device="cpu", max_len=0)
    eng = ServeEngine(lm, params, device="cpu", **dict(KW, batch_size=1))
    res = eng.generate([Request(tokens=np.array([5, 6, 7], np.int32), max_new_tokens=0, rid=9)])
    assert res[0].status == "ok" and res[0].steps == 0


def test_queue_shedding_cancel_and_deadline_match_reference(models):
    """Step-boundary lifecycle of the continuous path: a bounded queue sheds
    the newest arrivals, a cancelled rid retires, an expired deadline
    retires; statuses and the surviving greedy streams equal the
    reference's."""
    jlm, jparams, lm, params = models
    specs = _specs(lm.cfg.vocab, n=6, new=5)
    for s in specs:
        s["arrival"] = 0
    specs[4]["deadline_s"] = 0.0          # expired at the first boundary
    kw = dict(KW, max_queue=1, admit_watermark=0.9)
    ref = RefEngine(jlm, jparams, scheduler="continuous", **kw)
    eng = ServeEngine(lm, params, scheduler="continuous", device="cpu", **kw)
    ref.cancel(1)
    eng.cancel(1)
    want = ref.generate([RefRequest(**s) for s in specs])
    got = eng.generate([Request(**s) for s in specs])
    assert [r.status for r in got] == [r.status for r in want]
    assert {r.status for r in got} >= {"ok", "cancelled", "shed"}
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    for key in ("shed", "cancelled", "deadline_miss"):
        assert getattr(eng.last_stats, key) == getattr(ref.last_stats, key), key
