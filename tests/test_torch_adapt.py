"""The port's online order adaptation (``repro_torch.serve.adapt``,
``repro_torch.obs.autotune``) against the JAX package's.

* The reference's cases of ``tests/test_adapt.py`` run through both
  packages: the dynamic reversal group against the static schedule, the
  controller's hysteresis, confirmation, resets, shared-model blend, epoch
  gating and metrics, and the autotune cache (keys, load with
  last-writer-wins and unknown schemas, nearest-bucket lookup, seeding)
  from a JSONL this test writes.
* The two controllers fed the same readings decide the same switches.
* Engine: a forced mid-stream switch at the reduced float32 deepseek-7b
  gives streams equal to both pinned orders and to the reference's, and
  adds no step (``compiled_step_count() == 2``: the engine's two step
  graphs, the switch only staging a new reversal group into them); with
  adaptation on at a small modeled capacity the port switches where the
  reference does, on the same sampler history.
"""

import json

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.obs import Registry as RefRegistry
from repro.obs import autotune as ref_at
from repro.obs.export import append_jsonl as ref_append_jsonl
from repro.serve import OrderAdaptController as RefController
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.core.schedule import (
    DEFAULT_SNAKE_GROUP,
    KVSchedule,
    Order,
    page_visit_order_dynamic,
    resolve_order_group,
)
from repro_torch.models import build_model
from repro_torch.obs import Registry
from repro_torch.obs import autotune as port_at
from repro_torch.obs.export import append_jsonl
from repro_torch.serve import ORDER_INDEX, OrderAdaptController, Request, ServeEngine
from repro_torch.testing import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


PKGS = {"reference": (RefController, RefRegistry, ref_at),
        "port": (OrderAdaptController, Registry, port_at)}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---- the dynamic reversal group == the static schedule ---------------------------


@pytest.mark.parametrize("order,group", [
    ("cyclic", None), ("sawtooth", None), ("block_snake", 1), ("block_snake", 2),
    ("block_snake", 3), ("block_snake", 4), ("block_snake", 7),
])
@pytest.mark.parametrize("n_kv", [1, 2, 5, 8, 13])
def test_dynamic_visit_order_matches_static(order, group, n_kv):
    parity = torch.arange(2 * n_kv + 3, dtype=torch.int32)
    sched = KVSchedule(order, n_q=1, n_kv=n_kv, causal=False, q_block=1, kv_block=1,
                       snake_group=group)
    g = resolve_order_group(order, group, n_kv)
    assert torch.equal(sched.page_order(parity), page_visit_order_dynamic(parity, n_kv, g))


# ---- controller decision logic, both packages -------------------------------------


def _ctl(pkg, **kw):
    cls, reg, _ = pkg
    kw.setdefault("order", "cyclic")
    return cls(reg(), **kw)


def _name(order) -> str:
    return getattr(order, "value", order)


def test_consider_requires_sustained_improvement(pkg):
    ctl = _ctl(pkg, hysteresis=0.10, confirm=2)
    worse = {"cyclic": 100.0, "sawtooth": 95.0, "block_snake": 98.0}
    better = {"cyclic": 100.0, "sawtooth": 80.0, "block_snake": 98.0}
    assert not ctl.consider(worse)
    assert not ctl.consider(better)
    assert _name(ctl.order) == "cyclic"
    assert ctl.consider(better)
    assert _name(ctl.order) == "sawtooth" and ctl.switches == 1


def test_consider_resets_on_candidate_change_and_dropout(pkg):
    ctl = _ctl(pkg, hysteresis=0.05, confirm=2)
    saw = {"cyclic": 100.0, "sawtooth": 80.0, "block_snake": 99.0}
    snake = {"cyclic": 100.0, "sawtooth": 99.0, "block_snake": 80.0}
    tie = {"cyclic": 100.0, "sawtooth": 100.0, "block_snake": 100.0}
    assert not ctl.consider(saw)
    assert not ctl.consider(snake)
    assert not ctl.consider(tie)
    assert not ctl.consider(snake)
    assert ctl.consider(snake)
    assert _name(ctl.order) == "block_snake"


def test_blend_flips_decision_with_shared_fraction(pkg):
    ctl = _ctl(pkg, hysteresis=0.05, confirm=1, shared_threshold=0.25)
    fwd = {"cyclic": 100.0, "sawtooth": 98.0, "block_snake": 99.0}
    shared = {"cyclic": 100.0, "sawtooth": 200.0, "block_snake": 40.0}
    assert ctl.blend(fwd, shared, 0.1) == fwd
    assert not ctl.consider(fwd, shared_miss=shared, shared_frac=0.1)
    assert ctl.blend(fwd, shared, 0.5)["block_snake"] == pytest.approx(69.5)
    assert ctl.consider(fwd, shared_miss=shared, shared_frac=0.5)
    assert _name(ctl.order) == "block_snake"
    assert ctl.blend({"cyclic": 10.0, "sawtooth": 20.0}, {"cyclic": 30.0}, 1.0) == \
        {"cyclic": 30.0, "sawtooth": 20.0}


def test_consider_handles_empty_and_missing_current(pkg):
    ctl = _ctl(pkg, confirm=1)
    assert not ctl.consider(None)
    assert not ctl.consider({})
    assert not ctl.consider({"sawtooth": 1.0})
    assert ctl.switches == 0


def test_metrics_surface_and_switch_to(pkg):
    cls, reg_cls, _ = pkg
    reg = reg_cls()
    ctl = cls(reg, order="sawtooth", enabled=False)
    assert reg.value("serve.order_switches") == 0
    assert reg.value("serve.current_order") == 1
    ctl.switch_to("block_snake")
    assert reg.value("serve.order_switches") == 1
    assert reg.value("serve.current_order") == 2
    assert ctl.effective_snake_group == DEFAULT_SNAKE_GROUP
    assert ctl.effective_group(8) == min(DEFAULT_SNAKE_GROUP, 8)
    assert ctl.candidate_orders == ("cyclic", "sawtooth", "block_snake")


def test_order_index_is_the_reference_encoding():
    from repro.serve import ORDER_INDEX as REF_INDEX

    assert {o.value: i for o, i in ORDER_INDEX.items()} == \
        {o.value: i for o, i in REF_INDEX.items()} == {"cyclic": 0, "sawtooth": 1,
                                                       "block_snake": 2}


class _FakeSampler:
    def __init__(self, fwd_miss):
        self.fwd_miss = fwd_miss
        self.current_order = "cyclic"
        self.history = [{"current_order": "cyclic", "fwd_miss": fwd_miss}]
        self.calls = 0

    def sample(self, pool, step_q=None):
        self.calls += 1
        self.history.append({"current_order": self.current_order, "fwd_miss": self.fwd_miss})
        return True

    @property
    def last_fwd_miss(self):
        return self.history[-1]["fwd_miss"]


def test_maybe_adapt_epoch_gating_and_history_rewrite(pkg):
    ctl = _ctl(pkg, epoch=4, hysteresis=0.05, confirm=1)
    smp = _FakeSampler({"cyclic": 100.0, "sawtooth": 50.0, "block_snake": 99.0})
    assert not ctl.maybe_adapt(3, pool=None, sampler=smp)
    assert smp.calls == 0
    assert ctl.maybe_adapt(4, pool=None, sampler=smp)
    assert smp.calls == 1
    assert smp.history[-1]["current_order"] == "sawtooth" == smp.current_order
    disabled = _ctl(pkg, epoch=4, enabled=False)
    assert not disabled.maybe_adapt(4, pool=None, sampler=smp)
    assert smp.calls == 1


@pytest.mark.parametrize("confirm,hysteresis,threshold", [(1, 0.0, 0.25), (2, 0.05, 0.25),
                                                         (3, 0.2, 0.5)])
def test_controllers_decide_alike_on_the_same_readings(confirm, hysteresis, threshold):
    rng = np.random.default_rng(confirm)
    kw = dict(order="sawtooth", snake_group=3, confirm=confirm, hysteresis=hysteresis,
              shared_threshold=threshold)
    ref, port = RefController(RefRegistry(), **kw), OrderAdaptController(Registry(), **kw)
    for _ in range(300):
        fwd = {o: float(rng.integers(50, 120)) for o in ("cyclic", "sawtooth", "block_snake")}
        shared = ({o: float(rng.integers(0, 200)) for o in fwd} if rng.random() < 0.5
                  else None)
        frac = float(rng.random())
        assert port.consider(fwd, shared, frac) == ref.consider(fwd, shared, frac)
        assert (port.order.value, port.switches, port.effective_group(13)) == \
            (ref.order.value, ref.switches, ref.effective_group(13))
    assert port.switches > 0


# ---- the autotune cache, both packages ----------------------------------------------


def test_canonicalize_key_normalizes_and_sorts(pkg):
    at = pkg[2]
    key = at.canonicalize_key({"b": np.int64(3), "a": 1.0000004, "c": "CPU", "d": None})
    assert list(key) == ["a", "b", "c", "d"]
    assert key == {"a": 1.0, "b": 3, "c": "CPU", "d": None}
    assert isinstance(key["b"], int)
    with pytest.raises(TypeError):
        at.canonicalize_key({"flag": True})
    assert at.normalize_autotune_key("order_sweep", {"x": 1, "y": 2.0}) == \
        at.normalize_autotune_key("order_sweep", {"y": 2, "x": 1})
    assert port_at.normalize_autotune_key("k", {"z": 2.5, "a": "x"}) == \
        ref_at.normalize_autotune_key("k", {"z": 2.5, "a": "x"})


def _write_cache(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _rec(seq, order, *, snake_group=None, version=1, arch="deepseek-7b", capacity_mib=3.0,
         backend="cpu"):
    return {
        "schema_version": version,
        "kind": "order_sweep",
        "key": {"arch": arch, "seq_bucket": seq, "capacity_mib": capacity_mib,
                "n_workers": 12, "backend": backend},
        "winner": {"order": order, "snake_group": snake_group},
    }


def test_load_autotune_cache_missing_dedup_and_unknown_schema(pkg, tmp_path):
    at = pkg[2]
    assert at.load_autotune_cache(tmp_path / "nope.jsonl") == []
    p = tmp_path / "cache.jsonl"
    _write_cache(p, [_rec(8192, "sawtooth"), _rec(16384, "block_snake", snake_group=16),
                     _rec(8192, "cyclic")])
    entries = at.load_autotune_cache(p)
    assert {e["key"]["seq_bucket"]: e["winner"]["order"] for e in entries} == \
        {8192: "cyclic", 16384: "block_snake"}
    _write_cache(p, [_rec(8192, "cyclic"), _rec(4096, "sawtooth", version=99),
                     {"schema_version": 1, "kind": "order_sweep", "key": "unaddressable"}])
    with pytest.warns(UserWarning, match="schema_version"):
        entries = at.load_autotune_cache(p)
    assert [e["key"]["seq_bucket"] for e in entries] == [8192]


def test_lookup_order_winner_nearest_bucket(pkg, tmp_path):
    at = pkg[2]
    p = tmp_path / "cache.jsonl"
    _write_cache(p, [_rec(8192, "cyclic"), _rec(16384, "block_snake", snake_group=16),
                     _rec(8192, "sawtooth", arch="other-arch"),
                     _rec(8192, "block_snake", backend="gpu")])
    entries = at.load_autotune_cache(p)
    hit = at.lookup_order_winner(entries, arch="deepseek-7b", seq_bucket=256,
                                 capacity_mib=3.0, backend="cpu")
    assert hit["winner"]["order"] == "cyclic"
    hit = at.lookup_order_winner(entries, arch="deepseek-7b", seq_bucket=256,
                                 capacity_mib=3.0, backend="gpu")
    assert hit["winner"]["order"] == "block_snake"
    hit = at.lookup_order_winner(entries, arch="deepseek-7b", seq_bucket=20000,
                                 capacity_mib=3.0)
    assert hit["winner"]["order"] == "block_snake"
    assert at.lookup_order_winner(entries, arch="missing", seq_bucket=256,
                                  capacity_mib=3.0) is None


def test_seed_from_cache(pkg, tmp_path):
    p = tmp_path / "cache.jsonl"
    _write_cache(p, [_rec(16384, "block_snake", snake_group=16), _rec(8192, "cyclic")])
    ctl = _ctl(pkg, order="sawtooth", snake_group=4)
    assert ctl.seed_from_cache(p, arch="deepseek-7b", seq_bucket=16000, capacity_mib=3.0,
                               backend="cpu")
    assert _name(ctl.order) == "block_snake" and ctl.snake_group == 16
    assert ctl.seeded_from["key"]["seq_bucket"] == 16384
    ctl2 = _ctl(pkg, order="sawtooth")
    assert not ctl2.seed_from_cache(tmp_path / "nope.jsonl", arch="deepseek-7b",
                                    seq_bucket=256, capacity_mib=3.0)
    assert _name(ctl2.order) == "sawtooth" and ctl2.seeded_from is None


def test_one_jsonl_schema_for_both_packages(tmp_path):
    """A winner appended by either package is read back by the other."""
    p = str(tmp_path / "cache.jsonl")
    rec = {"key": _rec(1024, "cyclic")["key"], "winner": {"order": "cyclic",
                                                          "snake_group": None}}
    ref_append_jsonl(p, rec, kind="order_sweep")
    append_jsonl(p, {**rec, "key": {**rec["key"], "seq_bucket": 4096},
                     "winner": {"order": "block_snake", "snake_group": 4}}, kind="order_sweep")
    assert port_at.load_autotune_cache(p) == ref_at.load_autotune_cache(p)
    assert len(port_at.load_autotune_cache(p)) == 2


def test_engine_seeds_its_first_order_from_the_cache(tmp_path):
    p = tmp_path / "cache.jsonl"
    _write_cache(p, [_rec(96, "block_snake", snake_group=2)])
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    eng = ServeEngine(lm, lm.init(0), scheduler="continuous", device="cpu", batch_size=2,
                      max_len=96, page_size=8, adapt_order=True, autotune_cache=str(p))
    assert eng.order_ctl.order is Order.BLOCK_SNAKE and eng.order_ctl.snake_group == 2
    assert eng.llc.current_order == "block_snake"
    assert eng.obs.value("serve.current_order") == ORDER_INDEX[Order.BLOCK_SNAKE]


# ---- engine integration ----------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek():
    jcfg = ref_get_config("deepseek-7b").reduced()
    jlm = ref_build_model(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    cfg = get_config("deepseek-7b").reduced()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams))


def _requests(cls, vocab, n=3, max_new=10):
    rng = np.random.default_rng(11)
    return [cls(tokens=rng.integers(2, vocab, size=int(rng.integers(5, 14))).astype(np.int32),
                max_new_tokens=max_new, rid=i) for i in range(n)]


ENGINE = dict(batch_size=3, max_len=64, scheduler="continuous", page_size=8, prefill_chunk=16)


def _stream(cfg, params, order, *, force_switch_to=None, switch_at=4):
    eng = ServeEngine(build_model(cfg.with_(attn_order=order, snake_group=4), device="cpu"),
                      params, device="cpu", llc_every=0, **ENGINE)
    staged = []
    if force_switch_to is not None:
        ctl = eng.order_ctl
        ctl.enabled = True

        def forced(step_epoch, pool, sampler, step_q=None):
            if step_epoch == switch_at and ctl.switches == 0:
                ctl.switch_to(force_switch_to)
                return True
            return False

        ctl.maybe_adapt = forced
    run = eng._run_mixed

    def recording(step, tokens, pool, qlens, order_group, *rest):
        staged.append(int(order_group))
        return run(step, tokens, pool, qlens, order_group, *rest)

    eng._run_mixed = recording
    res = eng.generate(_requests(Request, cfg.vocab))
    return eng, [r.tokens.tolist() for r in res], staged


def _ref_stream(jcfg, jparams, order):
    ref = RefEngine(ref_build_model(jcfg.with_(attn_order=order, snake_group=4)), jparams,
                    llc_every=0, **ENGINE)
    return [r.tokens.tolist() for r in ref.generate(_requests(RefRequest, jcfg.vocab))]


def test_forced_switch_token_parity_and_no_recompile(deepseek):
    jcfg, jparams, cfg, params = deepseek
    _, tok_c, staged_c = _stream(cfg, params, "cyclic")
    _, tok_s, staged_s = _stream(cfg, params, "sawtooth")
    eng, tok_x, staged_x = _stream(cfg, params, "cyclic", force_switch_to="sawtooth")
    assert tok_c == tok_s == tok_x == _ref_stream(jcfg, jparams, "cyclic")
    assert eng.order_ctl.switches == 1 and eng.order_ctl.order is Order.SAWTOOTH
    # Both step graphs were made before the switch, and it added none: the
    # new order reached them as a staged reversal group (8 pages a row).
    assert eng.compiled_step_count() == 2
    assert sorted(eng.step_graphs()) == ["mixed/1", "mixed/16"]
    assert set(staged_c) == {1} and set(staged_s) == {8}
    assert staged_x == [1] * 4 + [8] * (len(staged_x) - 4)
    assert int(eng.step_graphs()["mixed/1"].inputs["order_group"]) == 8
    assert eng.obs.value("serve.order_switches") == 1
    assert eng.obs.value("serve.current_order") == ORDER_INDEX[Order.SAWTOOTH]


def test_block_snake_switch_token_parity(deepseek):
    jcfg, jparams, cfg, params = deepseek
    _, tok_b, _ = _stream(cfg, params, "block_snake")
    eng, tok_x, staged = _stream(cfg, params, "sawtooth", force_switch_to="block_snake",
                                 switch_at=2)
    assert tok_b == tok_x == _ref_stream(jcfg, jparams, "block_snake")
    assert staged == [8, 8] + [4] * (len(staged) - 2)
    assert eng.compiled_step_count() == 2


def test_adaptive_engine_switches_where_the_reference_does(deepseek):
    """Adaptation on at a modeled capacity small enough to switch: the same
    switches (step, order), sampler history and streams as the reference."""
    jcfg, jparams, cfg, params = deepseek
    kw = dict(adapt_order=True, adapt_epoch=2, adapt_confirm=1, llc_capacity_bytes=4_000.0,
              **ENGINE)

    def requests(cls):
        return [cls(tokens=np.random.default_rng(11 + i).integers(2, jcfg.vocab, size=20 + 9 * i)
                    .astype(np.int32), max_new_tokens=12, rid=i) for i in range(3)]

    ref = RefEngine(ref_build_model(jcfg), jparams, **kw)
    want = [r.tokens.tolist() for r in ref.generate(requests(RefRequest))]
    eng = ServeEngine(build_model(cfg, device="cpu"), params, device="cpu", **kw)
    got = [r.tokens.tolist() for r in eng.generate(requests(Request))]

    def switches(tracer):
        return [(e.args["step"], e.args["order"]) for e in tracer.events()
                if e.name == "serve.order_switch"]

    assert switches(eng.tracer) == switches(ref.tracer)
    assert eng.order_ctl.switches == ref.order_ctl.switches >= 1
    assert eng.llc.history == ref.llc.history
    assert got == want
    assert eng.compiled_step_count() == 2


# ---- the tie rule for a flip between two bf16 runs -------------------------------------


def _row(top, margin, vocab=64):
    row = torch.full((vocab,), -30.0, dtype=torch.bfloat16)
    row[5] = top
    row[17] = top - margin
    return row


@pytest.mark.parametrize("top,margins,ok", [
    (5.0, (0.03125, 0.0), True),        # the recorded flips: logits in [4, 8)
    (7.5, (0.0, 0.03125), True),
    (4.0, (0.0, 0.0), True),
    (5.0, (0.0625, 0.03125), False),    # two ulps in one run: not a tie
    (6.0, (0.09375, 0.0), False),
    (3.0, (0.03125, 0.0), False),       # [2, 4): half the ulp, the same margins fail
    (3.0, (0.015625, 0.0), True),
    (-5.0, (0.03125, 0.0), True),       # the magnitude sets the ulp
])
def test_tie_rule_on_synthetic_logits(top, margins, ok):
    from repro_torch.testing import bf16_ulp, top2_margin, within_tie_rule

    read = [top2_margin(_row(top, m)) for m in margins]
    assert [m for _, m in read] == list(margins)
    assert read[0][0] == top
    assert within_tie_rule([m for _, m in read], top) is ok
    assert bf16_ulp(top) == 2.0 ** (np.floor(np.log2(abs(top))) - 7)
    assert bf16_ulp(5.0) == 0.03125 and bf16_ulp(3.0) == 0.015625 and bf16_ulp(0.0) == 0.0
