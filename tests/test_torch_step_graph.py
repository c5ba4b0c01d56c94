"""The serve engine's captured steps (``repro_torch.serve.step_graph``).

On the CPU every step runs eagerly over the same static buffers the card
replays, so these tests hold the step functions to what a capture needs:

* no host read inside a step: one step of each captured kind (the
  continuous mixed step at width 1 and at the chunk width; the static
  decode step of the dense, MoE, SSM, hybrid, enc-dec and VLM families, and both mixed
  widths after a traversal-order switch and for the MoE family) runs under
  a dispatch mode that fails on ``aten._local_scalar_dense`` (any
  ``.item()``, ``int(t)`` or ``bool(t)``) and on the ops that size their
  output from tensor values (``nonzero``, ``bincount``, ``unique``,
  boolean-mask indexing, ``repeat_interleave`` with tensor repeats), each
  of which waits for the device on the card;
* buffers that outlive ``generate()``: two calls on one engine use the
  same step buffers, pool pages and decode caches (same ``data_ptr``), and
  ``compiled_step_count()`` stays at most 2 (continuous) and 1 (static);
* the second ``generate()`` call's greedy streams equal the reference
  engine's second call, token for token;
* multi-step static decode with the 0-d tensor ``len`` through the
  engine's step equals the reference's logits (f32, atol = rtol = 2e-4,
  the tolerance of ``test_torch_static_serve.py``).

The reduced configs (f32) with the reference's weights (``params_from_jax``)
are used where the reference is compared; JAX is imported only there, so
the GPU cases run on the card without it:

  python -m pytest -q --noconftest -m gpu tests/test_torch_step_graph.py

On the card, each captured step replayed once must equal the same step run
eagerly on the same inputs and state, to the bit (logits, greedy tokens and
every cache or page written), and a step that reads a host value must make
capture raise.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.step_graph import StepCaptureError, StepGraph

TOL = dict(atol=2e-4, rtol=2e-4)
CONT = dict(batch_size=2, max_len=96, page_size=8, prefill_chunk=16)
STATIC = dict(batch_size=3, max_len=64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# Ops whose output shape depends on tensor values: on the card each waits
# for the device to size its output, a host read the CPU's eager run does
# not show as ``_local_scalar_dense``.
_SIZED_BY_VALUES = {
    torch.ops.aten.nonzero.default, torch.ops.aten.bincount.default,
    torch.ops.aten.masked_select.default, torch.ops.aten._unique2.default,
    torch.ops.aten.unique_dim.default, torch.ops.aten.unique_consecutive.default,
    torch.ops.aten.repeat_interleave.Tensor,
}


class NoHostRead(TorchDispatchMode):
    """Fails on any read of a tensor's value by the host: ``.item()`` and
    its kin, an op whose output is sized by values (``nonzero``,
    ``bincount``, ``unique``, ``repeat_interleave`` with tensor repeats) and
    boolean-mask indexing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default or func in _SIZED_BY_VALUES:
            raise AssertionError(f"host read inside a captured step ({func})")
        if func is torch.ops.aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError("host read inside a captured step (boolean mask index)")
        return func(*args, **(kwargs or {}))


def _specs(vocab, n=5, seed=7):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(2, vocab, size=24).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate([sysp, rng.integers(2, vocab, size=3 + 7 * i).astype(np.int32)])
        out.append(dict(tokens=toks, max_new_tokens=4 + i, rid=i))
    return out


def _engine(arch, scheduler, device="cpu", cfg_kw=None, seed=0):
    cfg = get_config(arch).reduced().with_(**(cfg_kw or {}))
    lm = build_model(cfg, device=device)
    kw = CONT if scheduler == "continuous" else STATIC
    return ServeEngine(lm, lm.init(seed), scheduler=scheduler, device=device, **kw)


# ---- CPU: what a capture needs ----------------------------------------------------


def test_guard_catches_host_reads():
    """The dispatch-mode guard sees every form of host read a step could
    hide (the contiguous step read ``int(cache["len"])`` before)."""
    t = torch.tensor(3, dtype=torch.int32)
    v = torch.tensor([2, 0, 1])
    for read in (lambda: t.item(), lambda: int(t), lambda: bool(t), lambda: torch.full((2,), t),
                 lambda: torch.bincount(v, minlength=4), lambda: v.nonzero(),
                 lambda: v[v > 0], lambda: torch.unique(v), lambda: v.repeat_interleave(v)):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostRead():
                read()


@pytest.mark.parametrize("kind", ["mixed/1", "mixed/16", "deepseek-7b", "mamba2-130m",
                                  "zamba2-2_7b", "mixed/1 after a switch",
                                  "mixed/16 after a switch", "mixed/1 int8", "mixed/16 int8",
                                  "deepseek-7b int8", "zamba2-2_7b int8", "mixed/1 olmoe-1b-7b",
                                  "mixed/16 olmoe-1b-7b", "olmoe-1b-7b", "mixtral-8x7b",
                                  "olmoe-1b-7b capacity", "seamless-m4t-medium",
                                  "phi-3-vision-4_2b"])
def test_captured_steps_read_no_host_value(kind):
    """One step of each kind, on the inputs and state its engine left, runs
    under the guard; it is the function the card captures. After an order
    switch (forced at the third mixed step, sawtooth to cyclic) both widths
    have run with the new reversal group staged, and still read nothing.
    With int8 KV caches the steps quantize what they write and dequantize
    the caches they read, and still read nothing. The MoE steps route,
    sort and run the grouped products (olmoe's mixed steps, olmoe's and
    mixtral's static decode; the capacity path too, served with
    ``moe_serve_dropless`` off) and read nothing either, nor do the
    enc-dec's decode step (its cross K/V's length a device tensor) and the
    VLM's."""
    cfg_kw = {"kv_cache_dtype": "int8"} if kind.endswith("int8") else None
    if kind.endswith("capacity"):
        cfg_kw = {"moe_serve_dropless": False}
    if kind.startswith("mixed"):
        arch = kind.split()[-1] if kind.endswith("olmoe-1b-7b") else "deepseek-7b"
        eng = _engine(arch, "continuous", cfg_kw=cfg_kw)
    else:
        eng = _engine(kind.split()[0], "static", cfg_kw=cfg_kw)
    if kind.endswith("after a switch"):
        ctl = eng.order_ctl
        ctl.enabled = True
        ctl.maybe_adapt = lambda n, *a, **k: n == 3 and ctl.switch_to("cyclic") is None
    eng.generate([Request(**s) for s in _specs(eng.lm.cfg.vocab)])
    step = eng.step_graphs()["decode" if not kind.startswith("mixed") else kind.split()[0]]
    if kind.endswith("after a switch"):
        assert eng.order_ctl.switches == 1 and eng.compiled_step_count() == 2
        assert int(step.inputs["order_group"]) == 1  # cyclic, staged after the switch
    with NoHostRead():
        logits, greedy = step()
    assert torch.isfinite(logits).all() and greedy.dtype == torch.int32


@pytest.mark.parametrize("scheduler,arch", [("continuous", "deepseek-7b"),
                                            ("static", "deepseek-7b"),
                                            ("static", "mamba2-130m"),
                                            ("static", "zamba2-2_7b"),
                                            ("static", "seamless-m4t-medium"),
                                            ("static", "phi-3-vision-4_2b")])
def test_generate_twice_reuses_step_buffers(scheduler, arch):
    eng = _engine(arch, scheduler)
    specs = _specs(eng.lm.cfg.vocab)

    def pointers():
        return {name: [t.untyped_storage().data_ptr() for t in (*g.inputs.values(), *g.state)]
                for name, g in eng.step_graphs().items()}

    first = eng.generate([Request(**s) for s in specs])
    ptrs = pointers()
    count = eng.compiled_step_count()
    second = eng.generate([Request(**s) for s in specs])
    assert pointers() == ptrs
    assert eng.compiled_step_count() == count
    if scheduler == "continuous":
        assert sorted(ptrs) == ["mixed/1", "mixed/16"] and count == 2
        pages = [t.untyped_storage().data_ptr() for t in eng.last_pool.pages.values()]
        assert all(p in ptrs["mixed/1"] and p in ptrs["mixed/16"] for p in pages)
        eng.last_pool.check_invariants()
    else:
        assert list(ptrs) == ["decode"] and count == 1
    for a, b in zip(first, second):  # greedy: the same streams again
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.fixture(scope="module")
def reference():
    """(jax, the reference's build_model/get_config/engine/Request,
    params_from_jax), imported only by the tests that compare with it."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefEngine
    from repro_torch.testing import params_from_jax

    def models(arch, **kw):
        jlm = ref_build_model(ref_get_config(arch).reduced().with_(**kw))
        jparams = jlm.init(jax.random.PRNGKey(0))
        lm = build_model(get_config(arch).reduced().with_(**kw), device="cpu")
        return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))

    return models, RefEngine, RefRequest


@pytest.mark.parametrize("scheduler,arch", [("continuous", "deepseek-7b"),
                                            ("static", "deepseek-7b"),
                                            ("static", "mamba2-130m"),
                                            ("static", "zamba2-2_7b"),
                                            ("static", "seamless-m4t-medium"),
                                            ("static", "phi-3-vision-4_2b")])
def test_second_generate_equals_reference(reference, scheduler, arch):
    """A second ``generate()`` (reset pool, reused steps and caches; other
    prompts than the first) gives the reference engine's second call."""
    models, RefEngine, RefRequest = reference
    jlm, jparams, lm, params = models(arch)
    kw = CONT if scheduler == "continuous" else STATIC
    ref = RefEngine(jlm, jparams, scheduler=scheduler, **kw)
    eng = ServeEngine(lm, params, scheduler=scheduler, device="cpu", **kw)
    for seed in (7, 8):
        specs = _specs(lm.cfg.vocab, seed=seed)
        want = ref.generate([RefRequest(**s) for s in specs])
        got = eng.generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert b.status == a.status == "ok" and b.steps == a.steps
        np.testing.assert_array_equal(b.tokens, a.tokens)
    if scheduler == "continuous":
        for key in ("mixed_steps", "wide_steps", "pages_adopted", "cow_forks"):
            assert getattr(eng.last_stats, key) == getattr(ref.last_stats, key), key
        assert eng.compiled_step_count() == ref.compiled_step_count() <= 2
    else:
        assert eng.compiled_step_count() == 1


@pytest.mark.parametrize("kw", [dict(), dict(window=32)], ids=["full", "swa"])
def test_static_decode_step_with_tensor_len_equals_reference(reference, kw):
    """Prefill, then 6 decode steps through the engine's step (its own
    caches, the prefill copied in, ``len`` a 0-d int32 tensor advanced on
    the device) against the reference's ``decode_step`` (past the ring
    buffer's wrap with the window)."""
    import jax.numpy as jnp

    models, _, _ = reference
    jlm, jparams, lm, params = models("deepseek-7b", **kw)
    eng = ServeEngine(lm, params, device="cpu", batch_size=3, max_len=60)
    toks = np.random.default_rng(1).integers(2, lm.cfg.vocab, size=(3, 30)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 60)
    _, pc = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, 60)
    step = eng._decode_step(pc)
    caches = eng._decode_caches
    for t in range(6):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        step.stage(tokens=nxt)
        last, greedy = step()
        np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **TOL)
        np.testing.assert_array_equal(greedy.numpy(), np.asarray(jl)[:, -1].argmax(-1))
        assert caches["len"].dim() == 0 and caches["len"].dtype == torch.int32
        assert int(caches["len"]) == 31 + t == int(np.asarray(jc["len"])[0])
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[name].numpy(), np.asarray(jc[name]), **TOL)


def test_step_graph_stages_into_one_buffer():
    """Inputs are int32 views of one flat buffer; staging writes the named
    ones and leaves the rest; on the CPU a call runs the function."""
    seen = []

    def fn(a, b, g):
        seen.append((a.clone(), b.clone(), g.clone()))
        return (a * 2, b + g)

    step = StepGraph("test step", fn, {"a": (2, 3), "b": (4,), "g": ()}, device="cpu")
    assert {k: tuple(v.shape) for k, v in step.inputs.items()} == {"a": (2, 3), "b": (4,), "g": ()}
    step.stage(a=np.arange(6).reshape(2, 3), b=[1, 2, 3, 4], g=5)
    out = step()
    step.stage(g=7)
    out2 = step()
    np.testing.assert_array_equal(out[0].numpy(), 2 * np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(out2[1].numpy(), [8, 9, 10, 11])
    assert step.graph is None   # nothing is captured on the CPU
    assert len(seen) == 2


def test_step_graph_stages_groups():
    """Groups of inputs staged at once (one value broadcast to every group),
    each loaded into the inputs before its call; a later staging of fewer
    groups leaves the inputs to what is loaded."""
    seen = []
    step = StepGraph("test step", lambda a, g: seen.append((a.clone(), g.clone())) or (a + g,),
                     {"a": (2,), "g": ()}, device="cpu", groups=3)
    step.stage_groups(3, a=np.arange(6).reshape(3, 2), g=10)
    outs = []
    for k in (2, 0, 1):
        step.load(k)
        outs.append(step()[0].tolist())
    assert outs == [[14, 15], [10, 11], [12, 13]]
    step.stage_groups(1, a=[[7, 8]], g=[1])
    step.load(0)
    assert step()[0].tolist() == [8, 9] and len(seen) == 4


# ---- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the steps are captured as CUDA graphs there")
    return torch.device("cuda")


# Small bf16 models whose attention fits the decode kernels (head dim 64);
# the SSM prefill runs the plain scan (B7 takes the full-width shapes only).
CARD_KW = dict(dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
               head_dim=64, d_ff=512, vocab=1024, ssd_impl="torch")


@pytest.mark.gpu
@pytest.mark.parametrize("scheduler,arch,kv", [("continuous", "deepseek-7b", "bfloat16"),
                                               ("static", "deepseek-7b", "bfloat16"),
                                               ("static", "mamba2-130m", "bfloat16"),
                                               ("static", "zamba2-2_7b", "bfloat16"),
                                               ("continuous", "deepseek-7b", "int8"),
                                               ("static", "deepseek-7b", "int8"),
                                               ("continuous", "olmoe-1b-7b", "bfloat16"),
                                               ("static", "olmoe-1b-7b", "bfloat16"),
                                               ("static", "seamless-m4t-medium", "bfloat16"),
                                               ("static", "phi-3-vision-4_2b", "bfloat16")])
def test_replay_equals_eager_on_card(cuda, scheduler, arch, kv):
    from repro_torch.kernels import cuda_lib

    eng = _engine(arch, scheduler, device=cuda, cfg_kw=dict(CARD_KW, kv_cache_dtype=kv))
    specs = _specs(1024)
    res = eng.generate([Request(**s) for s in specs])   # captures the steps
    assert all(r.status == "ok" for r in res)
    graphs = eng.step_graphs()
    assert len(graphs) == (2 if scheduler == "continuous" else 1)
    assert all(g.graph is not None and g.replays > 0 for g in graphs.values())
    replays = {name: g.replays for name, g in graphs.items()}
    cuda_lib.reset_launch_counts()
    again = eng.generate([Request(**s) for s in specs])  # replays only
    assert [r.tokens.tolist() for r in again] == [r.tokens.tolist() for r in res]
    assert eng.step_graphs() == graphs and eng.compiled_step_count() == len(graphs)
    if arch != "mamba2-130m":   # a replay counts the launches its capture issued
        key = "paged_decode" if scheduler == "continuous" else "contig_decode"
        n = eng.lm.cfg.n_layers   # zamba2: a site every 2 layers; enc-dec: self and cross
        sites = {"zamba2-2_7b": n // 2, "seamless-m4t-medium": 2 * n}.get(arch, n)
        assert {g.launches[key] for g in graphs.values()} == {sites}
        ran = sum(g.launches[key] * (g.replays - replays[name]) for name, g in graphs.items())
        assert cuda_lib.launch_counts[key] == ran > 0
    if arch == "olmoe-1b-7b":   # three grouped products a layer, in every graph and prefill
        per_pass = 3 * eng.lm.cfg.n_layers
        assert {g.launches["ragged_dot"] for g in graphs.values()} == {per_pass}
        ran = sum(per_pass * (g.replays - replays[name]) for name, g in graphs.items())
        prefills = 0 if scheduler == "continuous" else -(-len(specs) // STATIC["batch_size"])
        assert cuda_lib.library_counts["ragged_dot"] == ran + per_pass * prefills and ran > 0
    for name, g in graphs.items():
        diffs = g.replay_against_eager()
        assert all(d["equal"] for d in diffs.values()), (name, diffs)


@pytest.mark.gpu
def test_capture_of_a_host_read_raises(cuda):
    x = torch.arange(4, dtype=torch.float32, device=cuda)

    def unsafe(n):
        return (x * int(n.sum().item()),)

    step = StepGraph("unsafe step", unsafe, {"n": (2,)}, device=cuda)
    with pytest.raises(StepCaptureError, match="capture of the unsafe step"):
        step.capture()
    assert step.graph is None
    assert float((x + 1).sum()) == 10.0   # the card still works
