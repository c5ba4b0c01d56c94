"""The port's transposed traversal and fused flash backward against the JAX
package.

* The transposed half of ``Traversal`` (the dK/dV grid: ``q_bounds``,
  ``stream_block_index`` on ints and tensors, ``q_order``,
  ``stream_sweep``, ``stream_grid_steps``, ``worker_assignments`` and
  ``wavefront`` on both grids) equals the reference's exactly, for every
  order x snake_group x causal/SWA x GQA groups, degenerate trims included.
* The plain fused backward ``core.attention.flash_attention_bwd`` equals the
  reference's blockwise backward on a sweep of shapes per order (GQA, MQA,
  SWA, lengths that are not a multiple of the tile, Sq != Skv), from the
  same ``(o, lse)``; the wrapper ``kernels.flash_attention_bwd`` on CPU
  tensors (the plain version at its one tiling, 64 x 64) equals the
  reference's Pallas backward kernels in interpret mode on a few cases.
* ``ops.attention``'s gradients for the port's impls equal ``jax.grad``
  through the reference's ``ops.attention`` (``recompute`` against the
  reference's ``jnp``, which differentiates the same blockwise forward).
* Head dim 80 (zamba2's shared attention) in both sweeps; the CUDA
  backward's operand check takes 64, 80, 96 and 128 and refuses 112.

Inputs come from numpy. Tolerance: f32, atol = rtol = 1e-4, the reference's
own bar for its backward (the sums run in other orders).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.core import attention as ref_attn
from repro.core import schedule as ref_sched
from repro.kernels import flash_attention as ref_kflash
from repro.kernels import ops as ref_ops
from repro_torch.core import attention as port_attn
from repro_torch.core import schedule as port_sched
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels.flash_attention import dkv_walks, flash_attention_bwd, kernel_traversal

TOL = dict(atol=1e-4, rtol=1e-4)
ORDERS = ["cyclic", "sawtooth", "block_snake"]
SNAKE_GROUPS = [None, 1, 2, 3, 5]
# (n_q, n_kv): square, tall, wide (KV tiles nobody sees when causal), one tile.
GRIDS = [(1, 1), (4, 4), (7, 3), (3, 6)]
BLOCKS = [(64, 64), (128, 64), (32, 96)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(order, n_q, n_kv, causal, window, qb, kb, g, sg):
    kw = dict(order=order, n_q=n_q, n_kv=n_kv, causal=causal, window=window, q_block=qb,
              kv_block=kb, n_groups=g, snake_group=sg)
    return ref_sched.Traversal(**kw), port_sched.Traversal(**kw)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 40),
                                           (False, 70), (True, 1)])
@pytest.mark.parametrize("qb,kb", BLOCKS)
def test_transposed_traversal_equals_reference(order, causal, window, qb, kb):
    """Host iterators and the scalar/vectorized stream_block_index, exactly."""
    for n_q, n_kv in GRIDS:
        for g in (1, 3):
            for sg in SNAKE_GROUPS:
                ref, port = _pair(order, n_q, n_kv, causal, window, qb, kb, g, sg)
                for j in range(n_kv):
                    assert port.q_bounds_host(j) == ref.q_bounds_host(j)
                    assert port.q_order(j) == ref.q_order(j)
                    assert port.q_order(j, local_iter=j + 1) == ref.q_order(j, local_iter=j + 1)
                    assert port.stream_sweep(j) == ref.stream_sweep(j)
                    assert port.stream_sweep(j, local_iter=3) == ref.stream_sweep(j, local_iter=3)
                want = list(ref.stream_grid_steps())
                assert list(port.stream_grid_steps()) == want
                assert [(j, *port.stream_block_index(j, u)) for j, u in
                        ((j, u) for j in range(n_kv) for u in range(port.grid_rows))] == want
                jj, uu = np.meshgrid(np.arange(n_kv), np.arange(port.grid_rows), indexing="ij")
                jj, uu = jj.astype(np.int32), uu.astype(np.int32)
                r = ref.stream_block_index(jnp.asarray(jj), jnp.asarray(uu))
                p = port.stream_block_index(torch.from_numpy(jj), torch.from_numpy(uu))
                for a, b in zip(p, r):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                r_lo, r_hi = ref.q_bounds(jnp.asarray(jj[:, 0]))
                p_lo, p_hi = port.q_bounds(torch.from_numpy(jj[:, 0]))
                np.testing.assert_array_equal(p_lo.numpy(), np.asarray(r_lo))
                np.testing.assert_array_equal(p_hi.numpy(), np.asarray(r_hi))
                for workers in (1, 3):
                    for transposed in (False, True):
                        assert (port.worker_assignments(workers, transposed=transposed)
                                == ref.worker_assignments(workers, transposed=transposed))
                        assert (list(port.wavefront(workers, transposed=transposed))
                                == list(ref.wavefront(workers, transposed=transposed)))


def test_degenerate_transposed_trims_are_covered():
    """Causal with Skv > Sq leaves the last KV tiles unseen: one
    always-invalid step in both packages, an empty sweep, and a -1 row in
    the kernels' recorded walk."""
    ref, port = _pair("sawtooth", 2, 5, True, None, 64, 64, 2, None)
    lo, hi = port.q_bounds_host(4)
    assert hi < lo and port.stream_sweep(4) == [] == ref.stream_sweep(4)
    assert port.stream_block_index(4, 0) == (0, 1, False)
    tr = kernel_traversal(100, 300, 2, order="sawtooth", causal=True, window=None,
                          kernel="flash_bwd_dkv")
    walks = dkv_walks(tr, 2, 1)  # two slices on one CTA
    assert all(w[j] == [-1] * tr.grid_rows for w in walks for j in (1, 2))
    assert walks[0][0] == [0, 1, 2, 3]  # the CTA's item 0: groups 0, 1 of Q tiles 0, 1
    assert walks[1][0] == [3, 2, 1, 0]  # its item 3: parity 1 reverses the sweep as a unit
    with pytest.raises(ValueError):
        port.worker_assignments(0)


# b, sq, skv, hq, hkv, d, causal, window, qb, kb
SWEEP = [
    (1, 64, 64, 2, 2, 16, False, None, 32, 32),
    (2, 96, 96, 4, 2, 16, True, None, 32, 32),       # GQA
    (1, 128, 128, 4, 1, 16, True, 40, 32, 32),       # MQA + SWA
    (1, 100, 100, 2, 2, 16, True, None, 32, 32),     # non-multiple seq
    (1, 70, 130, 2, 2, 16, False, 50, 32, 64),       # Sq < Skv, window, rectangular
    (1, 130, 70, 2, 2, 16, True, None, 64, 32),      # Sq > Skv
    (2, 96, 96, 4, 2, 80, True, None, 32, 32),       # zamba2's head dim, GQA
    (1, 100, 70, 2, 2, 80, False, 40, 32, 64),       # head dim 80, window, Sq > Skv
]


def _inputs(case, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d)))


def _okw(order):
    return {"snake_group": 2} if order == "block_snake" else {}


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("order", ORDERS)
def test_plain_bwd_equals_reference(case, order):
    """dq, dk, dv of the blockwise backward from the reference's own (o,
    lse), at the same tiles and order."""
    _, _, _, _, _, _, causal, window, qb, kb = case
    q, k, v, do = _inputs(case)
    kw = dict(order=order, causal=causal, window=window, q_block=qb, kv_block=kb, **_okw(order))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = ref_attn.flash_attention(jq, jk, jv, return_lse=True, **kw)
    want = ref_attn.flash_attention_bwd(jq, jk, jv, o, lse, jdo, **kw)
    got = port_attn.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, np.array(o), np.array(lse), do)), **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    delta = port_attn.attention_delta(torch.from_numpy(np.asarray(o)), torch.from_numpy(do))
    np.testing.assert_allclose(delta.numpy(), (np.asarray(o) * do).sum(-1), **TOL)


INTERPRET = [
    (1, 128, 128, 4, 2, 32, True, None, 64, 64),
    (1, 100, 100, 2, 2, 32, True, 40, 64, 64),
    (1, 64, 128, 2, 1, 32, False, None, 64, 64),
    (1, 128, 128, 2, 2, 80, True, None, 64, 64),     # head dim 80: D padded to 128 there
    (1, 100, 100, 4, 2, 80, True, 40, 64, 64),
]


@pytest.mark.parametrize("case,order",
                         [(c, ORDERS[i % len(ORDERS)]) for i, c in enumerate(INTERPRET)])
def test_wrapper_on_cpu_equals_reference_kernels(case, order):
    """The backward wrapper's CPU path (the plain version at its one
    tiling, BLOCK_M x BLOCK_N = 64 x 64) against the Pallas backward kernels
    in interpret mode; no kernel launch on the CPU."""
    _, _, _, _, _, _, causal, window, qb, kb = case
    q, k, v, do = _inputs(case, seed=1)
    kw = dict(order=order, causal=causal, window=window, **_okw(order))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = ref_kflash.flash_attention_fwd(jq, jk, jv, q_block=qb, kv_block=kb,
                                            interpret=True, return_lse=True, **kw)
    want = ref_kflash.flash_attention_bwd(jq, jk, jv, o, lse, jdo, q_block=qb, kv_block=kb,
                                          interpret=True, **kw)
    before = dict(cuda_lib.launch_counts)
    got = flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, np.array(o), np.array(lse), do)), **kw)
    assert cuda_lib.launch_counts == before
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    with pytest.raises(ValueError, match="CUDA kernels' walks"):
        flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, np.array(o),
                                                            np.array(lse), do)),
                            visit_dq_out=torch.zeros(1, dtype=torch.int32), **kw)


@pytest.mark.parametrize("impl", ["auto", "torch", "reference", "recompute"])
@pytest.mark.parametrize("window", [None, 20])
def test_ops_attention_grads_equal_reference(window, impl):
    """Gradients of a weighted sum of ops.attention for each of the port's
    impls on the CPU against jax.grad of the reference's ops.attention: impl
    auto (the fused blockwise backward on the CPU), and for ``recompute``
    impl jnp (the blockwise forward differentiated again); the outputs
    too."""
    case = (2, 50, 50, 4, 2, 16)
    q, k, v, w = _inputs(case + (True, window, 16, 16), seed=5)
    kw = dict(order="sawtooth", causal=True, window=window, q_block=16, kv_block=16,
              bwd_q_block=32, bwd_kv_block=16)
    ref_impl = "jnp" if impl == "recompute" else "auto"

    def jloss(q_, k_, v_):
        return jnp.sum(ref_ops.attention(q_, k_, v_, impl=ref_impl, **kw) * jnp.asarray(w))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    before = dict(cuda_lib.launch_counts)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.attention(tq, tk, tv, impl=impl, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    assert cuda_lib.launch_counts == before
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref_ops.attention(jq, jk, jv, impl=ref_impl, **kw)),
                               err_msg=f"{impl} out", **TOL)
    for g, ww, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), err_msg=f"{impl} {name}", **TOL)


def test_recompute_impl_saves_only_its_inputs():
    """impl recompute keeps q, k and v for the backward and nothing else
    (impl torch also keeps o and lse); the JAX names stay refused."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    kw = dict(causal=True, q_block=16, kv_block=16)
    saved = {}
    for impl in ("recompute", "torch"):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: shapes.append(t.shape) or t,
                                                      lambda t: t):
            ops.attention(q, k, v, impl=impl, **kw)
        saved[impl] = shapes
    assert saved["recompute"] == [q.shape, k.shape, v.shape]
    assert len(saved["torch"]) == 5
    with pytest.raises(ValueError, match="JAX package"):
        ops.attention(q, k, v, impl="jnp", **kw)


@pytest.mark.parametrize("d", [64, 80, 128, 96, 112])
def test_bwd_operand_check_takes_head_dims_64_80_128(d):
    """The CUDA backward's operand check (run before any launch) takes
    zamba2's head dim 80 and phi-3-vision's 96 beside 64 and 128, and
    refuses 112."""
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 4, d), dtype=bf)
    k = torch.zeros((1, 8, 2, d), dtype=bf)
    operands = (q, k, k, ("o", q), ("do", q))
    if d == 112:
        with pytest.raises(ValueError, match="head dim"):
            kflash._check_cuda_operands(*operands, kernel="flash_bwd")
    else:
        kflash._check_cuda_operands(*operands, kernel="flash_bwd")
