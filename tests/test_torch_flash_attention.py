"""The port's forward traversal and flash attention against the JAX package.

* ``Traversal`` (the forward grid's tile order, causal/SWA trimming, GQA
  fold) equals the reference's exactly, for every order x snake_group x
  causal/SWA x GQA groups, degenerate trims included.
* The plain blockwise ``flash_attention`` (o and lse) equals the reference's
  ``core.attention.flash_attention`` on a sweep of shapes per order, and the
  reference's Pallas kernel (interpret mode) on a few small cases; the
  wrapper ``flash_attention_fwd`` on CPU tensors is the plain version at the
  kernel's tile sizes. Inputs come from numpy. Tolerance: f32, atol = rtol
  = 2e-5 (the two sum in other orders). lse is compared on rows that see at
  least one key (the reference gives other rows no defined value).
* ``ops.attention`` dispatches the port's impls, forward and backward (the
  backward's parity with the reference is in ``test_torch_flash_bwd.py``).

The CUDA kernel is held to the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.core import attention as ref_attn
from repro.core import schedule as ref_sched
from repro.kernels.flash_attention import flash_attention_fwd as ref_kernel
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro_torch.core import attention as port_attn
from repro_torch.core import schedule as port_sched
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_attention import (
    BLOCK_M,
    BLOCK_N,
    FWD_BLOCK_M,
    FWD_BLOCK_N,
    flash_attention_fwd,
)
from repro_torch.kernels.ref import flash_attention_ref

TOL = dict(atol=2e-5, rtol=2e-5)
ORDERS = ["cyclic", "sawtooth", "block_snake"]
SNAKE_GROUPS = [None, 1, 2, 3, 5]
# (n_q, n_kv): square, tall (degenerate SWA trims when not causal), wide, one tile.
GRIDS = [(1, 1), (4, 4), (7, 3), (3, 6)]
BLOCKS = [(64, 64), (128, 64), (32, 96), (128, 128)]


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
def test_traversal_equals_reference(order, causal, window, qb, kb):
    """Host iterators and the scalar/vectorized kv_block_index, exactly."""
    for n_q, n_kv in GRIDS:
        for g in (1, 3):
            for sg in SNAKE_GROUPS:
                ref, port = _pair(order, n_q, n_kv, causal, window, qb, kb, g, sg)
                assert port.grid_rows == ref.grid_rows
                for n in range(1, 9):
                    assert port.group_for(n) == ref.group_for(n)
                for t in range(n_q):
                    assert port.kv_bounds_host(t) == ref.kv_bounds_host(t)
                    assert port.kv_order(t) == ref.kv_order(t)
                for i in range(port.grid_rows):
                    assert port.kv_order(i % n_q, local_iter=i) == ref.kv_order(i % n_q, local_iter=i)
                want = list(ref.fwd_grid_steps())
                assert list(port.fwd_grid_steps()) == want
                assert [(i, *port.kv_block_index(i, j)) for i, j, _ in
                        ((i, j, 0) for i in range(port.grid_rows) for j in range(n_kv))] == want
                # Vectorized over the whole grid, against the reference's
                # traced arithmetic on the same arrays.
                ii, jj = np.meshgrid(np.arange(port.grid_rows), np.arange(n_kv), indexing="ij")
                ii, jj = ii.astype(np.int32), jj.astype(np.int32)
                r_kv, r_ok = ref.kv_block_index(jnp.asarray(ii), jnp.asarray(jj))
                p_kv, p_ok = port.kv_block_index(torch.from_numpy(ii), torch.from_numpy(jj))
                np.testing.assert_array_equal(p_kv.numpy(), np.asarray(r_kv))
                np.testing.assert_array_equal(p_ok.numpy(), np.asarray(r_ok))
                r_lo, r_hi = ref.kv_bounds(jnp.asarray(ii[:, 0]))
                p_lo, p_hi = port.kv_bounds(torch.from_numpy(ii[:, 0]))
                np.testing.assert_array_equal(p_lo.numpy(), np.asarray(r_lo))
                np.testing.assert_array_equal(p_hi.numpy(), np.asarray(r_hi))
                np.testing.assert_array_equal(
                    np.asarray(port.kv_step(torch.from_numpy(ii), torch.from_numpy(jj))),
                    np.asarray(ref.kv_step(jnp.asarray(ii), jnp.asarray(jj))),
                )


def test_degenerate_trims_are_covered():
    """SWA past the KV length empties a row's range: one always-invalid
    boundary step in both packages, and an empty kv_order."""
    ref, port = _pair("sawtooth", 7, 3, False, 70, 64, 64, 1, None)
    lo, hi = port.kv_bounds_host(6)
    assert hi < lo and port.kv_order(6) == [] == ref.kv_order(6)
    assert port.kv_block_index(6, 0) == (2, False)


@pytest.mark.parametrize("order", ORDERS)
def test_kv_index_and_trimming_equal_reference(order):
    for n in range(1, 12):
        for sg in SNAKE_GROUPS:
            for i in range(5):
                row = [port_sched.kv_index_host(order, i, j, n, snake_group=sg) for j in range(n)]
                assert row == [ref_sched.kv_index_host(order, i, j, n, snake_group=sg)
                               for j in range(n)]
                assert row == [port_sched.kv_index(order, i, j, n, snake_group=sg)
                               for j in range(n)]
                vec = port_sched.kv_index(order, torch.full((n,), i), torch.arange(n), n,
                                          snake_group=sg)
                assert torch.as_tensor(vec).expand(n).tolist() == row
    for t in range(8):
        for causal in (False, True):
            for qb, kb in BLOCKS:
                assert port_sched.num_kv_tiles_for(t, 9, causal=causal, q_block=qb, kv_block=kb) \
                    == ref_sched.num_kv_tiles_for(t, 9, causal=causal, q_block=qb, kv_block=kb)


SWEEP = [
    # b, sq, skv, hq, hkv, d, causal, window, qb, kb  (tests/test_kernels.py)
    (1, 128, 128, 2, 2, 64, False, None, 128, 128),
    (2, 256, 256, 4, 4, 64, True, None, 128, 128),
    (1, 256, 256, 8, 2, 64, True, None, 128, 128),        # GQA
    (1, 512, 512, 4, 1, 128, True, 192, 128, 128),        # MQA + SWA
    (2, 128, 384, 4, 4, 80, False, None, 128, 128),       # cross, odd head dim
    (1, 384, 384, 2, 2, 64, True, None, 256, 128),        # rectangular blocks
    (1, 200, 200, 2, 2, 64, True, None, 128, 128),        # non-multiple seq
]


def _qkv(case, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _okw(order):
    return {"snake_group": 2} if order == "block_snake" else {}


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("order", ORDERS)
def test_plain_flash_attention_equals_reference(case, order):
    """o and lse of the blockwise path, at the same tiles and order."""
    _, _, _, _, _, _, causal, window, qb, kb = case
    q, k, v = _qkv(case)
    kw = dict(order=order, causal=causal, window=window, q_block=qb, kv_block=kb, **_okw(order))
    want_o, want_lse = ref_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                return_lse=True, **kw)
    got_o, got_lse = port_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                               torch.from_numpy(v), return_lse=True, **kw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    # The oracle (no tiling) too.
    got_ref = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got_ref.numpy(), got_o.numpy(), atol=3e-5, rtol=3e-5)


INTERPRET = [
    (1, 128, 128, 2, 2, 64, False, None, 128, 128),
    (1, 200, 200, 4, 2, 64, True, 70, 128, 128),
]


@pytest.mark.parametrize("case", INTERPRET)
@pytest.mark.parametrize("order", ORDERS)
def test_wrapper_on_cpu_equals_reference_kernel(case, order):
    """The wrapper's CPU path (the plain version at the CUDA forward's 128 x
    128 tiles) against the Pallas kernel in interpret mode (its own tiles):
    o and lse agree up to rounding; no kernel launch on the CPU. The plain
    backward keeps its 64 x 64 tiles."""
    _, _, _, _, _, _, causal, window, qb, kb = case
    q, k, v = _qkv(case, seed=1)
    want_o, want_lse = ref_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), order=order,
                                  causal=causal, window=window, q_block=qb, kv_block=kb,
                                  interpret=True, return_lse=True, **_okw(order))
    before = dict(cuda_lib.launch_counts)
    got_o, got_lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), order=order, causal=causal,
                                         window=window, return_lse=True, **_okw(order))
    assert cuda_lib.launch_counts == before
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    np.testing.assert_allclose(
        got_o.numpy(),
        np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window)),
        atol=3e-5, rtol=3e-5,
    )
    assert (BLOCK_M, BLOCK_N) == (64, 64)
    assert (FWD_BLOCK_M, FWD_BLOCK_N) == (128, 128)


def test_mha_reference_equals_reference():
    case = (2, 40, 56, 6, 2, 16)
    q, k, v = _qkv(case, seed=3)
    for causal, window in ((False, None), (True, None), (True, 9), (False, 20)):
        want = ref_attn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window)
        got = port_attn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_attention_dispatch_and_no_backward():
    case = (1, 50, 50, 4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(case, seed=4))
    kw = dict(order="sawtooth", causal=True, window=20, q_block=16, kv_block=16)
    ref = flash_attention_ref(q, k, v, causal=True, window=20)
    for impl in ("auto", "torch", "reference"):
        np.testing.assert_allclose(ops.attention(q, k, v, impl=impl, **kw).numpy(), ref.numpy(),
                                   atol=3e-5, rtol=3e-5)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.attention(q, k, v, impl="cuda", **kw)
    for name in ("pallas", "pallas_interpret", "xla", "jnp"):
        with pytest.raises(ValueError, match="JAX package"):
            ops.attention(q, k, v, impl=name, **kw)
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.attention(q, k, v, impl="triton", **kw)
    # The backward exists now (the name is kept from before it did): each
    # impl's gradients match the oracle's autograd.
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32))
    want = None
    for impl in ("reference", "auto", "torch"):
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        (ops.attention(qg, kg, vg, impl=impl, **kw) * w).sum().backward()
        got = [t.grad.numpy() for t in (qg, kg, vg)]
        if want is None:
            want = got
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():  # serving saves no residuals
        assert not ops.attention(q.clone().requires_grad_(True), k, v, **kw).requires_grad


def test_kernel_registry_names_the_replaced_tpu_kernels():
    """Each CUDA kernel's ``replaces`` line is the Pallas kernel's def (the
    fused prologue's: the defs of the reference functions it fuses), and
    its library name hashes the shared header too."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for name, fns in (("paged_decode", ("_paged_decode_kernel",)), ("flash_fwd", ("_fwd_kernel",)),
                      ("contig_decode", ("_decode_kernel",)),
                      ("flash_bwd_delta", ("_delta_kernel",)), ("flash_bwd_dq", ("_dq_kernel",)),
                      ("flash_bwd_dkv", ("_dkv_kernel",)), ("ssd", ("_ssd_kernel",)),
                      ("rope_kv_write", ("rope", "_paged_write"))):
        spec = cuda_lib.KERNELS[name]
        places = spec.replaces.split()
        assert len(places) == len(fns), (name, spec.replaces)
        for place, fn in zip(places, fns):
            path, line = place.split(":")
            assert (root / path).read_text().splitlines()[int(line) - 1].startswith(f"def {fn}(")
        assert (cuda_lib.CSRC / spec.source).is_file()
        assert cuda_lib.library_path(name).name.startswith(f"{name}-")
    assert set(cuda_lib.KERNELS) == set(cuda_lib.launch_counts) and len(cuda_lib.KERNELS) == 8
    assert set(cuda_lib.ORDER_CODES) == {o.value for o in port_sched.Order}
