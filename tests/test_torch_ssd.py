"""The port's Mamba-2 SSD scan against the JAX package's, on the same inputs.

Inputs are drawn with numpy from a seed and given to both packages. The
port's plain chunked scan (``models.ssm.ssd_chunked``), its sequential
oracle (``kernels.ref.ssd_ref``), the wrapper of kernel B7 on the CPU
(``kernels.ssd.ssd_fwd``, which returns the plain version there) and
``ops.ssd`` are held to the reference's ``ssd_chunked``, ``ssd_ref`` and
Pallas ``ssd_fwd`` run in interpret mode, as ``tests/test_ssd_kernel.py``
runs it. Tolerances (float32), each relative to the output's scale (the
absolute limit is the tolerance times max(1, max |expected|), elementwise
also the tolerance times |expected|): 1e-5 between the two packages where
they run the same algorithm (sums of up to N * chunk products of values
near 30 in another order), 3e-4 against the sequential oracle (as the
reference's own tests), 2e-5 between the chunked scan and the Pallas kernel,
whose chunks differ for short sequences.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro.kernels.ssd import ssd_fwd as ref_ssd_fwd
from repro.models import ssm as ref_ssm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssd import ssd_fwd
from repro_torch.models.ssm import ssd_chunked

SAME = 1e-5      # port vs JAX, the same algorithm
ORACLE = 3e-4    # either vs the sequential oracle
KERNEL = 2e-5    # chunked scan vs the Pallas kernel


def _close(got, want, tol, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=err_msg)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, bsz, s, h, p, n, *, dt_scale=1.0, state=False):
    """numpy inputs of the SSD: x, dt (post-softplus), a (<= 0), b, c and an
    initial state (or None)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(bsz, s, h)))) * dt_scale).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    s0 = rng.normal(size=(bsz, h, p, n)).astype(np.float32) if state else None
    return x, dt, a, b, c, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# test_ssd_kernel.py's sweep (B, S, H, P, N, chunk), and chunks of test_ssd.py
SWEEP = [
    (2, 96, 3, 8, 16, 32),
    (1, 128, 2, 64, 128, 64),
    (2, 100, 4, 16, 32, 32),   # S not a chunk multiple
    (1, 64, 1, 8, 8, 64),      # a single chunk
    (2, 96, 3, 8, 16, 8),
    (2, 96, 3, 8, 16, 128),    # chunk > S
    (1, 1, 2, 8, 16, 32),      # one position
]


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("state", [False, True], ids=["zero", "init"])
def test_ssd_chunked_matches_reference(case, state):
    bsz, s, h, p, n, chunk = case
    x, dt, a, b, c, s0 = _inputs(sum(case), bsz, s, h, p, n, state=state)
    y, fin = ssd_chunked(*_t(x, dt, a, b, c), chunk=chunk, init_state=_t(s0)[0])
    jy, jfin = ref_ssm.ssd_chunked(*_j(x, dt, a, b, c), chunk=chunk, init_state=_j(s0)[0])
    _close(y, jy, SAME)
    _close(fin, jfin, SAME)
    oy, ofin = ssd_ref(*_t(x, dt, a, b, c), init_state=_t(s0)[0])
    _close(y, oy, ORACLE)
    _close(fin, ofin, ORACLE)


@pytest.mark.parametrize("case", SWEEP[:4], ids=lambda c: "x".join(map(str, c)))
def test_ssd_ref_matches_reference(case):
    bsz, s, h, p, n, _ = case
    x, dt, a, b, c, _ = _inputs(sum(case) + 1, bsz, s, h, p, n)
    y, fin = ssd_ref(*_t(x, dt, a, b, c))
    jy, jfin = ref_ssd_ref(*_j(x, dt, a, b, c))
    _close(y, jy, SAME)
    _close(fin, jfin, SAME)


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: "x".join(map(str, c)))
def test_ssd_fwd_matches_the_pallas_kernel(case):
    """The B7 wrapper on CPU tensors (the plain chunked scan) against the
    reference's Pallas kernel in interpret mode, and both against the
    oracle."""
    bsz, s, h, p, n, chunk = case
    x, dt, a, b, c, _ = _inputs(sum(case) + 2, bsz, s, h, p, n)
    y, fin = ssd_fwd(*_t(x, dt, a, b, c), chunk=chunk)
    jy, jfin = ref_ssd_fwd(*_j(x, dt, a, b, c), chunk=chunk, interpret=True)
    _close(y, jy, KERNEL)
    _close(fin, jfin, KERNEL)
    oy, ofin = ssd_ref(*_t(x, dt, a, b, c))
    _close(jy, oy, ORACLE)
    _close(jfin, ofin, ORACLE)


def test_ssd_state_chaining():
    """Two calls chained through the state equal one call (test_ssd_kernel.py
    :45), in both packages."""
    x, dt, a, b, c, _ = _inputs(0, 2, 128, 4, 16, 32)
    y, fin = ssd_fwd(*_t(x, dt, a, b, c), chunk=32)
    ys, st = [], None
    jys, jst = [], None
    for sl in (slice(0, 64), slice(64, 128)):
        args = (x[:, sl], dt[:, sl], a, b[:, sl], c[:, sl])
        yi, st = ssd_fwd(*_t(*args), chunk=32, init_state=st)
        jyi, jst = ref_ssd_fwd(*_j(*args), chunk=32, interpret=True, init_state=jst)
        ys.append(yi.numpy())
        jys.append(np.asarray(jyi))
    _close(np.concatenate(ys, 1), y, SAME)
    _close(st, fin, SAME)
    _close(np.concatenate(ys, 1), np.concatenate(jys, 1), KERNEL)
    _close(st, jst, KERNEL)
    oy, ofin = ssd_ref(*_t(x, dt, a, b, c))
    _close(np.concatenate(ys, 1), oy, ORACLE)
    _close(st, ofin, ORACLE)


def test_ssd_bf16_inputs():
    """bf16 x, b, c (test_ssd_kernel.py:59): y comes back in bf16; the two
    packages agree to one bf16 rounding (2^-8 relative, 1e-2 allowed), and
    both are within the reference test's 5e-2 of the float32 oracle."""
    x, dt, a, b, c, _ = _inputs(1, 1, 64, 2, 16, 16)
    tx, tb, tc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    jx, jb, jc = (jnp.asarray(v, jnp.bfloat16) for v in (x, b, c))
    y, fin = ssd_fwd(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, chunk=32)
    jy, jfin = ref_ssd_fwd(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=32, interpret=True)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), atol=1e-2, rtol=1e-2)
    _close(fin, jfin, KERNEL)
    oy, _ = ssd_ref(tx.float(), torch.from_numpy(dt), torch.from_numpy(a), tb.float(), tc.float())
    np.testing.assert_allclose(y.float().numpy(), oy.numpy(), atol=5e-2, rtol=5e-2)


def test_ssd_decay_stays_finite():
    """Aggressive steps (test_ssd.py's decay check): exp is taken of
    non-positive exponents only, so y and the state stay finite."""
    x, dt, a, b, c, _ = _inputs(2, 2, 64, 3, 8, 16, dt_scale=10.0)
    y, fin = ssd_chunked(*_t(x, dt, a, b, c), chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()


@pytest.mark.parametrize("impl", ["auto", "torch", "reference"])
def test_ops_ssd_impls(impl):
    """ops.ssd by impl against the reference's ops.ssd (impl xla); init_state
    None means zeros."""
    x, dt, a, b, c, s0 = _inputs(3, 2, 80, 3, 8, 16, state=True)
    tol = ORACLE if impl == "reference" else SAME
    y, fin = ops.ssd(*_t(x, dt, a, b, c), chunk=32, impl=impl)
    jy, jfin = ref_ops.ssd(*_j(x, dt, a, b, c), chunk=32, impl="xla")
    _close(y, jy, tol)
    _close(fin, jfin, tol)
    y, fin = ops.ssd(*_t(x, dt, a, b, c), chunk=32, impl=impl, init_state=torch.from_numpy(s0))
    jy, jfin = ref_ops.ssd(*_j(x, dt, a, b, c), chunk=32, impl="xla", init_state=jnp.asarray(s0))
    _close(y, jy, tol)
    _close(fin, jfin, tol)


def test_ops_ssd_rejects_other_impls():
    x, dt, a, b, c, _ = _t(*_inputs(4, 1, 8, 1, 8, 8))
    for impl in ("pallas", "pallas_interpret", "xla", "jnp"):
        with pytest.raises(ValueError, match="JAX package"):
            ops.ssd(x, dt, a, b, c, impl=impl)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.ssd(x, dt, a, b, c, impl="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_fwd(*(t.to("meta") for t in (x, dt, a, b, c)))


@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("impl", ["torch", "reference"])
def test_ops_ssd_grads_match_reference(impl, state):
    """Gradients of (y**2).sum() + (state**2).sum() through ops.ssd against
    the reference's custom_vjp (test_ssd_kernel.py:69), for every input
    including dt, a and the initial state, or with no initial state (zeros,
    passed on as None): both backwards re-run the chunked scan on the saved
    inputs, whatever the forward."""
    x, dt, a, b, c, s0 = _inputs(5, 1, 64, 2, 8, 16, state=True)
    n_in = 6 if state else 5

    def jloss(*args):
        init = args[5] if state else None
        y, s = ref_ops.ssd(*args[:5], chunk=32, impl="xla", init_state=init)
        return (y ** 2).sum() + (s ** 2).sum()

    jgrads = jax.grad(jloss, argnums=tuple(range(n_in)))(*_j(x, dt, a, b, c, s0)[:n_in])
    leaves = [t.requires_grad_(True) for t in _t(x, dt, a, b, c, s0)[:n_in]]
    y, s = ops.ssd(*leaves[:5], chunk=32, impl=impl, init_state=leaves[5] if state else None)
    ((y ** 2).sum() + (s ** 2).sum()).backward()
    for name, t, jg in zip(("x", "dt", "a", "b", "c", "init_state"), leaves, jgrads):
        _close(t.grad, jg, SAME, err_msg=name)
