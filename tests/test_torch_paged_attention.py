"""Ragged paged attention of the port against the JAX package.

The port's plain version (the CPU path of ``paged_flash_decode_fwd`` and of
``ops.attention_decode``) is held to the reference's Pallas kernel, run in
interpret mode, and to its plain ``core.attention.paged_decode_attention``.
Inputs come from numpy and go to both packages. Tolerance: f32, atol = rtol
= 2e-5, since the two sum in other orders. Rows with nothing to attend to
must be exact zeros. The CUDA kernel itself is checked against the plain
version on the card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.core.attention import paged_decode_attention as ref_plain
from repro.kernels.flash_decode import paged_flash_decode_fwd as ref_kernel
from repro_torch.core.attention import decode_attention, paged_decode_attention
from repro_torch.core.schedule import Order, resolve_order_group
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_decode import fold_schedule, paged_flash_decode_fwd

TOL = dict(atol=2e-5, rtol=2e-5)
HKV, D, PAGE, NB = 2, 16, 8, 4
SNAKE = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(seed, *, g, c):
    """Four rows over a shuffled block table: a full chunk, a ragged chunk,
    a free slot (len 0) and a row with q_len 0 but a non-empty cache."""
    rng = np.random.default_rng(seed)
    b = 4
    n_pages = b * NB + 1
    kp = rng.normal(size=(n_pages, PAGE, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, PAGE, HKV, D)).astype(np.float32)
    q = rng.normal(size=(b, c, HKV * g, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[: b * NB].reshape(b, NB).astype(np.int32)
    lens = np.array([NB * PAGE - 3, 17, 0, NB * PAGE], np.int32)
    q_lens = np.array([c, max(c - 2, 1), 0, 0], np.int32)
    return q, kp, vp, bt, lens, q_lens


def _zero_rows(q_lens, lens, c):
    t = np.arange(c)[None, :]
    return (t >= q_lens[:, None]) | (lens[:, None] == 0)   # (B, C)


@pytest.mark.parametrize("window", [None, 11], ids=["full", "window"])
@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("order", [o.value for o in Order])
def test_plain_matches_reference_kernel_and_plain(order, g, c, window):
    q, kp, vp, bt, lens, q_lens = _problem(11 * g + c, g=g, c=c)
    group = resolve_order_group(order, SNAKE, NB)
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens), jnp.asarray(bt))
    want_kernel = np.asarray(
        ref_kernel(*jargs, q_lens=jnp.asarray(q_lens), window=window,
                   order_group=jnp.int32(group), interpret=True)
    )
    want_plain = np.asarray(
        ref_plain(*jargs, q_lens=jnp.asarray(q_lens), window=window, order_group=jnp.int32(group))
    )
    targs = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
             torch.from_numpy(lens), torch.from_numpy(bt))
    got = paged_flash_decode_fwd(*targs, q_lens=torch.from_numpy(q_lens), window=window,
                                 order_group=group)
    got_ops = ops.attention_decode(
        targs[0], targs[1], targs[2], targs[3], block_table=targs[4],
        q_lens=torch.from_numpy(q_lens), window=window, order_group=group,
    )
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_plain, **TOL)
    np.testing.assert_array_equal(got_ops.numpy(), got.numpy())
    zero = _zero_rows(q_lens, lens, c)
    assert np.all(got.numpy()[zero] == 0.0)
    assert np.all(want_kernel[zero] == 0.0)


@pytest.mark.parametrize("order", [o.value for o in Order])
def test_static_order_argument_matches_reference(order):
    """Without ``order_group`` the walk is chosen by ``order``/``snake_group``."""
    q, kp, vp, bt, lens, q_lens = _problem(5, g=2, c=3)
    want = np.asarray(ref_plain(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens), jnp.asarray(bt),
        q_lens=jnp.asarray(q_lens), order=order, snake_group=SNAKE,
    ))
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(bt), q_lens=torch.from_numpy(q_lens),
        order=order, snake_group=SNAKE,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fold_schedule_gathers_visit_order():
    """The kernel's operands: logical pages in each row's visit order (parity
    keyed on the row's length) and the physical pages along them."""
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, 13)).reshape(3, 4).astype(np.int32))
    lens = torch.tensor([6, 7, 0], dtype=torch.int32)
    phys, logical = fold_schedule(lens, bt, order_group=4)   # sawtooth over 4 pages
    assert logical.tolist() == [[0, 1, 2, 3], [3, 2, 1, 0], [0, 1, 2, 3]]
    assert phys.tolist() == torch.gather(bt, 1, logical.long()).tolist()
    assert phys.dtype == logical.dtype == torch.int32
    assert phys.is_contiguous() and logical.is_contiguous()


def test_wrapper_uses_plain_version_only_on_cpu():
    q, kp, vp, bt, lens, q_lens = _problem(1, g=1, c=1)
    before = dict(cuda_lib.launch_counts)
    paged_flash_decode_fwd(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.from_numpy(lens), torch.from_numpy(bt))
    assert cuda_lib.launch_counts == before   # no kernel launch on the CPU
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.attention_decode(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                             torch.from_numpy(lens), block_table=torch.from_numpy(bt),
                             impl="cuda")
    with pytest.raises(ValueError, match="unknown decode impl"):
        ops.attention_decode(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                             torch.from_numpy(lens), block_table=torch.from_numpy(bt),
                             impl="pallas")
    # Without a block table the caches are contiguous (B, S_max, Hkv, D):
    # the plain decode_attention, no launch either.
    kc, vc = torch.from_numpy(kp[:4]), torch.from_numpy(vp[:4])
    got = ops.attention_decode(torch.from_numpy(q), kc, vc, torch.from_numpy(lens % PAGE + 1))
    assert cuda_lib.launch_counts == before
    want = decode_attention(torch.from_numpy(q), kc, vc, torch.from_numpy(lens % PAGE + 1))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_build_is_lazy_and_keyed_on_source():
    """Importing the kernels loads nothing; the library name hashes the
    source and the flags, under the repository's build directory."""
    assert cuda_lib._loaded == {}
    path = cuda_lib.library_path("paged_decode")
    assert path.parent == cuda_lib.BUILD_DIR
    assert path.name.startswith("paged_decode-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
