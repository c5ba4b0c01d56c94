"""Single-token decode over a contiguous cache: the port against the JAX
package.

The port's plain version (``core.attention.decode_attention``, the CPU path
of ``flash_decode_fwd`` and of ``ops.attention_decode`` without a block
table) is held to the reference's Pallas ``_decode_kernel`` in interpret
mode and to its plain ``decode_attention``, with windows and ragged
per-row lengths. Inputs come from numpy. Tolerance: f32, atol = rtol =
2e-5. A row of length 0 has no defined output in the plain versions (the
kernels give zeros), so the kernel comparison covers rows of positive
length. The CUDA kernel is checked on the card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.core.attention import decode_attention as ref_plain
from repro.kernels.flash_decode import flash_decode_fwd as ref_kernel
from repro_torch.core.attention import decode_attention
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_decode import decode_chunk, flash_decode_fwd
from repro_torch.kernels.ref import decode_attention_ref

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(seed, *, b=4, s_max=300, hkv=2, g=1, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("order", ["cyclic", "sawtooth", "block_snake"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("g", [1, 4])
def test_plain_decode_equals_reference_kernel_and_plain(order, window, g):
    """Ragged lens with a 0 and S_max (300) not a multiple of the chunk."""
    q, k, v = _problem(g * 3 + (window or 0), g=g)
    lens = np.array([300, 0, 129, 7], np.int32)
    want_k = np.asarray(ref_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(lens), order=order, window=window, chunk=128,
                                   interpret=True,
                                   **({"snake_group": 2} if order == "block_snake" else {})))
    want_p = np.asarray(ref_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lens), window=window))
    before = dict(cuda_lib.launch_counts)
    got = flash_decode_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(lens), order=order, window=window, chunk=128,
                           snake_group=2).numpy()
    assert cuda_lib.launch_counts == before   # no kernel launch on the CPU
    ok = lens > 0
    np.testing.assert_allclose(got[ok], want_k[ok], **TOL)
    np.testing.assert_allclose(got, want_p, **TOL)
    np.testing.assert_array_equal(want_k[~ok], 0.0)


@pytest.mark.parametrize("cache_len", [1, 64, 200])
def test_scalar_length_and_the_dispatch(cache_len):
    q, k, v = _problem(7, b=2, s_max=200, g=2)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cache_len)
    want = np.asarray(ref_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cache_len,
                                window=50))
    for impl in ("auto", "torch", "reference"):
        got = ops.attention_decode(*args, window=50, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(decode_attention_ref(*args, window=50).numpy(), want, **TOL)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.attention_decode(*args, impl="cuda")
    with pytest.raises(ValueError, match="paged layout"):
        decode_attention(*args, q_lens=torch.ones(2, dtype=torch.int32))


def test_chunk_is_derived_as_the_reference_derives_it():
    for s_max in (1, 7, 128, 129, 300, 511, 512, 513, 1024, 5000):
        for chunk in (64, 128, 512, 1000):
            want = min(chunk, max(128, 1 << (s_max - 1).bit_length()))
            assert decode_chunk(chunk, s_max) == want
