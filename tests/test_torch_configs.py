"""The port's configs equal the JAX package's, field by field."""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_IDS, get_config


def test_arch_ids_equal():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_fields_equal(arch, reduced):
    ref, got = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.hd == ref.hd


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_dtypes_map_to_torch(name):
    cfg = get_config("deepseek-7b").with_(dtype=name, param_dtype=name)
    ref = ref_get_config("deepseek-7b").with_(dtype=name, param_dtype=name)
    want = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert cfg.activation_dtype() == want[ref.activation_dtype()]
    assert cfg.parameter_dtype() == want[ref.parameter_dtype()]


def test_with_and_unknown_arch():
    cfg = get_config("deepseek-7b")
    assert cfg.with_(page_size=64).page_size == 64
    with pytest.raises(KeyError):
        get_config("no-such-arch")
