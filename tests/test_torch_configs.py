"""The port's configs equal the JAX package's, field by field; the port's
own fields (``PORT_ONLY_FIELDS``) sit at their defaults on every config the
reference has, and the port-only ids resolve to their own configs."""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config

# The fields the reference's configs lack, by class, at the defaults that
# leave a config as the reference's reads.
PORT_ONLY_FIELDS = {"ModelConfig": {"qk_norm": False}, "MoEConfig": {"norm_topk_prob": True}}


def _without_port_fields(cfg) -> tuple[list, dict]:
    """(field names, asdict) of a port config less its port-only fields,
    each of which must hold its default there."""
    own = PORT_ONLY_FIELDS["ModelConfig"]
    d = dataclasses.asdict(cfg)
    for name, default in own.items():
        assert d.pop(name) == default, name
    if d["moe"] is not None:
        for name, default in PORT_ONLY_FIELDS["MoEConfig"].items():
            assert d["moe"].pop(name) == default, name
    return [f.name for f in dataclasses.fields(cfg) if f.name not in own], d


def test_arch_ids_equal():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_fields_equal(arch, reduced):
    ref, got = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    names, fields = _without_port_fields(got)
    assert names == [f.name for f in dataclasses.fields(ref)]
    assert fields == dataclasses.asdict(ref)
    assert got.hd == ref.hd


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_dtypes_map_to_torch(name):
    cfg = get_config("deepseek-7b").with_(dtype=name, param_dtype=name)
    ref = ref_get_config("deepseek-7b").with_(dtype=name, param_dtype=name)
    want = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert cfg.activation_dtype() == want[ref.activation_dtype()]
    assert cfg.parameter_dtype() == want[ref.parameter_dtype()]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-0924", "olmoe_1b_7b_0924"])
def test_port_only_ids_resolve(arch):
    """OLMoE as published: the reference's olmoe-1b-7b with both port-only
    switches on, its eps and eos; not among the reference's ids."""
    got, base = get_config(arch), get_config("olmoe-1b-7b")
    assert "olmoe-1b-7b-0924" in PORT_ARCH_IDS and "olmoe-1b-7b-0924" not in ARCH_IDS
    assert got.qk_norm and not got.moe.norm_topk_prob
    assert (got.name, got.norm_eps, got.eos_id) == ("olmoe-1b-7b-0924", 1e-5, 50279)
    assert got.with_(name=base.name, qk_norm=False, moe=base.moe, eos_id=base.eos_id) == base
    assert got.reduced().qk_norm and not got.reduced().moe.norm_topk_prob


def test_with_and_unknown_arch():
    cfg = get_config("deepseek-7b")
    assert cfg.with_(page_size=64).page_size == 64
    with pytest.raises(KeyError):
        get_config("no-such-arch")
