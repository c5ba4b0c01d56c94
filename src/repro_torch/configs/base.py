"""Configs for the PyTorch port: ``ModelConfig`` with the same fields and
defaults as ``repro.configs.base.ModelConfig``, dtypes resolved to torch
dtypes; ``ShapeConfig`` and the dry-run's four ``SHAPES``,
``ParallelConfig`` and ``TrainConfig`` as the reference's.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.registry`` maps ``--arch`` ids
to them. The data is copied from the JAX package, not imported from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "SHAPES", "ParallelConfig",
           "TrainConfig", "torch_dtype"]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name ('bfloat16', 'float32', ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length
    shared_attn_every: int = 0    # hybrid: shared attention every k layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # defaults to d_model // n_heads
    qkv_bias: bool = False
    window: Optional[int] = None            # sliding-window attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    n_encoder_layers: int = 0
    n_prefix_embeds: int = 0
    eos_id: int = 1                          # end-of-sequence token id
    dtype: str = "bfloat16"                  # activation/compute dtype
    param_dtype: str = "float32"
    attn_impl: str = "auto"                  # auto | cuda | torch | reference | recompute
    attn_order: str = "sawtooth"             # cyclic | sawtooth | block_snake
    snake_group: Optional[int] = None        # block_snake reversal window
    q_block: int = 512
    kv_block: int = 512
    bwd_q_block: Optional[int] = None
    bwd_kv_block: Optional[int] = None
    remat: str = "full"
    score_dtype: str = "float32"
    moe_serve_dropless: bool = True
    ssd_impl: str = "auto"
    kv_cache_dtype: str = "bfloat16"         # bfloat16 | int8
    kv_layout: str = "contiguous"            # contiguous | paged
    page_size: Optional[int] = None          # KV page rows; default kv_block
    scan_layers: bool = True
    logit_softcap: Optional[float] = None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def parameter_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (as the JAX package's)."""
        kw: dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            q_block=64,
            kv_block=64,
            param_dtype="float32",
            dtype="float32",
            remat="none",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=32
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm,
                state_dim=16,
                head_dim=16,
                chunk=32,
                shared_attn_every=2 if self.ssm.shared_attn_every else 0,
            )
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
        if self.n_prefix_embeds:
            kw["n_prefix_embeds"] = 8
        if self.window is not None:
            kw["window"] = 32
        return self.with_(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry-run: the global batch of a training step,
    a prefill or a decode step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 128), global_batch=min(self.global_batch, 2)
        )


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How logical dims map onto a mesh, and runtime knobs, with the
    reference's names and defaults. The axes place params, batches and
    caches on a ``DeviceMesh`` (``dist.sharding``); without a mesh only
    ``microbatches`` (gradient accumulation) has an effect.
    ``seq_shard_activations`` is read by the dry-run's activation rules;
    ``grad_compression`` and ``zero_grads`` are read by nothing, in the
    reference's step as in the port's."""

    fsdp_axes: Sequence[str] = ("pod", "data")
    tensor_axis: str = "model"
    data_axes: Sequence[str] = ("pod", "data")
    seq_shard_activations: bool = False
    microbatches: int = 1                         # gradient accumulation
    grad_compression: str = "none"
    zero_grads: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    optimizer: str = "adamw"          # adamw | adamw_factored
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
