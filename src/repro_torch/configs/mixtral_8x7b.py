"""Mixtral-8x7B [arXiv:2401.04088; hf]: 32L d4096 32H (GQA kv=8) MoE 8e top-2,
d_ff=14336, vocab 32000, SWA window 4096."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1000000.0,
    param_dtype="bfloat16",
)
