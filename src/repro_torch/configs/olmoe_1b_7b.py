"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H (GQA kv=16) MoE 64e top-8,
d_ff_expert=1024, vocab 50304."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=10000.0,
    param_dtype="bfloat16",
)
