"""Zamba2-2.7B [arXiv:2411.15242; hf]: 54L d2560, Mamba2 backbone +
shared attention block (32H, kv=32) every 6 layers, d_ff=10240,
ssm_state=64, vocab 32000."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=128, shared_attn_every=6),
    param_dtype="bfloat16",
)
