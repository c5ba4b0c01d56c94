"""Mamba2-130m [arXiv:2405.21060; unverified]: 24L d768, attention-free SSD,
ssm_state=128, vocab 50280. Sawtooth KV scheduling inapplicable
(DESIGN.md §5)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128),
    tie_embeddings=True,
)
