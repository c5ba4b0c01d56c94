"""The paper's own benchmark configuration (GB10 CuTile experiments, §4.3):
single attention workload, batch 8, seq 128K, head_dim 64, tile 64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-gb10",
    family="dense",
    n_layers=1,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=256,
    vocab=256,
    head_dim=64,
    q_block=64,
    kv_block=64,
)
