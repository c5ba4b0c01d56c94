from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    torch_dtype,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "ParallelConfig",
    "TrainConfig",
    "torch_dtype",
    "ARCH_IDS",
    "all_configs",
    "get_config",
]
