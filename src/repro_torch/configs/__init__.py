from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, torch_dtype
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "torch_dtype",
    "ARCH_IDS",
    "all_configs",
    "get_config",
]
