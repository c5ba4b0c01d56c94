"""--arch registry: maps public ids (hyphens or underscores) to configs.

``ARCH_IDS`` are the reference's ids, each a module's ``CONFIG``.
``PORT_ARCH_IDS`` are the port's own, each another config of one of those
modules (``olmoe-1b-7b-0924``: OLMoE as published); ``get_config`` and
the launchers' ``--arch`` resolve both."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "olmoe-1b-7b",
    "mixtral-8x7b",
    "llama3-405b",
    "deepseek-7b",
    "qwen2-72b",
    "codeqwen1_5-7b",
    "seamless-m4t-medium",
    "mamba2-130m",
    "zamba2-2_7b",
    "phi-3-vision-4_2b",
    "paper-gb10",
]

# port-only id -> (the module of ARCH_IDS that holds it, its attribute there)
PORT_ARCH_IDS = {
    "olmoe-1b-7b-0924": ("olmoe-1b-7b", "PUBLISHED"),
}


def _module_for(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    norm = arch.replace(".", "_").replace("-", "_")
    for known, (module, attr) in PORT_ARCH_IDS.items():
        if _module_for(known) == norm:
            return getattr(importlib.import_module(f"repro_torch.configs.{_module_for(module)}"),
                           attr)
    for known in ARCH_IDS:
        if _module_for(known) == norm:
            mod = importlib.import_module(f"repro_torch.configs.{_module_for(known)}")
            return mod.CONFIG
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + list(PORT_ARCH_IDS)}")


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS if a != "paper-gb10"}
