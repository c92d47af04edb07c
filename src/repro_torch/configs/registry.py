"""Architecture registry: ``--arch <id>`` resolution for launch/ & benchmarks."""

from __future__ import annotations

import importlib

from .arch import ArchConfig

# the dense family, rwkv (ssm) and zamba (hybrid); the other families'
# configs come with their port
_MODULES = {
    "yi-34b": "yi_34b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-0.5b": "qwen15_05b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
