"""Architecture registry: one module per assigned architecture.

``get(arch_id)`` returns the full-size ModelConfig; ``get_reduced`` the
CPU-smoke-test variant of the same family.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "jamba-v0.1-52b",
    "nemotron-4-15b",
    "phi4-mini-3.8b",
    "qwen3-4b",
    "llama3-405b",
    "mamba2-370m",
    "seamless-m4t-large-v2",
    "deepseek-moe-16b",
    "mixtral-8x22b",
    "internvl2-26b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str):
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _module(arch_id).REDUCED
