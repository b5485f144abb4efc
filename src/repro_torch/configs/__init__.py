# Port of src/repro/configs/__init__.py: a copy with its imports rewired to repro_torch.
"""Architecture registry: one config per assigned architecture (+ paper's)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, RunConfig  # noqa: F401

_ARCH_MODULES = [
    "minicpm3_4b",
    "qwen2_7b",
    "qwen1_5_4b",
    "deepseek_coder_33b",
    "dbrx_132b",
    "llama4_scout_17b_16e",
    "falcon_mamba_7b",
    "musicgen_medium",
    "recurrentgemma_9b",
    "internvl2_1b",
    "qwen2_5_7b",  # the paper's own evaluation model
]

_REGISTRY: Dict[str, ModelConfig] = {}


def _load():
    if _REGISTRY:
        return
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        cfg = mod.CONFIG
        _REGISTRY[cfg.name] = cfg


def get_config(name: str) -> ModelConfig:
    _load()
    return _REGISTRY[name]


def list_archs(assigned_only: bool = True) -> List[str]:
    _load()
    names = list(_REGISTRY)
    if assigned_only:
        names = [n for n in names if n != "qwen2.5-7b"]
    return names
