"""Registry of the architectures the port runs: the reference's ten.

``get_config(name)`` returns the full published config (the same values
as ``repro.configs``); pair it with
``repro_torch.models.config.smoke_config`` for CPU-sized versions.  An
unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "musicgen-medium",
    "minitron-4b",
    "gemma3-1b",
    "glm4-9b",
    "qwen3-0.6b",
    "mamba2-130m",
    "zamba2-2.7b",
    "granite-moe-3b-a800m",
    "dbrx-132b",
    "internvl2-2b",
]

_MODULE_FOR = {name: name.replace("-", "_").replace(".", "_")
               for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCHS}
