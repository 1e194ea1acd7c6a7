"""Registry of the architectures the port runs.

``get_config(name)`` returns the full published config (the same values
as ``repro.configs``); pair it with
``repro_torch.models.config.smoke_config`` for CPU-sized versions.  The
port runs the dense and ssm families so far; every other arch of the
reference's zoo raises ``KeyError`` until it is ported (ROADMAP.md, queue
1 item 7).
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "qwen3-0.6b",
    "mamba2-130m",
]

_MODULE_FOR = {name: name.replace("-", "_").replace(".", "_")
               for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"arch {name!r} is not ported to repro_torch; the "
                       f"port runs {ARCHS} (see ROADMAP.md, queue 1 item 7, "
                       f"for what is left)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG
