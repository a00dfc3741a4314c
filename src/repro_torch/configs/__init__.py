"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG``, the full-scale config; every
architecture of the JAX package has a model in this package.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

_ALIAS = {
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-110b": "qwen1p5_110b",
    "minicpm-2b": "minicpm_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-1.3b": "mamba2_1p3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-base": "whisper_base",
    "internvl2-2b": "internvl2_2b",
}


def get(name: str) -> ArchConfig:
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in _ALIAS.values():
        raise KeyError(f"unknown arch {name!r}; available: {list(_ALIAS)}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ALIAS.keys())
