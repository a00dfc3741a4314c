"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG``, the full-scale config.  The dense
architectures, the recurrentgemma hybrid, mamba2 and the two MoE
architectures have a model in this package; the others raise until their
family is ported.
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
}

# architectures of families this package does not serve yet
_NOT_PORTED = ("internvl2-2b", "whisper-base")


def get(name: str) -> ArchConfig:
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in _ALIAS.values():
        if name in _NOT_PORTED:
            raise KeyError(f"arch {name!r} is not ported yet; "
                           f"available: {list(_ALIAS)}")
        raise KeyError(f"unknown arch {name!r}; available: {list(_ALIAS)}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ALIAS.keys())
