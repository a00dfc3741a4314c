"""Data-plane model zoo (dense, MoE, hybrid and SSM families so far).

``build_model(cfg, device=..., seed=...)`` dispatches on ``cfg.family`` and
returns an ``nn.Module`` with the interface::

    apply(tokens) -> logits                         # full-sequence forward
    init_cache(B, seq_len) -> cache
    decode_step(cache, tokens) -> (logits, cache)
    prefill(tokens, seq_len=) -> (logits, cache)
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import ArchConfig

_NOT_PORTED = ("audio", "vlm")


def build_model(cfg: ArchConfig, *, device="cuda", seed: Optional[int] = 0):
    """The model for ``cfg`` on ``device``, weights drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.family == "dense":
        from .transformer import DenseLM as model_cls
    elif cfg.family == "moe":
        from .moe import MoELM as model_cls
    elif cfg.family == "hybrid":
        from .rglru import RecurrentLM as model_cls
    elif cfg.family == "ssm":
        from .mamba2 import Mamba2LM as model_cls
    else:
        raise ValueError(f"unknown family {cfg.family}")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return model_cls(cfg, device=device, generator=gen)


__all__ = ["ArchConfig", "build_model"]
