"""Data-plane model zoo (dense and hybrid families so far).

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

_NOT_PORTED = ("moe", "ssm", "audio", "vlm")


def build_model(cfg: ArchConfig, *, device="cuda", seed: Optional[int] = 0):
    """The model for ``cfg`` on ``device``, weights drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    if cfg.family == "dense":
        from .transformer import DenseLM

        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        return DenseLM(cfg, device=device, generator=gen)
    if cfg.family == "hybrid":
        from .rglru import RecurrentLM

        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        return RecurrentLM(cfg, device=device, generator=gen)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    raise ValueError(f"unknown family {cfg.family}")


__all__ = ["ArchConfig", "build_model"]
