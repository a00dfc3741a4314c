"""Token sampling utilities."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (first index on ties), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over the last axis: no host sync, and one uniform
    per logit from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + g, dim=-1)


def temperature_sample(gen: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature + top-k sampling over the last axis.

    Top-k restricts the support to *exactly* ``k`` candidates: a draw picks
    an index into ``torch.topk``'s result and maps it back through the
    returned indices, so logits tied with the k-th one do not widen the
    support.  ``top_k >= vocab`` degrades to plain temperature sampling;
    ``top_k <= 0`` disables top-k.  Draws come from ``gen`` (a
    ``torch.Generator`` on the logits' device).
    """
    lg = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        k = min(int(top_k), lg.shape[-1])
        vals, idx = torch.topk(lg, k, dim=-1)
        choice = _categorical(gen, vals)
        return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
    return _categorical(gen, lg).to(torch.int32)
