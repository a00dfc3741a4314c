"""AdamW and the learning-rate schedules, with the JAX package's semantics
(``src/repro/train/optim.py``).

The WSD (warmup-stable-decay) schedule of MiniCPM (arXiv:2404.06395) is
what the driver selects for minicpm-2b; the others take the cosine
schedule.  The optimiser state is a dict ``{"mu": {name: tensor}, "nu":
{...}, "step": int32 tensor}``, the moments fp32 and keyed by the model's
parameter names.  Weight decay applies to the leaves the reference
decays: those of ndim >= 2 in its tree, where every per-layer leaf is
stacked on a layer axis, so a layer's norm scales and biases are decayed
too (``decay`` names them; the train step derives it from the model's
layout).  The gradient is clipped by its global norm, and the update is
applied to the parameters and the moments in place (the JAX function
returns new ones).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.9        # wsd: fraction of post-warmup steps at peak
    min_ratio: float = 0.1


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def _warm(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)


def wsd_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Warmup-Stable-Decay: linear warmup, a long flat stage, a short
    linear decay to ``min_ratio``."""
    step = _f32(step)
    stable_end = cfg.warmup_steps + cfg.stable_frac * (cfg.total_steps - cfg.warmup_steps)
    decay_len = max(cfg.total_steps - stable_end, 1.0)
    decay = 1.0 - (1.0 - cfg.min_ratio) * torch.clamp((step - stable_end) / decay_len, 0.0, 1.0)
    return _warm(step, cfg) * torch.where(step <= stable_end, 1.0, decay)


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    step = _f32(step)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return _warm(step, cfg) * cos


def lr_at_step(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a 0-d tensor), fp32."""
    if cfg.schedule == "wsd":
        mult = wsd_schedule(step, cfg)
    elif cfg.schedule == "constant":
        mult = _warm(_f32(step), cfg)
    else:
        mult = cosine_schedule(step, cfg)
    return cfg.lr * mult


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Zero fp32 moments for every parameter and step 0 (int32), on the
    parameters' device."""
    dev = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, in fp32."""
    total = None
    for g in tree.values():
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 decay: Mapping[str, bool]) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One AdamW step: the parameters and the moments are updated in place
    (each product rounded as the reference's ``b1 * mu + (1 - b1) * g``;
    no second copy of the moments is held); returns the state with its
    new ``step`` and ``{"grad_norm", "lr"}`` (0-d fp32 tensors).  Bias
    correction, clipping by global norm (``grad_clip``), and decoupled
    weight decay on the leaves ``decay`` marks; each moment and the update
    in fp32."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0) if cfg.grad_clip
             else torch.ones_like(gn))
    stepf = step.float()
    lr = lr_at_step(stepf, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in params.items():
        g = grads[name].float() * scale
        mu = opt_state["mu"][name].mul_(b1).add_((1 - b1) * g)
        nu = opt_state["nu"][name].mul_(b2).add_((1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if decay[name]:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return ({"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step},
            {"grad_norm": gn, "lr": lr})
