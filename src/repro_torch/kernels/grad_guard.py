"""Refusal of gradients a kernel cannot give.

A kernel launched through ctypes writes a fresh tensor with no autograd
history: a loss computed through it would silently leave every parameter
upstream of it without a gradient.  Each wrapper whose kernel has no
backward yet calls :func:`refuse_grad` on its CUDA inputs, so a training
step that reaches it raises instead.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(kernel: str, item: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad:
    ``kernel`` has no backward (ROADMAP ``item``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel (ROADMAP item {item}): its output would carry "
            "no gradient, so it refuses inputs that require grad on the card")
