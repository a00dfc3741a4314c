"""Refusal of gradients a kernel cannot give.

A kernel launched through ctypes writes a fresh tensor with no autograd
history: a loss computed through it would silently leave every parameter
upstream of it without a gradient.  Each wrapper whose kernel has no
backward yet calls :func:`refuse_grad` on its CUDA inputs, so a training
step that reaches it raises instead; so does a kernel whose backward
runs only through an ``autograd.Function``, when it is called directly.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(kernel: str, item: str, *tensors: Optional[torch.Tensor],
                via: Optional[str] = None) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad:
    ``kernel`` has no backward (ROADMAP ``item``), or, given ``via``, its
    backward runs only through that ``autograd.Function``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        if via is not None:
            raise NotImplementedError(
                f"{kernel} called directly carries no gradient: its backward (ROADMAP item "
                f"{item}) runs through {via}, so a direct call refuses inputs that require "
                "grad on the card")
        raise NotImplementedError(
            f"{kernel} has no backward kernel (ROADMAP item {item}): its output would carry "
            "no gradient, so it refuses inputs that require grad on the card")
