"""Model-facing entry point of the RG-LRU scan.

The JAX package's ``ops.py`` pads L and W to the TPU kernel's block
multiples (a=1, b=0).  The CUDA kernel takes any B, L and W, so here the
entry point only brings its inputs to the kernel's layout.
"""

from __future__ import annotations

import torch

from .kernel import rglru_scan_kernel


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, L, W) -> h (B, L, W); ``h_t = a_t * h_{t-1} + b_t`` from a
    zero state, fp32 math, output in a's dtype."""
    return rglru_scan_kernel(a.contiguous(), b.contiguous())
