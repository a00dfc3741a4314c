"""Plain PyTorch version of the RG-LRU scan kernel: a strict left fold.

``h_t = a_t * h_{t-1} + b_t`` over axis 1 from a zero state, in fp32, one
multiply and one add per step, each rounded (never fused): the contract of
the JAX package's ``reference_rglru``.  The wrapper in ``kernel.py`` runs it
for tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card, bitwise in fp32.
"""

from __future__ import annotations

import torch


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, L, W) -> h (B, L, W) in a's dtype; fp32 math."""
    af, bf = a.float(), b.float()
    h = af.new_zeros((af.shape[0], af.shape[2]))
    out = torch.empty_like(af)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
