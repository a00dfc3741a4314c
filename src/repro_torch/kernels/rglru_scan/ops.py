"""Model-facing entry point of the RG-LRU scan.

The JAX package's ``ops.py`` pads L and W to the TPU kernel's block
multiples (a=1, b=0).  The CUDA kernel takes any B, L and W, so here the
entry point only brings its inputs to the kernel's layout.  Where autograd
needs it, the call goes through :class:`RGLRUScan`, whose backward is the
same kernels in their reverse mode (``rglru_scan_backward_kernel``).
"""

from __future__ import annotations

import torch

from .kernel import rglru_scan_backward_kernel, rglru_scan_kernel


class RGLRUScan(torch.autograd.Function):
    """``h = scan(a, b)`` with ``db = dh`` and ``da_t = dh_t h_{t-1}``
    (``h_{-1} = 0``), dh from one reverse-mode launch of the kernel."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan_kernel(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        dh = rglru_scan_backward_kernel(a, g.to(a.dtype).contiguous())
        h_prev = torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]), h[:, :-1]], dim=1)
        return dh * h_prev, dh


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, L, W) -> h (B, L, W); ``h_t = a_t * h_{t-1} + b_t`` from a
    zero state, fp32 math, output in a's dtype."""
    a, b = a.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return rglru_scan_kernel(a, b)
