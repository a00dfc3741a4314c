"""Model-facing entry point of the SSD scan.

The JAX package's ``ops.py`` pads L to a chunk multiple (dt = 0) and H to
the TPU kernel's head block (A = 0).  The CUDA kernel takes any L and H, so
here the entry point only brings its inputs to the kernel's layout and
types: x, Bm and Cm in one dtype, dt, A and h0 in fp32, all contiguous,
and x, Bm, Cm and h0 starting on a 16-byte boundary (the tensor-core route
copies them by 16 bytes; a view that starts elsewhere is copied).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_scan_kernel


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H); A (H,); Bm, Cm (B, L, N); h0
    (B, H, P, N) or None (a zero state) -> ``(y (B, L, H, P) in x's dtype,
    h_final (B, H, P, N) fp32)``; fp32 math."""
    f32 = torch.float32
    return ssd_scan_kernel(_aligned(x), dt.to(f32).contiguous(), A.to(f32).contiguous(),
                           _aligned(Bm.to(x.dtype)), _aligned(Cm.to(x.dtype)),
                           None if h0 is None else _aligned(h0.to(f32)), chunk=chunk)
