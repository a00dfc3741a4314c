"""Model-facing entry point of the SSD scan.

The JAX package's ``ops.py`` pads L to a chunk multiple (dt = 0) and H to
the TPU kernel's head block (A = 0).  The CUDA kernel takes any L and H, so
here the entry point only brings its inputs to the kernel's layout and
types: x, Bm and Cm in one dtype, dt, A and h0 in fp32, all contiguous,
and x, Bm, Cm and h0 starting on a 16-byte boundary (the tensor-core route
copies them by 16 bytes; a view that starts elsewhere is copied).

Where autograd needs it (grad mode on and an input that requires grad),
the call goes through :class:`SSDScan`, a ``torch.autograd.Function``
whose backward is the kernel's (``ssd_scan_backward_kernel``).  Every
other call (serving, graphs, decode) launches the forward alone, as before.

:func:`ssd_scan_shard` is the scan on one shard of the heads (the serving
path's SSD state split on the ``model`` axis of a mesh): heads never mix in
the scan, so it is one launch on the heads' slices of x, dt and A with the
shard's own state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_scan_backward_kernel, ssd_scan_kernel


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class SSDScan(torch.autograd.Function):
    """``(y, h_final) = ssd_scan_kernel(x, dt, A, Bm, Cm, h0)`` with the
    kernel's backward: saves the inputs (the backward runs the state
    passes again rather than keeping the forward's states); returns dx,
    ddt, dA, dBm, dCm and dh0 in the inputs' dtypes.  A gradient on either
    output may be absent (None: no gradient flows from it).  Under
    ``torch.utils.checkpoint`` the recompute's forward saves its own."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk: int):
        y, h_final = ssd_scan_kernel(x, dt, A, Bm, Cm, h0, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else _aligned(dy.to(x.dtype))
        dh_final = None if dh_final is None else _aligned(dh_final.to(dt.dtype))
        grads = ssd_scan_backward_kernel(x, dt, A, Bm, Cm, h0, dy, dh_final, chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H); A (H,); Bm, Cm (B, L, N); h0
    (B, H, P, N) or None (a zero state) -> ``(y (B, L, H, P) in x's dtype,
    h_final (B, H, P, N) fp32)``; fp32 math (float64 for float64 inputs on
    the CPU).  Differentiable (through :class:`SSDScan`) in every input."""
    ft = torch.promote_types(x.dtype, torch.float32)
    args = (_aligned(x), dt.to(ft).contiguous(), A.to(ft).contiguous(), _aligned(Bm.to(x.dtype)),
            _aligned(Cm.to(x.dtype)), None if h0 is None else _aligned(h0.to(ft)))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return SSDScan.apply(*args, chunk)
    return ssd_scan_kernel(*args, chunk=chunk)


def ssd_scan_shard(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *, shard: int,
                   n_shards: int, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan over heads ``[shard * H / n_shards, (shard + 1) * H /
    n_shards)`` of x (B, L, H, P), dt (B, L, H) and A (H,), from the shard's
    own state ``h0`` (B, H / n_shards, P, N) or a zero state; Bm and Cm
    (B, L, N) are every head's.  Returns that shard's ``(y (B, L, H /
    n_shards, P), h_final (B, H / n_shards, P, N))``: one call of
    :func:`~.kernel.ssd_scan_kernel` on the slices, made contiguous and
    16-byte aligned (on a CUDA tensor the kernel, on the route the
    unsharded launch takes, since the route depends on the dtype, P and N
    alone; on the CPU the plain version).  Serving only: an input that
    requires grad raises, as the forward kernel does."""
    H = x.shape[2]
    if not 0 <= shard < n_shards or H % n_shards:
        raise ValueError(f"shard {shard} of {n_shards} does not split {H} heads")
    w = H // n_shards
    lo = shard * w
    if h0 is not None and tuple(h0.shape[:2]) != (x.shape[0], w):
        raise ValueError(f"h0 must be the shard's state (B, {w}, P, N), got {tuple(h0.shape)}")
    ft = torch.promote_types(x.dtype, torch.float32)
    return ssd_scan_kernel(_aligned(x[:, :, lo:lo + w]), dt[:, :, lo:lo + w].to(ft).contiguous(),
                           A[lo:lo + w].to(ft).contiguous(), _aligned(Bm.to(x.dtype)),
                           _aligned(Cm.to(x.dtype)),
                           None if h0 is None else _aligned(h0.to(ft)), chunk=chunk)
