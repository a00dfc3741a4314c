"""Plain PyTorch versions of the grouped expert kernel and the router product.

:func:`moe_experts_plain` is the function ``kernels/csrc/moe_experts.cu``
computes, as a loop over experts with one product per segment (host
offsets): expert ``e`` takes rows ``[offsets[e], offsets[e + 1])`` of ``x``
through its weights, rounding where the JAX package's einsums and
activations round (each product's bf16 output, the activation, the SwiGLU
product).  :func:`moe_router_plain` is the fp32 router product.

On the CPU every product is an fp32 multiply-and-sum per row
(:func:`row_products`), so a row's result does not depend on how many rows
share the call: the CPU's matmul picks its blocking by row count, and the
port's decode == chunked-prefill tests hold the MoE layer bitwise.  On the
card the plain version is a ``torch.matmul`` per segment (the kernel is
held to it within a tolerance there, never bitwise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MODES = ("swiglu", "gelu", "plain")     # index = the C interface's mode code


def row_products(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x (M, K) . w (K, N) with fp32 accumulation, in ``out_dtype``.  On the
    CPU each row is its own multiply-and-sum (the (M, K, N) products are
    made: small sizes only); on the card a matmul."""
    if x.device.type == "cpu":
        return (x.float().unsqueeze(-1) * w.float()).sum(-2).to(out_dtype)
    if x.dtype == torch.float32:
        return (x @ w).to(out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)


def _ffn_plain(mode: str, x: torch.Tensor, w1: torch.Tensor,
               w2: Optional[torch.Tensor]) -> torch.Tensor:
    a = row_products(x, w1, x.dtype)
    if mode == "swiglu":
        return F.silu(a) * row_products(x, w2, x.dtype)
    if mode == "gelu":
        return F.gelu(a, approximate="tanh")
    return a


def moe_experts_plain(mode: str, x: torch.Tensor, offsets: torch.Tensor, w1: torch.Tensor,
                      w2: Optional[torch.Tensor] = None,
                      shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             Optional[torch.Tensor]]] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mode`` in MODES; x (P, K) bf16 in expert order; offsets (E + 1,)
    int; w1, w2 (E, K, N) -> (out (P, N), shared out or None).  ``shared``
    is ``(x_s (R, K_s), w1_s (K_s, N_s), w2_s)``: one more expert over all
    of ``x_s``'s rows."""
    out = x.new_empty((x.shape[0], w1.shape[-1]))
    bounds = [int(v) for v in offsets.tolist()]
    for e in range(w1.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = _ffn_plain(mode, x[lo:hi], w1[e], None if w2 is None else w2[e])
    out_s = None
    if shared is not None:
        xs, w1s, w2s = shared
        out_s = _ffn_plain(mode, xs, w1s, w2s)
    return out, out_s


def moe_router_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, D) bf16, w (D, E) fp32 -> logits (T, E) fp32, the product in
    full fp32 (no TF32)."""
    return row_products(x.float(), w.float(), torch.float32)
