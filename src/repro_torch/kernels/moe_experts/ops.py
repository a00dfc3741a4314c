"""Model-facing entry points of the MoE kernels.

The JAX package scatters each routed pair into a per-expert capacity buffer
and runs every expert over its whole buffer (``_dispatch_ffn``).  Here the
pairs arrive already sorted by expert with their segment offsets, and an
expert layer is two launches of the grouped kernel: gate and up (or up
alone for a GELU expert) with the activation in the epilogue, then down.
The shared expert, where the layer has one, rides in both launches as a
second group over the layer's token rows.  :func:`route` and
:func:`combine` are the layer's routing and weighted combine, one launch
each.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from .kernel import moe_combine_kernel, moe_experts_kernel, moe_route_kernel
from .ref import Route


def _dense(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def route(x: torch.Tensor, w: torch.Tensor, k: int,
          forced: Optional[torch.Tensor] = None) -> Route:
    """x (T, D) bf16, w (D, E) fp32 -> the layer's :class:`~.ref.Route` of
    the T tokens to k experts each (``forced`` (T, k) int32: those experts,
    at their gates)."""
    return moe_route_kernel(_dense(x), w.contiguous(), k, forced)


def combine(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
            kept: Optional[torch.Tensor] = None,
            y_shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The experts' rows ``ys`` (P, D) in expert order back to their T
    tokens: each token's k rows (found through ``pos``; zero where ``kept``
    is False) weighted and summed, plus ``y_shared`` (T, D)."""
    return moe_combine_kernel(ys, pos, weights, kept,
                              None if y_shared is None else _dense(y_shared))


def expert_ffn(mlp: str, xs: torch.Tensor, offsets: torch.Tensor, experts: Mapping,
               shared: Optional[Tuple[torch.Tensor, Mapping]] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The experts' FFN over the routed rows ``xs`` (P, D), in expert order
    with ``offsets`` (E + 1,) int32, and the shared expert's over
    ``shared = (x (T, D), its weights)``: returns (ys (P, D), shared ys (T,
    D) or None), both bf16.  ``mlp`` is ``"swiglu"`` (weights ``w_gate``,
    ``w_up``, ``w_down``) or a GELU expert (``w_up``, ``w_down``), as the
    JAX package's ``_dispatch_ffn`` reads them."""
    xs = _dense(xs)
    if mlp == "swiglu":
        first = ("swiglu", experts["w_gate"], experts["w_up"])
    else:
        if shared is not None:
            raise NotImplementedError("a shared expert beside GELU experts is not ported "
                                      "(no configuration has one)")
        first = ("gelu", experts["w_up"], None)
    mode, w1, w2 = first
    sh_up = sh_down = None
    if shared is not None:
        x_t, p = shared
        sh_up = (_dense(x_t), p["w_gate"], p["w_up"])
    h, h_s = moe_experts_kernel(mode, xs, offsets, w1, w2, shared=sh_up)
    if shared is not None:
        sh_down = (h_s, shared[1]["w_down"], None)
    return moe_experts_kernel("plain", h, offsets, experts["w_down"], shared=sh_down)
