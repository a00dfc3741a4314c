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

:func:`layer_forward` is the whole routed FFN of a layer (route, the row
gather, the two expert launches, combine), the one sequence of both
paths: every call without grad (serving, graphs, decode) makes it alone,
and :func:`moe_layer`, where autograd needs it (grad mode on and an input
that requires grad), runs it through :class:`MoEFFN`, a
``torch.autograd.Function`` whose backward is the kernels of
``moe_backward.cu``.  :func:`layer_forward_shard` is the layer on one
expert shard under a mesh: the same launches with the combine's fp32
partial all-reduced over ``model``.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Tuple

import torch

from .kernel import (moe_combine_backward_kernel, moe_combine_kernel, moe_down_grad_kernel,
                     moe_experts_kernel, moe_route_backward_kernel, moe_route_kernel,
                     moe_up_grad_kernel, moe_weight_grad_kernel)
from .ref import Route, shard_kept


def _dense(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


ROUTE_OBSERVERS: List[Callable[[torch.Tensor, Route], None]] = []
"""Callbacks :func:`route` calls with each layer's input and its route,
in order (a check that every rank of a ``model`` group routes alike adds
one for its scope)."""


def route(x: torch.Tensor, w: torch.Tensor, k: int,
          forced: Optional[torch.Tensor] = None) -> Route:
    """x (T, D) bf16, w (D, E) fp32 -> the layer's :class:`~.ref.Route` of
    the T tokens to k experts each (``forced`` (T, k) int32: those experts,
    at their gates); each of :data:`ROUTE_OBSERVERS` then sees (x, the
    route)."""
    r = moe_route_kernel(_dense(x), w.contiguous(), k, forced)
    for observe in ROUTE_OBSERVERS:
        observe(x, r)
    return r


def combine(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
            kept: Optional[torch.Tensor] = None,
            y_shared: Optional[torch.Tensor] = None, *, partial: bool = False) -> torch.Tensor:
    """The experts' rows ``ys`` (P, D) in expert order back to their T
    tokens: each token's k rows (found through ``pos``; zero where ``kept``
    is False) weighted and summed, plus ``y_shared`` (T, D).  ``partial``:
    the fp32 sum before its cast, with no shared row."""
    return moe_combine_kernel(ys, pos, weights, kept,
                              None if y_shared is None else _dense(y_shared), partial=partial)


def expert_ffn(mlp: str, xs: torch.Tensor, offsets: torch.Tensor, experts: Mapping,
               shared: Optional[Tuple[torch.Tensor, Mapping]] = None, *, save: bool = False):
    """The experts' FFN over the routed rows ``xs`` (P, D), in expert order
    with ``offsets`` (E + 1,) int32, and the shared expert's over
    ``shared = (x (T, D), its weights)``: returns (ys (P, D), shared ys (T,
    D) or None), both bf16.  ``mlp`` is ``"swiglu"`` (weights ``w_gate``,
    ``w_up``, ``w_down``) or a GELU expert (``w_up``, ``w_down``), as the
    JAX package's ``_dispatch_ffn`` reads them.  With ``save`` it returns a
    third item, the backward's tensors ``(a, b, a_s, b_s, h, h_s)``: the
    gate/up launch's bf16 pre-activations (which that launch then also
    stores) and the down launch's inputs."""
    xs = _dense(xs)
    if mlp == "swiglu":
        mode, w1, w2 = "swiglu", experts["w_gate"], experts["w_up"]
    else:
        if shared is not None:
            raise NotImplementedError("a shared expert beside GELU experts is not ported "
                                      "(no configuration has one)")
        mode, w1, w2 = "gelu", experts["w_up"], None
    sh_up = None if shared is None else (_dense(shared[0]), shared[1]["w_gate"],
                                         shared[1]["w_up"])
    pre = None
    if save:
        P, F = xs.shape[0], w1.shape[-1]
        pre = [xs.new_empty((P, F)), None if w2 is None else xs.new_empty((P, F)), None, None]
        if shared is not None:
            R, Fs = shared[0].shape[0], shared[1]["w_up"].shape[-1]
            pre[2:] = [xs.new_empty((R, Fs)), xs.new_empty((R, Fs))]
    h, h_s = moe_experts_kernel(mode, xs, offsets, w1, w2, shared=sh_up, pre=pre)
    sh_down = None if shared is None else (h_s, shared[1]["w_down"], None)
    ys, y_shared = moe_experts_kernel("plain", h, offsets, experts["w_down"], shared=sh_down)
    return (ys, y_shared, (*pre, h, h_s)) if save else (ys, y_shared)


def layer_forward(mlp: str, x: torch.Tensor, w_router: torch.Tensor, experts: Mapping,
                  shared: Optional[Mapping], k: int, cap: Optional[int], save: bool = False):
    """The routed FFN of a layer, five launches: :func:`route`, the row
    gather, :func:`expert_ffn`'s two launches and :func:`combine`.  x (T,
    D) bf16 -> (out (T, D), the :class:`~.ref.Route`, saved).  ``cap`` is
    the capacity (a pair whose rank within its expert reaches it
    contributes zero), or None for drop-free routing.  With ``save``,
    saved is what :class:`MoEFFN`'s backward reads: ``(kept, xs, ys, a, b,
    a_s, b_s, h, h_s)``; else None."""
    r = route(x, w_router, k)
    xs = x.index_select(0, r.tok)
    ys, y_shared, *pre = expert_ffn(mlp, xs, r.offsets, experts,
                                    None if shared is None else (x, shared), save=save)
    kept = None if cap is None else r.rank < cap
    out = combine(ys, r.pos, r.weights, kept, y_shared)
    return out, r, (kept, xs, ys, *pre[0]) if save else None


def layer_forward_shard(mlp: str, x: torch.Tensor, w_router: torch.Tensor, experts: Mapping,
                        shared: Optional[Mapping], k: int, cap: Optional[int], lo: int, hi: int,
                        all_reduce: Callable[[torch.Tensor], torch.Tensor]):
    """One expert shard's routed FFN of a layer (experts ``[lo, hi)``,
    ``experts`` that shard's (hi - lo, ·, ·) weights), the same five
    launches and one collective: :func:`route` of all T tokens (every rank
    of a ``model`` group routes them alike); the row gather; the two
    expert launches over the shard's segment of the expert-sorted rows,
    ``[offsets[lo], offsets[hi])``, with the route's offsets viewed at
    ``[lo, hi]`` (no sort, no host read; the segment's rows land at their
    sorted positions of the (T k, D) buffer, the rest never written nor
    read), the shared expert riding in both; :func:`combine` into an fp32
    (T, D) partial, every other shard's pair contributing exactly zero
    through ``kept``; then ``all_reduce`` (the SUM over ``model``, in place)
    of that partial, one cast to bf16 and the shared rows added: the order
    of the unsharded combine, so a single shard is bitwise
    :func:`layer_forward`.  Returns (out (T, D), the route)."""
    r = route(x, w_router, k)
    xs = x.index_select(0, r.tok)
    ys, y_shared = expert_ffn(mlp, xs, r.offsets[lo:hi + 1], experts,
                              None if shared is None else (x, shared))
    part = combine(ys, r.pos, r.weights, shard_kept(r.idx, lo, hi, r.rank, cap), partial=True)
    out = all_reduce(part).to(x.dtype)
    if y_shared is not None:
        out = out + y_shared
    return out, r


_KEYS = ("w_gate", "w_up", "w_down")


class MoEFFN(torch.autograd.Function):
    """``(out, gates, offsets)`` of a layer's routed FFN on x (T, D) bf16,
    :func:`layer_forward`, with the kernels' backward.

    The forward is the same five launches as without grad, its outputs
    bitwise the same; its gate/up launch also writes the bf16
    pre-activations a and b, which the backward reads (2 P F bf16 stores,
    against a second gate/up launch's 4 P D F operations), and it saves x,
    the route, the gathered rows, h and ys.  Under
    ``torch.utils.checkpoint`` the recompute's forward saves its own, one
    layer at a time.  ``gates`` is differentiable (the aux loss reads it);
    ``offsets`` is not.

    The backward launches, in order: the combine's backward (dys,
    dweights); the down data gradient with the activation's backward (da,
    db); every weight gradient in one launch; the gate/up data gradient
    (the routed rows' and the shared expert's dx); the gather's backward
    (the combine kernel with unit weights, which also adds the shared
    expert's dx); the route backward (the router's dx and dw).  dx is the
    routed and shared part plus the router's, added in x's dtype."""

    @staticmethod
    def forward(ctx, x, w_router, w_gate, w_up, w_down, s_gate, s_up, s_down, mlp: str, k: int,
                cap: Optional[int]):
        x = _dense(x)
        experts = {n: t for n, t in zip(_KEYS, (w_gate, w_up, w_down)) if t is not None}
        shared = None if s_up is None else dict(zip(_KEYS, (s_gate, s_up, s_down)))
        out, r, saved = layer_forward(mlp, x, w_router, experts, shared, k, cap, save=True)
        ctx.save_for_backward(x, w_router, w_gate, w_up, w_down, s_gate, s_up, s_down, r.gates,
                              r.weights, r.idx, r.offsets, r.pos, *saved)
        ctx.mlp = mlp
        ctx.mark_non_differentiable(r.offsets)
        ctx.set_materialize_grads(False)
        return out, r.gates, r.offsets

    @staticmethod
    def backward(ctx, dout, dgates, _doffsets):
        (x, w_router, w_gate, w_up, w_down, s_gate, s_up, s_down, gates, weights, idx, offsets,
         pos, kept, xs, ys, a, b, a_s, b_s, h, h_s) = ctx.saved_tensors
        T, k = weights.shape
        dout = x.new_zeros(x.shape) if dout is None else _dense(dout.to(x.dtype))
        dgates = None if dgates is None else dgates.to(gates.dtype).contiguous()
        swiglu = ctx.mlp == "swiglu"
        w1, w2 = (w_gate, w_up) if swiglu else (w_up, None)
        shared = s_up is not None       # a SwiGLU shared expert (none beside GELU experts)
        dys, dweights = moe_combine_backward_kernel(dout, ys, pos, weights, kept)
        da, db, d_s = moe_down_grad_kernel("swiglu" if swiglu else "gelu", dys, offsets, w_down,
                                           a, b, (dout, s_down, a_s, b_s) if shared else None)
        # the shared expert's T-row segments first: the longest
        jobs = [(h_s, dout, None), (x, d_s[0], None), (x, d_s[1], None)] if shared else []
        jobs += [(h, dys, offsets), (xs, da, offsets)] + ([(xs, db, offsets)] if swiglu else [])
        grads = moe_weight_grad_kernel(jobs)
        dsh = (None,) * 3
        if shared:
            gs_down, gs_gate, gs_up = grads[:3]
            dsh, grads = (gs_gate, gs_up, gs_down), grads[3:]
        dexp = (grads[1], grads[2], grads[0]) if swiglu else (None, grads[1], grads[0])
        dxs, dx_s = moe_up_grad_kernel(da, db, offsets, w1, w2,
                                       (d_s[0], d_s[1], s_gate, s_up) if shared else None)
        ones = torch.ones(T, k, dtype=torch.float32, device=x.device)
        dx = moe_combine_kernel(dxs, pos, ones, None, dx_s)        # the gather's backward
        dx_r, dw_router = moe_route_backward_kernel(x, w_router, gates, weights, idx, dweights,
                                                    dgates)
        return (dx + dx_r, dw_router.to(w_router.dtype), *dexp, *dsh, None, None, None)


def moe_layer(mlp: str, x: torch.Tensor, w_router: torch.Tensor, experts: Mapping,
              shared: Optional[Mapping], k: int, cap: Optional[int]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routed FFN of a layer through :class:`MoEFFN`: x (T, D) bf16 ->
    (out (T, D), gates (T, E) fp32, offsets (E + 1,) int32), differentiable
    in x, the router and every expert and shared weight."""
    sh = shared or {}
    return MoEFFN.apply(x, w_router, experts.get("w_gate"), experts["w_up"], experts["w_down"],
                        sh.get("w_gate"), sh.get("w_up"), sh.get("w_down"), mlp, k, cap)
