"""Plain PyTorch versions of the grouped expert kernel, the routing and the combine.

:func:`moe_experts_plain` is the function ``kernels/csrc/moe_experts.cu``
computes, as a loop over experts with one product per segment (host
offsets): expert ``e`` takes rows ``[offsets[e], offsets[e + 1])`` of ``x``
through its weights, rounding where the JAX package's einsums and
activations round (each product's bf16 output, the activation, the SwiGLU
product).  :func:`moe_router_plain` is the fp32 router product,
:func:`moe_route_plain` the layer's routing around it (softmax, top-k,
renormalisation, the stable sort of the pairs by expert:
:func:`route_logits_plain`) and
:func:`moe_combine_plain` the weighted combine: the torch sequence the
``moe_route`` and ``moe_combine`` kernels replace, op for op.

On the CPU every product is an fp32 multiply-and-sum per row
(:func:`row_products`), so a row's result does not depend on how many rows
share the call: the CPU's matmul picks its blocking by row count, and the
port's decode == chunked-prefill tests hold the MoE layer bitwise.  On the
card the plain version is a ``torch.matmul`` per segment (the kernel is
held to it within a tolerance there, never bitwise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


class Route(NamedTuple):
    """A layer's routing of T tokens to k of E experts; P = T k pairs in pair
    order ``t k + j``, int32 indices."""
    logits: torch.Tensor     # (T, E) fp32
    gates: torch.Tensor      # (T, E) fp32, the softmax
    weights: torch.Tensor    # (T, k) fp32, the top-k gates renormalised
    idx: torch.Tensor        # (T, k) experts, descending gate, ties to the lower index
    offsets: torch.Tensor    # (E + 1,) expert e's sorted rows [offsets[e], offsets[e + 1])
    order: torch.Tensor      # (P,) the pair at each sorted row (stable argsort)
    tok: torch.Tensor        # (P,) its token, order // k
    pos: torch.Tensor        # (P,) each pair's sorted row
    rank: torch.Tensor       # (P,) each pair's rank within its expert


def top_k_lower_first(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates per row and their indices, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """t (N, k, ...) summed over k as ``((t0 + t1) + t2) + ...`` in fp32,
    elementwise, so a row's sum never depends on the rows beside it."""
    acc = t[:, 0].float()
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j].float()
    return acc


def _rank_within_expert(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each routing pair within its expert's arrival order
    (sort-based, O(TK log TK))."""
    TK = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    first = torch.searchsorted(e_sorted, torch.arange(n_experts, dtype=e_flat.dtype,
                                                      device=e_flat.device), out_int32=True)
    rank_sorted = torch.arange(TK, dtype=torch.int32, device=e_flat.device) - \
        first[e_sorted.long()]
    return torch.zeros(TK, dtype=torch.int32, device=e_flat.device).index_copy_(
        0, order, rank_sorted)


def route_sort_plain(idx: torch.Tensor, n_experts: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The pairs of ``idx`` (T, k) sorted by expert, stably: (offsets,
    order, tok, pos, rank), all int32."""
    k = idx.shape[1]
    e_flat = idx.reshape(-1).to(torch.int32)
    P = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    offsets = torch.searchsorted(
        e_sorted, torch.arange(n_experts + 1, dtype=torch.int32, device=idx.device),
        out_int32=True)
    tok = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    pos = torch.empty(P, dtype=torch.int32, device=idx.device).index_copy_(
        0, order, torch.arange(P, dtype=torch.int32, device=idx.device))
    rank = _rank_within_expert(e_flat, n_experts)
    return offsets, order.to(torch.int32), tok, pos, rank


def route_logits_plain(logits: torch.Tensor, k: int,
                       forced: Optional[torch.Tensor] = None) -> Route:
    """The routing of router ``logits`` (T, E) fp32: softmax, the top-k (or
    the experts ``forced`` (T, k) names, at their gates), the k weights
    divided by their in-order sum (at least 1e-9), and the stable sort of
    the pairs by expert."""
    gates = torch.softmax(logits, dim=-1)
    if forced is None:
        weights, idx = top_k_lower_first(gates, k)
    else:
        idx = forced.long()
        weights = gates.gather(-1, idx)
    weights = weights / torch.clamp(_sum_in_order(weights), min=1e-9)[:, None]
    idx = idx.to(torch.int32)
    return Route(logits, gates, weights, idx, *route_sort_plain(idx, logits.shape[1]))


def moe_route_plain(x: torch.Tensor, w: torch.Tensor, k: int,
                    forced: Optional[torch.Tensor] = None) -> Route:
    """x (T, D) bf16, w (D, E) fp32 -> the layer's :class:`Route`: the fp32
    product, then :func:`route_logits_plain`."""
    return route_logits_plain(moe_router_plain(x, w), k, forced)


def moe_combine_plain(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                      kept: Optional[torch.Tensor] = None,
                      y_shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ys (P, D) bf16 in expert order, pos (P,), weights (T, k) fp32, kept
    (P,) bool or None, y_shared (T, D) or None -> (T, D) bf16: each pair's
    row (zero where dropped) times its weight cast to bf16, the k products
    summed in order in fp32, cast, then the shared expert's row added."""
    T, k = weights.shape
    picked = ys[pos.long()]                                        # back to pair order
    if kept is not None:
        picked = torch.where(kept[:, None], picked, torch.zeros((), dtype=picked.dtype,
                                                                device=picked.device))
    picked = picked * weights.reshape(-1)[:, None].to(ys.dtype)
    out = _sum_in_order(picked.reshape(T, k, -1)).to(ys.dtype)
    if y_shared is not None:
        out = out + y_shared
    return out
