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

The backward's plain versions (the kernels of ``moe_backward.cu``) are
written as formulas, not as autograd of the forward:
:func:`moe_combine_backward_plain`, :func:`moe_gather_backward_plain` (the
row gather's, which the forward combine kernel computes with unit
weights), the grouped data gradients :func:`moe_down_grad_plain` and
:func:`moe_up_grad_plain`, the weight gradient
:func:`moe_weight_grad_plain`, all of them composed by
:func:`moe_experts_backward_plain`, and :func:`moe_route_backward_plain`.

On the CPU every product is an fp32 multiply-and-sum per row
(:func:`row_products`), so a row's result does not depend on how many rows
share the call: the CPU's matmul picks its blocking by row count, and the
port's decode == chunked-prefill tests hold the MoE layer bitwise.  On the
card the plain version is a ``torch.matmul`` per segment (the kernel is
held to it within a tolerance there, never bitwise).  Every function keeps
float64 inputs in float64 (the gradient checks); bf16 and fp32 compute in
fp32 and round where the kernels round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

MODES = ("swiglu", "gelu", "plain")     # index = the C interface's mode code


def compute_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """fp32 for bf16 and fp32 operands, float64 for float64 ones."""
    out = torch.float32
    for d in dtypes:
        out = torch.promote_types(out, d)
    return out


def row_products(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x (M, K) . w (K, N) with fp32 accumulation (float64 for float64
    operands), in ``out_dtype``.  On the CPU each row is its own
    multiply-and-sum (the (M, K, N) products are made: small sizes only);
    on the card a matmul."""
    if x.device.type == "cpu":
        ft = compute_dtype(x.dtype, w.dtype)
        return (x.to(ft).unsqueeze(-1) * w.to(ft)).sum(-2).to(out_dtype)
    if x.dtype == torch.float32:
        return (x @ w).to(out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)


def _ffn_plain(mode: str, x: torch.Tensor, w1: torch.Tensor, w2: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(out, a = x.W1, b = x.W2 or None), each product rounded to x's dtype."""
    a = row_products(x, w1, x.dtype)
    if mode == "swiglu":
        b = row_products(x, w2, x.dtype)
        return F.silu(a) * b, a, b
    if mode == "gelu":
        return F.gelu(a, approximate="tanh"), a, None
    return a, a, None


def _segments(offsets: torch.Tensor, n_exp: int):
    bounds = [int(v) for v in offsets.tolist()]
    return [(e, bounds[e], bounds[e + 1]) for e in range(n_exp)]


def moe_experts_plain(mode: str, x: torch.Tensor, offsets: torch.Tensor, w1: torch.Tensor,
                      w2: Optional[torch.Tensor] = None,
                      shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             Optional[torch.Tensor]]] = None,
                      pre: Optional[Sequence[Optional[torch.Tensor]]] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mode`` in MODES; x (P, K) bf16 in expert order; offsets (E + 1,)
    int; w1, w2 (E, K, N) -> (out (P, N), shared out or None).  ``shared``
    is ``(x_s (R, K_s), w1_s (K_s, N_s), w2_s)``: one more expert over all
    of ``x_s``'s rows.  ``pre`` = ``(a, b, a_s, b_s)``, tensors (or None)
    of the outputs' shapes, takes the pre-activations x.W1 and x.W2 of a
    gate/up launch (the backward reads them)."""
    out = x.new_empty((x.shape[0], w1.shape[-1]))
    pa, pb, pa_s, pb_s = pre if pre is not None else (None,) * 4
    for e, lo, hi in _segments(offsets, w1.shape[0]):
        if hi > lo:
            out[lo:hi], a, b = _ffn_plain(mode, x[lo:hi], w1[e], None if w2 is None else w2[e])
            if pa is not None:
                pa[lo:hi] = a
            if pb is not None:
                pb[lo:hi] = b
    out_s = None
    if shared is not None:
        xs, w1s, w2s = shared
        out_s, a, b = _ffn_plain(mode, xs, w1s, w2s)
        if pa_s is not None:
            pa_s.copy_(a)
        if pb_s is not None:
            pb_s.copy_(b)
    return out, out_s


def moe_router_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, D) bf16, w (D, E) fp32 -> logits (T, E) fp32, the product in
    full fp32 (no TF32; float64 x stays float64)."""
    ft = compute_dtype(x.dtype)
    return row_products(x.to(ft), w.to(ft), ft)


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
    ft = compute_dtype(t.dtype)
    acc = t[:, 0].to(ft)
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j].to(ft)
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


def moe_combine_partial_plain(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                              kept: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combine's fp32 sum before its cast: ys (P, D) bf16 in expert
    order, pos (P,), weights (T, k) fp32, kept (P,) bool or None -> (T, D)
    fp32, each pair's row (zero where dropped) times its weight cast to
    bf16, the k products summed in order in fp32; no shared row.  Cast to
    bf16 it is :func:`moe_combine_plain` without ``y_shared``, bitwise.  A
    pair whose ``kept`` is False is never read (its row may be garbage)."""
    T, k = weights.shape
    picked = ys[pos.long()]                                        # back to pair order
    if kept is not None:
        picked = torch.where(kept[:, None], picked, torch.zeros((), dtype=picked.dtype,
                                                                device=picked.device))
    picked = picked * weights.reshape(-1)[:, None].to(ys.dtype)
    return _sum_in_order(picked.reshape(T, k, -1))


def moe_combine_plain(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                      kept: Optional[torch.Tensor] = None,
                      y_shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ys (P, D) bf16 in expert order, pos (P,), weights (T, k) fp32, kept
    (P,) bool or None, y_shared (T, D) or None -> (T, D) bf16: each pair's
    row (zero where dropped) times its weight cast to bf16, the k products
    summed in order in fp32, cast, then the shared expert's row added."""
    out = moe_combine_partial_plain(ys, pos, weights, kept).to(ys.dtype)
    if y_shared is not None:
        out = out + y_shared
    return out


def shard_kept(idx: torch.Tensor, lo: int, hi: int, rank: Optional[torch.Tensor] = None,
               cap: Optional[int] = None) -> torch.Tensor:
    """(T k,) bool in pair order: the pairs of ``idx`` (T, k) routed to an
    expert in ``[lo, hi)`` (and, with ``cap``, of ``rank`` within it below
    the capacity)."""
    e = idx.reshape(-1)
    kept = (e >= lo) & (e < hi)
    return kept if cap is None else kept & (rank < cap)


def moe_shard_partial_plain(mlp: str, x: torch.Tensor, r: Route, experts, lo: int, hi: int,
                            cap: Optional[int] = None) -> torch.Tensor:
    """One expert shard's part of a layer's routed sum: the pairs of route
    ``r`` on experts ``[lo, hi)`` (``experts``: that shard's (hi - lo, ·,
    ·) weights) through their FFN, at their sorted rows (their contiguous
    segment ``[offsets[lo], offsets[hi])``), combined into an fp32 (T, D)
    partial with every other pair contributing exactly zero."""
    xs = x[r.tok.long()]
    offs = r.offsets[lo:hi + 1]
    if mlp == "swiglu":
        ys, _ = moe_experts_plain("swiglu", xs, offs, experts["w_gate"], experts["w_up"])
    else:
        ys, _ = moe_experts_plain("gelu", xs, offs, experts["w_up"])
    ys, _ = moe_experts_plain("plain", ys, offs, experts["w_down"])
    return moe_combine_partial_plain(ys, r.pos, r.weights, shard_kept(r.idx, lo, hi, r.rank, cap))


def moe_shards_plain(mlp: str, x: torch.Tensor, w_router: torch.Tensor, experts, shared,
                     k: int, m: int, cap: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Route]:
    """A layer's routed FFN split over ``m`` expert shards, in one process:
    the route once, each shard's :func:`moe_shard_partial_plain` over its
    E/m experts (``experts`` whole), the partials summed in shard order in
    fp32 (the all-reduce over ``model``), cast to bf16, then the shared
    expert's rows added.  Returns (out (T, D), the routed sum in bf16
    before the shared rows, the route)."""
    r = moe_route_plain(x, w_router, k)
    E = w_router.shape[1]
    if E % m:
        raise ValueError(f"{E} experts do not split over {m} shards")
    w = E // m
    total = None
    for s in range(m):
        part = moe_shard_partial_plain(mlp, x, r, {n: t[s * w:(s + 1) * w]
                                                   for n, t in experts.items()},
                                       s * w, (s + 1) * w, cap)
        total = part if total is None else total + part
    routed = total.to(x.dtype)
    out = routed
    if shared is not None:
        y_s, _, _ = _ffn_plain("swiglu", x, shared["w_gate"], shared["w_up"])
        y_s = row_products(y_s, shared["w_down"], x.dtype)
        out = routed + y_s
    return out, routed, r


# ---------------------------------------------------------------------------
# The backward (moe_backward.cu's kernels)
# ---------------------------------------------------------------------------

DOT_LANES, DOT_CHUNK = 32, 8     # the combine backward's dot product: lanes, columns a chunk


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dot products of a, b (N, D) in the combine backward kernel's
    order: lane l (of 32) sums the products of its 8-column chunks l, l +
    32, ... in order, column by column within a chunk, from 0; then the
    lanes' sums meet by an xor butterfly (16, 8, 4, 2, 1).  Each product
    is formed in the compute dtype (exact for two bf16 values in fp32)."""
    ft = compute_dtype(a.dtype, b.dtype)
    N, D = a.shape
    span = DOT_LANES * DOT_CHUNK
    nc = -(-D // span)
    prods = F.pad(a.to(ft) * b.to(ft), (0, nc * span - D))
    prods = prods.reshape(N, nc, DOT_LANES, DOT_CHUNK)
    acc = torch.zeros(N, DOT_LANES, dtype=ft, device=a.device)
    for i in range(nc):
        for j in range(DOT_CHUNK):
            acc = acc + prods[:, i, :, j]
    lanes = torch.arange(DOT_LANES, device=a.device)
    for m in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ m]
    return acc[:, 0]


def moe_combine_backward_plain(dout: torch.Tensor, ys: torch.Tensor, pos: torch.Tensor,
                               weights: torch.Tensor, kept: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`moe_combine_plain` at its output's gradient
    ``dout`` (T, D): (dys (P, D) in ys's dtype, in sorted order, dweights
    (T, k) in weights' dtype).  Pair p = t k + j at sorted row pos[p]:
    ``dys[pos[p]] = kept ? dout[t] * w[p]`` (w cast to ys's dtype, one
    product and one rounding) ``: 0``, and ``dweights[t, j] = kept ? sum_d
    dout[t, d] ys[pos[p], d] : 0``, summed by :func:`lane_dot` (the
    kernel's order).  The shared expert's gradient is dout itself.  The
    roundings of the forward (the weight's cast, each product, the sum)
    pass the gradient straight through, as autograd does."""
    T, k = weights.shape
    tok = torch.arange(T, device=ys.device).repeat_interleave(k)
    g = dout[tok]
    rows = ys[pos.long()]
    d = g * weights.reshape(-1, 1).to(ys.dtype)
    dw = lane_dot(g, rows)
    if kept is not None:
        d = torch.where(kept[:, None], d, torch.zeros((), dtype=d.dtype, device=d.device))
        dw = torch.where(kept, dw, torch.zeros((), dtype=dw.dtype, device=dw.device))
    dys = torch.empty_like(ys)
    dys[pos.long()] = d
    return dys, dw.reshape(T, k).to(weights.dtype)


def moe_gather_backward_plain(dxs: torch.Tensor, pos: torch.Tensor, k: int,
                              dx_shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward of the row gather ``xs = x[tok]`` (the pairs' token rows
    in sorted order): ``dx[t] = sum_j dxs[pos[t k + j]]`` over j in order in
    fp32, rounded once, then ``dx_shared[t]`` added (the shared expert's
    share).  It is :func:`moe_combine_plain` with unit weights, and on the
    card the forward combine kernel computes it."""
    T = pos.shape[0] // k
    ones = torch.ones(T, k, dtype=compute_dtype(dxs.dtype), device=dxs.device)
    return moe_combine_plain(dxs, pos, ones, None, dx_shared)


def _silu_grad(a: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(a)
    return s * (1 + a * (1 - s))


def _gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    beta, kappa = 0.7978845608028654, 0.044715
    th = torch.tanh(beta * (a + kappa * a * a * a))
    return 0.5 * (1 + th) + 0.5 * a * (1 - th * th) * beta * (1 + 3 * kappa * a * a)


def activation_backward(mode: str, dh: torch.Tensor, a: torch.Tensor,
                        b: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gate/up epilogue's backward at h's gradient ``dh`` (rounded to
    a's dtype, as the forward rounds each product), with the forward's
    roundings: SwiGLU ``h = silu(a)_r * b``: ``da = (dh b)_r silu'(a)``,
    ``db = dh silu(a)_r``; GELU ``da = dh gelu_tanh'(a)``; each result
    rounded once to a's dtype (the products in fp32, float64 stays)."""
    ft = compute_dtype(a.dtype)
    af, dhf = a.to(ft), dh.to(a.dtype).to(ft)
    if mode == "swiglu":
        silu = F.silu(a).to(ft)
        dg = (dhf * b.to(ft)).to(a.dtype).to(ft)
        return (dg * _silu_grad(af)).to(a.dtype), (dhf * silu).to(a.dtype)
    if mode == "gelu":
        return (dhf * _gelu_tanh_grad(af)).to(a.dtype), None
    raise ValueError(f"activation_backward takes swiglu or gelu, got {mode!r}")


def moe_down_grad_plain(mode: str, dy: torch.Tensor, offsets: torch.Tensor,
                        w_down: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                        shared: Optional[Tuple] = None):
    """The down launch's data gradient with the activation's backward, per
    segment: ``dh = dy . W_d[e]^T`` (dy (P, D), W_d (E, F, D); fp32
    accumulation, rounded), then :func:`activation_backward` with the
    forward's pre-activations a, b (P, F).  ``shared = (dy_s (R, D), W_d_s
    (F_s, D), a_s, b_s)``.  Returns ``(da, db or None, (da_s, db_s) or
    None)``."""
    da = torch.zeros_like(a)
    db = None if b is None else torch.zeros_like(b)
    for e, lo, hi in _segments(offsets, w_down.shape[0]):
        if hi > lo:
            dh = row_products(dy[lo:hi], w_down[e].t(), a.dtype)
            da[lo:hi], db_e = activation_backward(mode, dh, a[lo:hi],
                                                  None if b is None else b[lo:hi])
            if db is not None:
                db[lo:hi] = db_e
    out_s = None
    if shared is not None:
        dy_s, w_s, a_s, b_s = shared
        out_s = activation_backward(mode, row_products(dy_s, w_s.t(), a_s.dtype), a_s, b_s)
    return da, db, out_s


def _up_products(da, db, w1, w2):
    if db is None:
        return row_products(da, w1.t(), da.dtype)
    return row_products(torch.cat([da, db], -1), torch.cat([w1, w2], -1).t(), da.dtype)


def moe_up_grad_plain(da: torch.Tensor, db: Optional[torch.Tensor], offsets: torch.Tensor,
                      w1: torch.Tensor, w2: Optional[torch.Tensor] = None,
                      shared: Optional[Tuple] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gate/up launch's data gradient, per segment: ``dx = da . W1[e]^T
    + db . W2[e]^T`` (da, db (P, F); W1, W2 (E, D, F)), both products in
    one fp32 accumulation, rounded once (GELU: da . W_up^T alone).
    ``shared = (da_s, db_s, W1_s (D, F_s), W2_s)``.  Returns (dx (P, D),
    dx_s or None)."""
    dx = da.new_zeros((da.shape[0], w1.shape[1]))
    for e, lo, hi in _segments(offsets, w1.shape[0]):
        if hi > lo:
            dx[lo:hi] = _up_products(da[lo:hi], None if db is None else db[lo:hi], w1[e],
                                     None if w2 is None else w2[e])
    dx_s = None
    if shared is not None:
        dx_s = _up_products(*shared)
    return dx, dx_s


def moe_weight_grad_plain(a: torch.Tensor, b: torch.Tensor,
                          offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = a[seg e]^T . b[seg e]`` (a (rows, M), b (rows, N)): each
    expert's rows summed in fp32, rounded once to a's dtype; an empty
    segment gives zeros.  Without offsets: one expert over all rows, out
    (M, N)."""
    if offsets is None:
        return row_products(a.t(), b, a.dtype)
    E = offsets.shape[0] - 1
    out = a.new_zeros((E, a.shape[1], b.shape[1]))
    for e, lo, hi in _segments(offsets, E):
        if hi > lo:
            out[e] = row_products(a[lo:hi].t(), b[lo:hi], a.dtype)
    return out


class ExpertGrads(NamedTuple):
    """The expert layer's gradients: the routed rows' (dx (P, D), in
    sorted order) and every weight's, the shared expert's where it rides."""
    dx: torch.Tensor
    dw1: torch.Tensor                   # w_gate (SwiGLU) or w_up (GELU)
    dw2: Optional[torch.Tensor]         # w_up (SwiGLU)
    dw_down: torch.Tensor
    shared: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def moe_experts_backward_plain(mode: str, x: torch.Tensor, offsets: torch.Tensor,
                               w1: torch.Tensor, w2: Optional[torch.Tensor], a: torch.Tensor,
                               b: Optional[torch.Tensor], dy_down: torch.Tensor,
                               w_down: torch.Tensor, h: torch.Tensor,
                               shared: Optional[Tuple] = None) -> ExpertGrads:
    """The backward of the two expert launches (gate/up with ``mode``'s
    epilogue, then down), per segment (host offsets).  x (P, D) the
    gathered rows, a and b (P, F) the gate/up pre-activations, h (P, F) the
    down launch's input, dy_down (P, D) its output's gradient:

    * ``dh = dy . W_d^T``, then :func:`activation_backward` (da, db);
    * ``dx = da . W_g^T + db . W_u^T``;
    * ``dW_d[e] = h[seg]^T dy[seg]``, ``dW_g[e] = x[seg]^T da[seg]``,
      ``dW_u[e] = x[seg]^T db[seg]``, zero for a segment of no rows.

    ``shared = (x_s, w1_s, w2_s, a_s, b_s, dy_s, w_down_s, h_s)``: the
    same over all of x_s's rows; its grads come back as ``(dx_s, dw1_s,
    dw2_s, dw_down_s)``."""
    sh_down = sh_up = None
    if shared is not None:
        x_s, w1_s, w2_s, a_s, b_s, dy_s, wd_s, h_s = shared
        sh_down = (dy_s, wd_s, a_s, b_s)
    da, db, d_s = moe_down_grad_plain(mode, dy_down, offsets, w_down, a, b, sh_down)
    dw_down = moe_weight_grad_plain(h, dy_down, offsets)
    dw1 = moe_weight_grad_plain(x, da, offsets)
    dw2 = None if db is None else moe_weight_grad_plain(x, db, offsets)
    if shared is not None:
        sh_up = (d_s[0], d_s[1], w1_s, w2_s)
    dx, dx_s = moe_up_grad_plain(da, db, offsets, w1, w2, sh_up)
    grads_s = None
    if shared is not None:
        grads_s = (dx_s, moe_weight_grad_plain(x_s, d_s[0]),
                   None if d_s[1] is None else moe_weight_grad_plain(x_s, d_s[1]),
                   moe_weight_grad_plain(h_s, dy_s))
    return ExpertGrads(dx, dw1, dw2, dw_down, grads_s)


def moe_route_backward_plain(x: torch.Tensor, w: torch.Tensor, gates: torch.Tensor,
                             weights: torch.Tensor, idx: torch.Tensor, dweights: torch.Tensor,
                             dgates: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`moe_route_plain` at the gradients of the
    renormalised weights (T, k) and of the gates (T, E) (or None): (dx (T,
    D) in x's dtype, dw (D, E) in w's).  Per token:

    1. the renormalisation's adjoint: with ``s = sum_j v_j`` (the k chosen
       gates, in order) and ``den = max(s, 1e-9)``, ``dv_j = (dweights_j -
       [s >= 1e-9] sum_i dweights_i weights_i) / den``;
    2. ``dg = dgates``, plus dv_j at expert idx_j (j in order);
    3. the softmax's adjoint ``dlogits = g (dg - sum_e g dg)``;
    4. ``dx = dlogits . w^T`` in fp32 (no TF32), cast to x's dtype (as the
       JAX package's ``astype(float32)`` hands the gradient back), and
       ``dw = x^T . dlogits`` in fp32.

    The top-k's choice and the sort carry no gradient."""
    ft = compute_dtype(gates.dtype, w.dtype)
    g = gates.to(ft)
    il = idx.long()
    v = g.gather(1, il)
    s = _sum_in_order(v)
    den = torch.clamp(s, min=1e-9)
    dwf, wf = dweights.to(ft), weights.to(ft)
    dot = torch.where(s >= 1e-9, _sum_in_order(dwf * wf), torch.zeros((), dtype=ft,
                                                                        device=g.device))
    dv = (dwf - dot[:, None]) / den[:, None]
    dg = torch.zeros_like(g) if dgates is None else dgates.to(ft).clone()
    rows = torch.arange(g.shape[0], device=g.device)
    for j in range(il.shape[1]):
        dg[rows, il[:, j]] += dv[:, j]
    dlogits = g * (dg - (g * dg).sum(-1, keepdim=True))
    wt = w.to(ft)
    dx = row_products(dlogits, wt.t(), ft).to(x.dtype)
    dw = row_products(x.to(ft).t(), dlogits, ft).to(w.dtype)
    return dx, dw
