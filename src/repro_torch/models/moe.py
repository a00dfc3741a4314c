"""Token-choice MoE transformer (moonshot-v1-16b-a3b, qwen3-moe-235b-a22b).

Each layer is the dense layer's attention half followed by a routed MoE
FFN in place of the MLP.  The router runs in fp32 (its product in the
fp32 router kernel, never TF32), softmax over the experts, top-k with ties
to the lower expert index (``jax.lax.top_k``'s order), the k weights
renormalised; the switch aux loss ``E * sum_e f_e P_e`` comes beside the
output.  moonshot adds a shared SwiGLU expert, 2 x d_expert wide, on every
token (the name prefix switches it on, as in the JAX package).

The JAX package gives each expert a capacity buffer and runs every expert
over the whole buffer; drop-free routing (serving) sizes that buffer to
T * k rows, 64x the routed work at moonshot's 64 experts top-6.  Here only
the T * k routed pairs are computed: they are sorted by expert (a stable
argsort), each expert's segment found by ``searchsorted``, the rows
gathered, and the experts (and the shared expert) run in two launches of
the grouped expert kernel (``kernels/moe_experts``).  The weighted combine
keeps the JAX package's order and types: each pair's output times its
weight cast to bf16, then the k products summed (in fp32, one rounding).
With capacity dropping (``no_drop=False``, :meth:`MoELM.apply`), a pair
whose rank within its expert reaches the capacity contributes exactly zero
(``torch.where``, as ``picked * local`` masks it there).

Every step of the layer is row-invariant: the router kernel, the grouped
kernel, softmax, a sort per row, the gathers and the elementwise combine
compute a token the same way whatever else shares the call, so a token's
MoE output is bitwise the same in a decode step and in a chunk.  Nothing
in the layer reads a device value on the host, so a CUDA graph can hold it.

Not ported: the mesh paths (expert-parallel ``shard_map`` and the
stationary-weights decode); ``moe_ffn(mesh=...)`` raises.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..kernels.moe_experts import expert_ffn, router_logits
from . import layers
from .config import ArchConfig
from .transformer import (DenseLM, _params, _store, attn_residual_decode,
                          attn_residual_fwd)

# leaves the router computes with in fp32, stored fp32 (a bf16 router moves
# logits by an ulp, and an ulp flips routes)
FP32_PATHS = frozenset({("moe", "router", "w")})


def has_shared_expert(cfg: ArchConfig) -> bool:
    """moonlight/deepseek-style shared expert beside the routed ones."""
    return cfg.d_ff > 0 and cfg.name.startswith("moonshot")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


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


def capacity(tokens: int, m) -> int:
    """Rows each expert keeps when routing drops (``no_drop=False``)."""
    return max(4, int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor)))


def moe_ffn(p, cfg: ArchConfig, x: torch.Tensor, *, no_drop: bool = False,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``p`` a :class:`MoELayer`'s ``moe``; x (B, S, D) bf16 -> (output (B,
    S, D), aux load-balance loss, fp32 scalar).  ``no_drop=True`` (decode,
    chunked and ring prefill) routes every pair; otherwise a pair past its
    expert's capacity contributes zero."""
    if mesh is not None:
        raise NotImplementedError("moe_ffn over a mesh (expert-parallel shard_map and "
                                  "stationary-weights decode) is not ported yet")
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xf = x.reshape(T, D)

    logits = router_logits(xf, p.router["w"])                      # (T, E) fp32
    gates = torch.softmax(logits, dim=-1)
    weights, idx = top_k_lower_first(gates, k)                      # (T, k)
    weights = weights / torch.clamp(_sum_in_order(weights), min=1e-9)[:, None]

    # switch-style load-balance aux: E * sum_e f_e * P_e
    pe = gates.mean(dim=0)
    e_flat = idx.reshape(-1).to(torch.int32)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, e_flat.long(), torch.ones(T * k, dtype=torch.float32, device=x.device))
    aux = E * torch.sum(counts / (T * k) * pe)

    # the pairs in expert order and each expert's segment
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    offsets = torch.searchsorted(
        e_sorted, torch.arange(E + 1, dtype=torch.int32, device=x.device), out_int32=True)
    tok = torch.div(order, k, rounding_mode="floor")
    shared = getattr(p, "shared", None)
    ys, y_shared = expert_ffn(cfg.mlp, xf[tok], offsets, p.experts,
                              None if shared is None else (xf, shared))
    picked = torch.empty_like(ys).index_copy_(0, order, ys)        # back to pair order
    if not no_drop:
        kept = _rank_within_expert(e_flat, E) < capacity(T, m)
        picked = torch.where(kept[:, None], picked, torch.zeros((), dtype=picked.dtype,
                                                                device=x.device))
    picked = picked * weights.reshape(-1)[:, None].to(x.dtype)
    out = _sum_in_order(picked.reshape(T, k, D)).to(x.dtype)
    if y_shared is not None:
        out = out + y_shared
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_experts(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Stacked (E, ...) expert weights with the JAX package's distributions,
    each drawn in fp32 and cast to bf16 at once (one (E, D, F) fp32
    transient at a time)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts

    def draw(d_in, d_out):
        w = torch.randn(E, d_in, d_out, generator=gen, device=gen.device,
                        dtype=layers.PARAM_DTYPE)
        return layers.cast(w.mul_(1.0 / math.sqrt(d_in)))

    out = {"w_gate": draw(d, f)} if cfg.mlp == "swiglu" else {}
    out["w_up"] = draw(d, f)
    out["w_down"] = draw(f, d)
    return out


class MoELayer(nn.Module):
    """Parameters of one MoE decoder layer, named as in the JAX tree:
    ``attn_norm``, ``attn``, ``mlp_norm`` and ``moe`` with ``router.w``
    (D, E) fp32, ``experts.{w_gate, w_up, w_down}`` (E, ...) bf16 and, for
    moonshot, ``shared.{w_gate, w_up, w_down}``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.attn_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.attn = _params(_store(layers.init_attention(gen, cfg),
                                   fp32=("q_norm", "k_norm")))
        self.mlp_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.moe = nn.Module()
        self.moe.router = _params({"w": layers.dense_init(gen, cfg.d_model,
                                                          cfg.moe.n_experts)})
        self.moe.experts = _params(init_experts(gen, cfg))
        if has_shared_expert(cfg):
            self.moe.shared = _params(_store(layers.init_mlp(gen, cfg,
                                                             d_ff=2 * cfg.moe.d_expert)))


def moe_residual(p: MoELayer, cfg: ArchConfig, x: torch.Tensor, *, no_drop: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE half of a layer: ``(x + moe(norm(x)), aux)``."""
    rs = layers.bf16_scalar(cfg.residual_scale)
    h = layers.apply_norm(cfg.norm, p.mlp_norm, x)
    h, aux = moe_ffn(p.moe, cfg, h, no_drop=no_drop)
    return x + h * rs, aux


class MoELM(DenseLM):
    """MoE decoder LM: :class:`DenseLM` with :class:`MoELayer` layers.
    ``apply``/``loss_aux`` route with capacity dropping, as the JAX
    package's forward does; ``decode_step`` and ``prefill`` route drop-free."""

    def _make_layer(self, cfg: ArchConfig, gen: torch.Generator) -> nn.Module:
        return MoELayer(cfg, gen)

    def _layer_decode(self, p, x: torch.Tensor, layer_cache: Dict, pos: torch.Tensor,
                      fresh: bool) -> torch.Tensor:
        x = attn_residual_decode(p, self.cfg, x, layer_cache, pos, fresh)
        return moe_residual(p, self.cfg, x, no_drop=True)[0]

    def loss_aux(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits (B, S, padded_vocab), the summed
        aux loss times ``router_aux_weight``)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = layers.embed_tokens(self.embedding, cfg, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in self.layers:
            x = attn_residual_fwd(p, cfg, x, positions)
            x, layer_aux = moe_residual(p, cfg, x, no_drop=False)
            aux = aux + layer_aux
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        return layers.lm_head(self.embedding, cfg, x), aux * cfg.moe.router_aux_weight

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.loss_aux(tokens)[0]

    forward = apply


__all__ = ["FP32_PATHS", "MoELM", "MoELayer", "capacity", "has_shared_expert", "moe_ffn",
           "top_k_lower_first"]
