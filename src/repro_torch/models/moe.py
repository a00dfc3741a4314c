"""Token-choice MoE transformer (moonshot-v1-16b-a3b, qwen3-moe-235b-a22b).

Each layer is the dense layer's attention half followed by a routed MoE
FFN in place of the MLP.  The router runs in fp32 (its product on the CUDA
cores, never TF32), softmax over the experts, top-k with ties to the lower
expert index (``jax.lax.top_k``'s order), the k weights renormalised; the
switch aux loss ``E * sum_e f_e P_e`` comes beside the output where the
caller reads it.  moonshot adds a shared SwiGLU expert, 2 x d_expert wide,
on every token (the name prefix switches it on, as in the JAX package).

The JAX package gives each expert a capacity buffer and runs every expert
over the whole buffer; drop-free routing (serving) sizes that buffer to
T * k rows, 64x the routed work at moonshot's 64 experts top-6.  Here only
the T * k routed pairs are computed, and a layer is five launches on every
path (:func:`~..kernels.moe_experts.layer_forward`):
:func:`~..kernels.moe_experts.route` (the product, softmax, top-k,
renormalisation and the stable sort of the pairs by expert, with each
expert's segment, in one launch), one row gather of the pairs' tokens,
the two launches of the grouped expert kernel (the shared expert rides in
both) and :func:`~..kernels.moe_experts.combine`.  The weighted combine
keeps the JAX package's order and types: each pair's output times its
weight cast to bf16, then the k products summed (in fp32, one rounding).
With capacity dropping (``no_drop=False``, :meth:`MoELM.apply`), a pair
whose rank within its expert reaches the capacity contributes exactly zero
(as ``picked * local`` masks it there).  Under grad (training) the layer
runs through :class:`~..kernels.moe_experts.ops.MoEFFN`: the same launches,
and a backward of hand-written kernels; every other call (serving, graphs,
decode) makes exactly the launches above.

Every per-token step of the layer is row-invariant: the router product,
the softmax and top-k, the grouped kernel and the elementwise combine
compute a token the same way whatever else shares the call, so a token's
MoE output is bitwise the same in a decode step and in a chunk.  Nothing
in the layer reads a device value on the host, so a CUDA graph can hold it.

Under a mesh (a :class:`~..dist.sharding.ShardingPolicy` installed, as
the sharded scheduler installs it) each rank holds only its
:class:`~..dist.sharding.ExpertShard`, experts ``[r E/m, (r + 1) E/m)``
of each layer on ``model`` rank ``r``, whole in D, the same on every rank
of ``data`` (``build_model(..., mesh=)`` draws each leaf and keeps the
rank's slice); the router, the shared expert and the rest of the layer are
whole on every rank.  ``moe_ffn`` then runs, over the tokens of its data
group, :func:`~..kernels.moe_experts.ops.layer_forward_shard`: every rank
of a ``model`` group routes all T tokens alike, runs the grouped kernel
on its experts' contiguous segment of the sorted pairs, combines into an
fp32 partial, and one ``all_reduce`` SUM over ``model`` precedes the one
cast and the shared expert's rows.  This is the reference's
expert-parallel ``shard_map`` body (``src/repro/models/moe.py:204-222``),
and on a mesh with ``data`` = 1 also its stationary-weights decode
(``:103-153``): in both no weight moves.  The reference picks between them
by ``DECODE_TOKEN_THRESHOLD`` (2048 tokens: below it, gathering the
experts' FSDP-split weights would dominate a decode step's collectives);
the port keeps each expert whole in D (ROADMAP 1.8c-ii), so no weight ever
moves and no threshold is needed: experts split (E % m = 0) take the
shard path whatever T, experts whole (E % m != 0) run the plain layer on
every rank with no collective.  A single shard is bitwise the plain layer;
over m shards the routed sum differs from it only by the fp32 partials'
reassociation before the one cast (one bf16 ulp at most).  Under grad on
a mesh ``moe_ffn`` raises: the reference has no sharded training.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..dist.sharding import ExpertShard, current_policy
from ..kernels.moe_experts.ops import layer_forward, layer_forward_shard, moe_layer
from ..kernels.moe_experts.ref import _rank_within_expert, top_k_lower_first  # noqa: F401
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


def switch_aux(gates: torch.Tensor, offsets: torch.Tensor, k: int) -> torch.Tensor:
    """The switch-style load-balance loss ``E * sum_e f_e P_e``: f_e each
    expert's share of the T k pairs (its segment in ``offsets``), P_e its
    mean gate."""
    T, E = gates.shape
    counts = (offsets[1:] - offsets[:-1]).float()
    return E * torch.sum(counts / (T * k) * gates.mean(dim=0))


def capacity(tokens: int, m) -> int:
    """Rows each expert keeps when routing drops (``no_drop=False``)."""
    return max(4, int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor)))


def moe_ffn(p, cfg: ArchConfig, x: torch.Tensor, *, no_drop: bool = False,
            with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``p`` a :class:`MoELayer`'s ``moe``; x (B, S, D) bf16 -> (output (B,
    S, D), aux load-balance loss, fp32 scalar, or None without
    ``with_aux``).  ``no_drop=True`` (decode, chunked and ring prefill)
    routes every pair; otherwise a pair past its expert's capacity
    contributes zero.  Under a policy whose :class:`ExpertShard` splits the
    experts, the layer must hold that shard (``build_model(..., mesh=)``):
    this rank's part of the layer and the all-reduce over ``model``."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    shared = getattr(p, "shared", None)
    experts = {k: layers.cast(w) for k, w in p.experts.items()}
    if shared is not None:
        shared = {k: layers.cast(w) for k, w in shared.items()}
    leaves = (xf, p.router["w"], *experts.values(), *(shared or {}).values())
    cap = None if no_drop else capacity(T, m)
    policy = current_policy()
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    if grad and policy is not None:
        raise NotImplementedError("moe_ffn under grad on a mesh (sharded training; the "
                                  "reference has none) is not ported, ROADMAP 1.8c")
    # a policy that places no experts (none, or one of another family) keeps every one whole
    experts_at = None if policy is None else policy.experts
    want = ExpertShard.whole(m.n_experts) if experts_at is None else experts_at
    if p.shard != want:
        raise ValueError(f"this layer holds experts {p.shard.experts()} of {m.n_experts} (rank "
                         f"{p.shard.index} of {p.shard.count} on model) but runs under "
                         f"{'no policy' if policy is None else f'a policy of {want}'}: "
                         f"serve it under its mesh's ShardingPolicy")
    if grad:
        # training: the same launches through MoEFFN, whose backward is the kernels'
        out, gates, offsets = moe_layer(cfg.mlp, xf, p.router["w"], experts, shared, m.top_k,
                                        cap)
    elif want.split:
        lo, hi = want.experts()
        out, r = layer_forward_shard(cfg.mlp, xf, p.router["w"], experts, shared, m.top_k, cap,
                                     lo, hi, lambda t: policy.all_reduce(t, "sum"))
        gates, offsets = r.gates, r.offsets
    else:
        out, r, _ = layer_forward(cfg.mlp, xf, p.router["w"], experts, shared, m.top_k, cap)
        gates, offsets = r.gates, r.offsets
    aux = switch_aux(gates, offsets, m.top_k) if with_aux else None
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_experts(gen: torch.Generator, cfg: ArchConfig,
                 shard: Optional[ExpertShard] = None) -> Dict[str, torch.Tensor]:
    """Stacked (E, ...) expert weights with the JAX package's distributions,
    each drawn in fp32 and cast to bf16 at once (one (E, D, F) fp32
    transient at a time); fp32 masters while building masters.  With a
    split ``shard`` each leaf keeps only the shard's experts, bitwise that
    slice of the whole model's at the same seed (the whole leaf is drawn,
    sliced and freed, leaf by leaf); None or a whole shard keeps every
    expert."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    lo, hi = (0, E) if shard is None else shard.experts()

    def draw(d_in, d_out):
        w = torch.randn(E, d_in, d_out, generator=gen, device=gen.device,
                        dtype=layers.PARAM_DTYPE)
        if hi - lo < E:
            w = w[lo:hi].clone()
        w.mul_(1.0 / math.sqrt(d_in))
        return w if layers.building_masters() else layers.cast(w)

    out = {"w_gate": draw(d, f)} if cfg.mlp == "swiglu" else {}
    out["w_up"] = draw(d, f)
    out["w_down"] = draw(f, d)
    return out


class MoELayer(nn.Module):
    """Parameters of one MoE decoder layer, named as in the JAX tree:
    ``attn_norm``, ``attn``, ``mlp_norm`` and ``moe`` with ``router.w``
    (D, E) fp32, ``experts.{w_gate, w_up, w_down}`` (E, ...) bf16 (this
    rank's E/m under a split ``shard``) and, for moonshot,
    ``shared.{w_gate, w_up, w_down}``; ``moe.shard`` is the
    :class:`ExpertShard` it holds (whole without one)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 shard: Optional[ExpertShard] = None):
        super().__init__()
        self.attn_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.attn = _params(_store(layers.init_attention(gen, cfg),
                                   fp32=("q_norm", "k_norm")))
        self.mlp_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.moe = nn.Module()
        self.moe.router = _params({"w": layers.dense_init(gen, cfg.d_model,
                                                          cfg.moe.n_experts)})
        self.moe.shard = shard or ExpertShard.whole(cfg.moe.n_experts)
        self.moe.experts = _params(init_experts(gen, cfg, self.moe.shard))
        if has_shared_expert(cfg):
            self.moe.shared = _params(_store(layers.init_mlp(gen, cfg,
                                                             d_ff=2 * cfg.moe.d_expert)))


def moe_residual(p: MoELayer, cfg: ArchConfig, x: torch.Tensor, *, no_drop: bool,
                 with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE half of a layer: ``(x + moe(norm(x)), aux or None)``."""
    rs = layers.bf16_scalar(cfg.residual_scale)
    h = layers.apply_norm(cfg.norm, p.mlp_norm, x)
    h, aux = moe_ffn(p.moe, cfg, h, no_drop=no_drop, with_aux=with_aux)
    return x + h * rs, aux


class MoELM(DenseLM):
    """MoE decoder LM: :class:`DenseLM` with :class:`MoELayer` layers
    (``expert_shard``: the :class:`ExpertShard` each layer holds, a split
    one under a mesh, whole without one).
    ``apply``/``loss_aux`` route with capacity dropping, as the JAX
    package's forward does; ``decode_step`` and ``prefill`` route drop-free."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 expert_shard: Optional[ExpertShard] = None):
        self.expert_shard = expert_shard or ExpertShard.whole(cfg.moe.n_experts)
        super().__init__(cfg, device=device, generator=generator)

    def _make_layer(self, cfg: ArchConfig, gen: torch.Generator) -> nn.Module:
        return MoELayer(cfg, gen, self.expert_shard)

    def _layer_decode(self, p, x: torch.Tensor, layer_cache: Dict, pos: torch.Tensor,
                      fresh: bool) -> torch.Tensor:
        x = attn_residual_decode(p, self.cfg, x, layer_cache, pos, fresh)
        return moe_residual(p, self.cfg, x, no_drop=True, with_aux=False)[0]

    def loss_aux(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of ``batch["tokens"]`` -> (logits (B, S,
        padded_vocab), the summed aux loss times ``router_aux_weight``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = layers.embed_tokens(self.embedding, cfg, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def layer(p, x, aux):
            x = attn_residual_fwd(p, cfg, x, positions)
            x, layer_aux = moe_residual(p, cfg, x, no_drop=False)
            return x, aux + layer_aux

        for p in self.layers:
            x, aux = layers.remat(cfg.remat, functools.partial(layer, p), x, aux)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        return layers.lm_head(self.embedding, cfg, x), aux * cfg.moe.router_aux_weight

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.loss_aux({"tokens": tokens})[0]

    forward = apply


__all__ = ["FP32_PATHS", "MoELM", "MoELayer", "capacity", "has_shared_expert", "moe_ffn",
           "switch_aux", "top_k_lower_first"]
