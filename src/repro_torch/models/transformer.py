"""Dense decoder-only transformer (starcoder2 / qwen3 / qwen1.5 / minicpm).

:class:`DenseLM` is an ``nn.Module`` holding one :class:`DenseLayer` of
parameters per layer (the JAX package stacks them and scans); the layer
math is the plain functions below, driven by ``DenseLM.cfg`` — so a
shallow copy of the model with another ``cfg`` (another ``attn_backend``)
shares the weights and switches the decode dispatch.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import kvcache, layers
from .config import ArchConfig


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _leaf(v) for k, v in tree.items()})


def _leaf(t: torch.Tensor) -> nn.Parameter:
    """A parameter: trainable while building masters, frozen otherwise."""
    return nn.Parameter(t, requires_grad=layers.building_masters())


def _store(tree: Dict[str, torch.Tensor], fp32: tuple = ()) -> Dict[str, torch.Tensor]:
    """Storage dtype of each leaf: bf16 (the value every use casts to)
    except the ``fp32`` names, which are computed with in fp32; every leaf
    stays an fp32 master while building masters."""
    if layers.building_masters():
        return dict(tree)
    return {k: v if k in fp32 else layers.cast(v) for k, v in tree.items()}


class DenseLayer(nn.Module):
    """Parameters of one decoder layer, named as in the JAX parameter tree."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.attn_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.attn = _params(_store(layers.init_attention(gen, cfg),
                                   fp32=("q_norm", "k_norm")))
        self.mlp_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.mlp = _params(_store(layers.init_mlp(gen, cfg)))


def attn_residual_fwd(p, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """The attention half of a full-sequence layer: ``x + attn(norm(x))``."""
    rs = layers.bf16_scalar(cfg.residual_scale)
    h = layers.apply_norm(cfg.norm, p.attn_norm, x)
    h = layers.attention_block(p.attn, cfg, h, positions, window=cfg.sliding_window)
    return x + h * rs


def mlp_residual(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP half of a dense layer: ``x + mlp(norm(x))``."""
    rs = layers.bf16_scalar(cfg.residual_scale)
    h = layers.apply_norm(cfg.norm, p.mlp_norm, x)
    h = layers.apply_mlp(p.mlp, cfg, h)
    return x + h * rs


def dense_layer_fwd(p: DenseLayer, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    return mlp_residual(p, cfg, attn_residual_fwd(p, cfg, x, positions))


def dense_layer_decode(p: DenseLayer, cfg: ArchConfig, x: torch.Tensor,
                       layer_cache: Dict, pos: torch.Tensor, fresh: bool = False
                       ) -> torch.Tensor:
    """One-token (or short-S) step against one layer of a ring or paged
    cache, written in place.  ``pos`` scalar (lockstep batch) or (B,);
    ``fresh``: the cache was empty, so ``x`` is a sequence from position 0."""
    return mlp_residual(p, cfg, attn_residual_decode(p, cfg, x, layer_cache, pos, fresh))


def attn_residual_decode(p, cfg: ArchConfig, x: torch.Tensor, layer_cache: Dict,
                         pos: torch.Tensor, fresh: bool = False) -> torch.Tensor:
    """The attention half of :func:`dense_layer_decode`: ``x + attn(norm(x))``
    against the layer's cache, whose K/V it writes in place."""
    rs = layers.bf16_scalar(cfg.residual_scale)
    B, S = x.shape[0], x.shape[1]
    positions = kvcache.decode_positions(pos, B, S)
    h = layers.apply_norm(cfg.norm, p.attn_norm, x)
    q, k, v = layers.qkv_project(p.attn, cfg, h, positions)
    kvcache.cache_update_layer(layer_cache, k, v, pos)
    if S > kvcache.cache_capacity(layer_cache) or layers.takes_flash(S, fresh):
        # a from-scratch prefill attends its fresh full-sequence k/v (the
        # values the cache now holds): the ring keeps only the trailing
        # window when S exceeds it, and a long one runs in the flash kernel
        o = layers.sdpa(q, k, v, causal=True, window=cfg.sliding_window,
                        q_positions=positions, kv_positions=positions, aligned=fresh)
    elif S == 1 and cfg.attn_backend == "paged_kernel" and kvcache.is_paged(layer_cache):
        # stream the slot's pages through the CUDA kernel (pre-update pool +
        # fp32 new-token append); the gathered view never materializes
        o = kvcache.paged_attn_decode(layer_cache, q, pos, window=cfg.sliding_window,
                                      k_new=k, v_new=v)
    else:
        # S=1 decode is the chunk path at S=1: attend the post-update view,
        # so a decode step computes bit-identically to a prefill chunk
        # covering the same token (over a split pool, assembled across ranks)
        o = kvcache.attend_cache(layer_cache, q, positions, pos + S, window=cfg.sliding_window)
    o = o.reshape(B, S, cfg.n_heads * cfg.the_head_dim())
    return x + (o @ layers.cast(p.attn["wo"])) * rs


class DenseLM(nn.Module):
    """Dense decoder LM.  Parameters are drawn from ``generator`` (default:
    seed 0 on ``device``) with the JAX package's distributions; load other
    weights with ``load_state_dict`` (see :mod:`repro_torch.weights`)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, model on {device}")
        self.embedding = _params(_store(layers.init_embedding(generator, cfg)))
        self.layers = nn.ModuleList(self._make_layer(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, device)))

    def _make_layer(self, cfg: ArchConfig, gen: torch.Generator) -> nn.Module:
        return DenseLayer(cfg, gen)

    def _layer_decode(self, p, x: torch.Tensor, layer_cache: Dict, pos: torch.Tensor,
                      fresh: bool) -> torch.Tensor:
        return dense_layer_decode(p, self.cfg, x, layer_cache, pos, fresh)

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, padded_vocab)."""
        x = self._forward(layers.embed_tokens(self.embedding, self.cfg, tokens))
        return layers.lm_head(self.embedding, self.cfg, x)

    def loss_aux(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """A training batch (``tokens``, and ``frames`` or ``patch_embeds``
        where the family takes them) -> (logits, auxiliary loss): the JAX
        models' hook, a zero aux outside MoE."""
        logits = self.apply(batch["tokens"])
        return logits, logits.new_zeros((), dtype=torch.float32)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The layer stack and the final norm over embeddings (B, S, d)
        from position 0, each layer rematerialized as ``cfg.remat`` says."""
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        for p in self.layers:
            x = layers.remat(self.cfg.remat, functools.partial(dense_layer_fwd, p, self.cfg),
                             x, positions)
        return layers.apply_norm(self.cfg.norm, self.final_norm, x)

    forward = apply

    # -- decode ------------------------------------------------------------------

    @property
    def n_kv_layers(self) -> int:
        """Layers that keep K/V (all of them)."""
        return self.cfg.n_layers

    def cache_len(self, seq_len: int) -> int:
        w = self.cfg.sliding_window
        return min(seq_len, w) if w else seq_len

    def recurrent_rows(self, B: int) -> Dict[str, torch.Tensor]:
        """Per-slot recurrent state beside the K/V: none in a dense model."""
        return {}

    def init_cache(self, B: int, seq_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        return kvcache.init_attn_cache(cfg.n_layers, B, self.cache_len(seq_len),
                                       cfg.n_kv_heads, cfg.the_head_dim(), self.device)

    def decode_step(self, cache: Dict, tokens: torch.Tensor, *, fresh: bool = False
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S_new) — one (or a few) new tokens per sequence.
        KV is written into ``cache`` in place; the returned cache shares its
        tensors and carries the advanced ``length``.  ``fresh``: the cache
        is empty (a from-scratch prefill)."""
        cfg = self.cfg
        x = self._decode_layers(cache, layers.embed_tokens(self.embedding, cfg, tokens), fresh)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        logits = layers.lm_head(self.embedding, cfg, x)
        new_cache = dict(cache)
        new_cache["length"] = cache["length"] + tokens.shape[1]
        return logits, new_cache

    def _decode_layers(self, cache: Dict, x: torch.Tensor, fresh: bool) -> torch.Tensor:
        """The layer stack of a decode step over embeddings ``x`` (B, S, d)
        at ``cache["length"]``, each layer's K/V written in place."""
        pos = cache["length"]
        paged = kvcache.is_paged(cache)
        for i, p in enumerate(self.layers):
            if paged:
                lc = {"kp": cache["kp"][i], "vp": cache["vp"][i],
                      "page_table": cache["page_table"]}
            else:
                lc = {"k": cache["k"][i], "v": cache["v"][i],
                      "positions": cache["positions"][i]}
            x = self._layer_decode(p, x, lc, pos, fresh)
        return x

    def prefill(self, tokens: torch.Tensor, *, seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward that also fills a fresh ring cache sized
        for ``seq_len`` tokens (default: the prompt length)."""
        cache = self.init_cache(tokens.shape[0], seq_len or tokens.shape[1])
        return self.decode_step(cache, tokens, fresh=True)
