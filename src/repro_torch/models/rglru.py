"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427).

Layer pattern ``rra`` (two RG-LRU recurrent blocks, one local-attention MQA
block) repeated over the layers.  The RG-LRU linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(L) * r_t)

runs through the hand-written CUDA scan kernel (``kernels/rglru_scan``) on
the card and its plain left fold on the CPU, at every sequence length.  The
JAX package left-folds only chunks of up to ``RGLRU_LEFT_FOLD_MAX = 16``
tokens and reassociates longer ones through an associative scan; here a
chunk of any length equals token-by-token decode exactly.

:class:`RecurrentLM` holds one :class:`HybridLayer` per layer (the JAX
package stacks ``rra`` super-blocks and scans them, with the tail
unrolled).  Decode state per layer kind:

* ``'a'`` layers keep K/V in a ring (``k``/``v``/``positions``, stacked over
  the attention layers) or in the shared paged pool (``kp``/``vp`` +
  ``page_table``);
* ``'r'`` layers keep ``h`` (n_rec, B, W) fp32 and the conv tail ``conv``
  (n_rec, B, K-1, W) bf16, stacked over the recurrent layers.

A decode step writes K/V in place but returns **new** ``h``/``conv``
tensors, so the scheduler can restore the recurrent rows of inactive slots
(:func:`kvcache.mask_slot_rows`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import kvcache, layers
from .config import ArchConfig, layer_pattern
from .layers import cast
from .transformer import _params, _store

C_RGLRU = 8.0

# Parameters computed with in fp32 (the gates in rglru_gates, qk-norm
# scales), stored fp32.
FP32_LEAVES = ("gate_w_a", "gate_b_a", "gate_w_x", "gate_b_x", "a_param",
               "q_norm", "k_norm")


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def rglru_scan(x_in: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t over axis 1.

    x_in (=b), a: (B, S, W) fp32.  h0: (B, W) initial state, folded into
    b_0 as ``b_0 + a_0 * h0`` so the scan starts from zero: a_0 * 0 + b_0'
    is b_0' bitwise, and each step rounds a_t * h and then + b_t, as an S=1
    step that folds its state in does.
    """
    from ..kernels.rglru_scan import rglru_scan as scan

    if h0 is not None:
        x_in = x_in.clone()
        x_in[:, 0] = x_in[:, 0] + a[:, 0] * h0
    return scan(a, x_in)


def block_diag_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, nb, Wb) @ per-block w (nb, Wb, Wb) -> (B, S, nb, Wb), one
    row-vector product per token and block: a token's result does not depend
    on how many tokens share the call, so a chunk computes each token's
    gates as its S=1 step does.  The broadcast copies w once per token
    (S x nb x Wb x Wb floats), so it is kept for CPU tensors, where the
    port's decode == chunked-prefill tests hold the gates bitwise."""
    return torch.matmul(x.unsqueeze(-2), w).squeeze(-2)


def block_diag_batched(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, nb, Wb) @ per-block w (nb, Wb, Wb) -> (B, S, nb, Wb) as one
    batched product per block, (nb, B*S, Wb) x (nb, Wb, Wb): the reference's
    ``einsum("bskw,kwv->bskv")``, with no copy of w.  Its low bits may
    depend on B*S (the library picks its kernel by shape)."""
    B, S, nb, Wb = x.shape
    xt = x.permute(2, 0, 1, 3).reshape(nb, B * S, Wb)
    return torch.bmm(xt, w).reshape(nb, B, S, Wb).permute(1, 2, 0, 3)


def rglru_gates(p, x: torch.Tensor, n_blocks: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections (Griffin) in fp32: returns
    ``(a, gated_input)``, both (B, S, W) fp32.  The device picks the form
    of the two products: :func:`block_diag_batched` on the card,
    :func:`block_diag_rows` on the CPU."""
    B, S, W = x.shape
    Wb = W // n_blocks
    xb = x.reshape(B, S, n_blocks, Wb).float()
    block_diag = block_diag_rows if x.device.type == "cpu" else block_diag_batched
    r = torch.sigmoid(block_diag(xb, p["gate_w_a"].float()) + p["gate_b_a"].float())
    i = torch.sigmoid(block_diag(xb, p["gate_w_x"].float()) + p["gate_b_x"].float())
    r = r.reshape(B, S, W)
    i = i.reshape(B, S, W)
    log_a = -C_RGLRU * torch.nn.functional.softplus(p["a_param"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, gated


def init_rec_mixer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """The JAX package's distributions, drawn from ``gen``."""
    h = cfg.hybrid
    W = h.lru_width or cfg.d_model
    nb = cfg.n_heads
    Wb = W // nb
    dev, f32 = gen.device, layers.PARAM_DTYPE
    # a_param init so that a^(1/c) ~ U(0.9, 0.999) at r=1 (Griffin App. A)
    a0 = 0.9 + 0.099 * torch.rand(W, generator=gen, device=dev, dtype=f32)
    a_param = torch.log(torch.expm1(-torch.log(a0) / C_RGLRU))
    return {
        "w_x": layers.dense_init(gen, cfg.d_model, W),
        "w_y": layers.dense_init(gen, cfg.d_model, W),
        "conv_w": 0.1 * torch.randn(h.d_conv, W, generator=gen, device=dev, dtype=f32),
        "conv_b": torch.zeros(W, dtype=f32, device=dev),
        "gate_w_a": torch.randn(nb, Wb, Wb, generator=gen, device=dev, dtype=f32)
        / math.sqrt(Wb),
        "gate_b_a": torch.zeros(nb, Wb, dtype=f32, device=dev),
        "gate_w_x": torch.randn(nb, Wb, Wb, generator=gen, device=dev, dtype=f32)
        / math.sqrt(Wb),
        "gate_b_x": torch.zeros(nb, Wb, dtype=f32, device=dev),
        "a_param": a_param,
        "w_out": layers.dense_init(gen, W, cfg.d_model),
    }


def causal_conv(p, xw: torch.Tensor, prev: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over xw (B, S, W) continuing from the carry
    ``prev`` (B, K-1, W) (zeros when None); no activation in griffin conv.
    Returns ``(xc, tail)``: the conv output and the new carry, the last K-1
    inputs.  Elementwise, so a chunk equals its S=1 steps bitwise."""
    K = p["conv_w"].shape[0]
    B, S, W = xw.shape
    if prev is None:
        prev = torch.zeros((B, K - 1, W), dtype=xw.dtype, device=xw.device)
    padded = torch.cat([prev.to(xw.dtype), xw], dim=1)
    xc = sum(padded[:, i:i + S, :] * cast(p["conv_w"][i]) for i in range(K))
    return xc + cast(p["conv_b"]), padded[:, -(K - 1):].contiguous()


def rec_mix(p, cfg: ArchConfig, x: torch.Tensor, state: Optional[Dict] = None,
            want_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent block mixer.  state={'h': (B,W) fp32, 'conv':
    (B,K-1,W)}.  A state with S > 1 is a continuation (chunked prefill):
    the conv carry and h0 thread the recurrence across chunk boundaries
    exactly as S=1 decode does.  The returned state is new tensors; the
    given one is not written."""
    y_branch = layers._gelu(x @ cast(p["w_y"]))
    xw = x @ cast(p["w_x"])
    continuing = state is not None
    xc, tail = causal_conv(p, xw, state["conv"] if continuing else None)
    new_state = {"conv": tail} if continuing or want_state else None
    a, gated = rglru_gates(p, xc, cfg.n_heads)
    h = rglru_scan(gated, a, h0=state["h"] if continuing else None)
    if new_state is not None:
        new_state["h"] = h[:, -1].contiguous()
    h = h.to(x.dtype) * y_branch
    return h @ cast(p["w_out"]), new_state


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def init_hybrid_layer(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    """One layer's parameter groups: ``norm``, ``mlp_norm``, ``mlp`` and
    ``rec`` (kind 'r') or ``attn`` (kind 'a')."""
    p = {
        "norm": layers.init_norm(cfg.norm, cfg.d_model, gen.device),
        "mlp_norm": layers.init_norm(cfg.norm, cfg.d_model, gen.device),
    }
    if kind == "r":
        p["rec"] = init_rec_mixer(gen, cfg)
    else:
        p["attn"] = layers.init_attention(gen, cfg)
    p["mlp"] = layers.init_mlp(gen, cfg)
    return p


class HybridLayer(nn.Module):
    """Parameters of one hybrid layer, named as in the JAX parameter tree.
    The gate parameters are stored fp32 (``rglru_gates`` computes with the
    fp32 masters); everything cast to bf16 at use is stored bf16."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, kind: str):
        super().__init__()
        self.kind = kind
        for group, tree in init_hybrid_layer(gen, cfg, kind).items():
            setattr(self, group, _params(_store(tree, fp32=FP32_LEAVES)))


def _attn_decode(p, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                 lc: Dict, pos: torch.Tensor, fresh: bool = False) -> torch.Tensor:
    """Local attention against one layer of a ring or paged cache, written
    in place.  S=1 on the paged kernel attends the post-update pool: the
    token is written first and lane ``pos`` itself is attended.  ``fresh``:
    the cache was empty (a from-scratch prefill)."""
    window = cfg.hybrid.local_window
    B, S = h.shape[0], h.shape[1]
    q, k, v = layers.qkv_project(p, cfg, h, positions)
    kvcache.cache_update_layer(lc, k, v, pos)
    if S > kvcache.cache_capacity(lc) or layers.takes_flash(S, fresh):
        # a from-scratch prefill longer than the ring window, or long enough
        # for the flash kernel, attends its fresh full-sequence k/v
        o = layers.sdpa(q, k, v, causal=True, window=window,
                        q_positions=positions, kv_positions=positions, aligned=fresh)
    elif S == 1 and cfg.attn_backend == "paged_kernel" and kvcache.is_paged(lc):
        o = kvcache.paged_attn_decode(lc, q, pos, window=window, include_new=True)
    else:
        ck, cv, kv_pos, kv_valid = kvcache.cache_kv_view(lc, upto=pos + S)
        o = layers.sdpa(q, ck, cv, causal=True, window=window,
                        q_positions=positions, kv_positions=kv_pos, kv_valid=kv_valid)
    o = o.reshape(B, S, cfg.n_heads * cfg.the_head_dim())
    return o @ cast(p["wo"])


def _mlp_residual(p: HybridLayer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, p.mlp_norm, x)
    return x + layers.apply_mlp(p.mlp, cfg, h)


class RecurrentLM(nn.Module):
    """Hybrid RG-LRU / local-attention LM.  Parameters are drawn from
    ``generator`` (default: seed 0 on ``device``) with the JAX package's
    distributions; load other weights with ``load_state_dict`` (see
    :mod:`repro_torch.weights`)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, model on {device}")
        self.kinds = layer_pattern(cfg)
        self.embedding = _params(_store(layers.init_embedding(generator, cfg)))
        self.layers = nn.ModuleList(HybridLayer(cfg, generator, kind) for kind in self.kinds)
        self.final_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, device)))
        # index of each layer within its kind's stacked cache leaves
        self._slot = [self.kinds[:i].count(kind) for i, kind in enumerate(self.kinds)]

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    @property
    def n_kv_layers(self) -> int:
        """Layers that keep K/V (the local-attention layers)."""
        return self.kinds.count("a")

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, padded_vocab)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = layers.embed_tokens(self.embedding, cfg, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        for p in self.layers:
            h = layers.apply_norm(cfg.norm, p.norm, x)
            if p.kind == "r":
                h, _ = rec_mix(p.rec, cfg, h)
            else:
                h = layers.attention_block(p.attn, cfg, h, positions,
                                           window=cfg.hybrid.local_window)
            x = _mlp_residual(p, cfg, x + h)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        return layers.lm_head(self.embedding, cfg, x)

    forward = apply

    # -- decode ------------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        return min(seq_len, self.cfg.hybrid.local_window)

    def recurrent_rows(self, B: int) -> Dict[str, torch.Tensor]:
        """Zero recurrent state for ``B`` rows: ``h`` (n_rec, B, W) fp32 and
        ``conv`` (n_rec, B, K-1, W) bf16."""
        cfg = self.cfg
        W = cfg.hybrid.lru_width or cfg.d_model
        n_rec = self.kinds.count("r")
        return {
            "h": torch.zeros((n_rec, B, W), dtype=torch.float32, device=self.device),
            "conv": torch.zeros((n_rec, B, cfg.hybrid.d_conv - 1, W),
                                dtype=layers.COMPUTE_DTYPE, device=self.device),
        }

    def init_cache(self, B: int, seq_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        cache = kvcache.init_attn_cache(self.n_kv_layers, B, self.cache_len(seq_len),
                                        cfg.n_kv_heads, cfg.the_head_dim(), self.device)
        cache.update(self.recurrent_rows(B))
        return cache

    def decode_step(self, cache: Dict, tokens: torch.Tensor, *, fresh: bool = False
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S_new).  K/V are written into ``cache`` in place; the
        returned cache shares those tensors and carries the advanced
        ``length`` and new ``h``/``conv`` tensors.  ``fresh``: the cache is
        empty (a from-scratch prefill)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = layers.embed_tokens(self.embedding, cfg, tokens)
        pos = cache["length"]
        positions = kvcache.decode_positions(pos, B, S)
        paged = kvcache.is_paged(cache)
        new_h, new_conv = [], []
        for p, j in zip(self.layers, self._slot):
            h = layers.apply_norm(cfg.norm, p.norm, x)
            if p.kind == "r":
                h, st = rec_mix(p.rec, cfg, h,
                                state={"h": cache["h"][j], "conv": cache["conv"][j]})
                new_h.append(st["h"])
                new_conv.append(st["conv"])
            else:
                if paged:
                    lc = {"kp": cache["kp"][j], "vp": cache["vp"][j],
                          "page_table": cache["page_table"]}
                else:
                    lc = {"k": cache["k"][j], "v": cache["v"][j],
                          "positions": cache["positions"][j]}
                h = _attn_decode(p.attn, cfg, h, positions, lc, pos, fresh)
            x = _mlp_residual(p, cfg, x + h)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        logits = layers.lm_head(self.embedding, cfg, x)
        new_cache = dict(cache)
        new_cache["h"] = torch.stack(new_h)
        new_cache["conv"] = torch.stack(new_conv)
        new_cache["length"] = cache["length"] + S
        return logits, new_cache

    def prefill(self, tokens: torch.Tensor, *, seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward that also fills a fresh cache sized for
        ``seq_len`` tokens (default: the prompt length)."""
        cache = self.init_cache(tokens.shape[0], seq_len or tokens.shape[1])
        return self.decode_step(cache, tokens, fresh=True)
