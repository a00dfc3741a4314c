"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The conv-mel frontend is a stub, as in the JAX package: the caller gives
precomputed frame embeddings (B, n_frames, d_model), what whisper's two conv
layers would emit.  Positions are sinusoidal, added to the embeddings of
both stacks; the attention layers also apply RoPE inside ``qkv_project``,
as the JAX package's do.  The decoder is causal self-attention, then
cross-attention to the encoder output, then the MLP.

The decode cache holds the decoder's self-attention ring (written in place
by ``DenseLM.decode_step``, whose layer stack this model replaces) and each
layer's cross-attention k/v, computed once from the encoder output at
prefill: ``xk``/``xv`` of shape (L, B, F, Hkv, D).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import layers
from .config import ArchConfig
from .transformer import DenseLayer, DenseLM, _params, _store, attn_residual_decode, mlp_residual


class DecoderLayer(DenseLayer):
    """A decoder layer: the dense layer's groups plus the cross-attention."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        self.xattn_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, gen.device)))
        self.xattn = _params(_store(layers.init_attention(gen, cfg)))


def _xattn(p, cfg: ArchConfig, x: torch.Tensor, enc_k: torch.Tensor,
           enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention with precomputed encoder k/v (B, F, Hkv, D)."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.the_head_dim()
    q = (x @ layers.cast(p["wq"])).reshape(B, S, cfg.n_heads, hd)
    o = layers.sdpa(q, enc_k, enc_v, causal=False)
    return o.reshape(B, S, cfg.n_heads * hd) @ layers.cast(p["wo"])


def _enc_kv(p, cfg: ArchConfig, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    B, F = enc_out.shape[0], enc_out.shape[1]
    hd = cfg.the_head_dim()
    k = (enc_out @ layers.cast(p["wk"])).reshape(B, F, cfg.n_kv_heads, hd)
    v = (enc_out @ layers.cast(p["wv"])).reshape(B, F, cfg.n_kv_heads, hd)
    return k, v


class EncDecLM(DenseLM):
    """Encoder-decoder LM: ``embedding``, ``layers`` (decoder) and
    ``final_norm`` as in :class:`DenseLM`, plus ``enc_layers`` and
    ``enc_norm``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=torch.device(device)).manual_seed(0)
        super().__init__(cfg, device=device, generator=generator)
        self.enc_layers = nn.ModuleList(DenseLayer(cfg, generator)
                                        for _ in range(cfg.encdec.n_encoder_layers))
        self.enc_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, self.device)))

    def _make_layer(self, cfg: ArchConfig, gen: torch.Generator) -> nn.Module:
        return DecoderLayer(cfg, gen)

    # -- encoder ---------------------------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, F, d_model) -> encoder output (B, F, d_model)."""
        cfg = self.cfg
        B, F, _ = frames.shape
        x = layers.cast(frames) + layers.sinusoidal_positions(F, cfg.d_model,
                                                              device=frames.device)[None]
        positions = torch.arange(F, dtype=torch.int32, device=x.device)[None].expand(B, F)

        def layer(p, x):
            a = layers.apply_norm(cfg.norm, p.attn_norm, x)
            x = x + layers.attention_block(p.attn, cfg, a, positions, causal=False)
            return x + layers.apply_mlp(p.mlp, cfg, layers.apply_norm(cfg.norm, p.mlp_norm, x))

        for p in self.enc_layers:
            x = layers.remat(cfg.remat, functools.partial(layer, p), x)
        return layers.apply_norm(cfg.norm, self.enc_norm, x)

    # -- decoder ---------------------------------------------------------------

    def apply(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, padded_vocab)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        B, S = tokens.shape
        x = layers.embed_tokens(self.embedding, cfg, tokens)
        x = x + layers.sinusoidal_positions(S, cfg.d_model, device=x.device)[None]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

        def layer(p, x, enc_out):
            a = layers.apply_norm(cfg.norm, p.attn_norm, x)
            x = x + layers.attention_block(p.attn, cfg, a, positions, causal=True)
            c = layers.apply_norm(cfg.norm, p.xattn_norm, x)
            x = x + _xattn(p.xattn, cfg, c, *_enc_kv(p.xattn, cfg, enc_out))
            return mlp_residual(p, cfg, x)

        for p in self.layers:
            x = layers.remat(cfg.remat, functools.partial(layer, p), x, enc_out)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        return layers.lm_head(self.embedding, cfg, x)

    def loss_aux(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` and ``batch["frames"]`` -> (logits, a zero
        auxiliary loss)."""
        logits = self.apply(batch["tokens"], batch["frames"])
        return logits, logits.new_zeros((), dtype=torch.float32)

    forward = apply

    # -- decode ----------------------------------------------------------------

    def init_cache(self, B: int, seq_len: int, n_frames: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        F = n_frames if n_frames is not None else cfg.encdec.n_frames
        hd = cfg.the_head_dim()
        cache = super().init_cache(B, seq_len)
        shape = (cfg.n_layers, B, F, cfg.n_kv_heads, hd)
        cache["xk"] = torch.zeros(shape, dtype=layers.COMPUTE_DTYPE, device=self.device)
        cache["xv"] = torch.zeros(shape, dtype=layers.COMPUTE_DTYPE, device=self.device)
        return cache

    def prefill(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None, *,
                seq_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Encode ``frames`` (zero frames when ``None``, as the JAX package
        does), fill each layer's cross-attention k/v, and run the prompt
        through the decoder into a fresh ring sized for ``seq_len`` tokens
        (default: the prompt length)."""
        cfg = self.cfg
        B, S = tokens.shape
        if frames is None:
            frames = torch.zeros((B, cfg.encdec.n_frames, cfg.d_model),
                                 dtype=layers.COMPUTE_DTYPE, device=self.device)
        enc_out = self.encode(frames)
        cache = self.init_cache(B, seq_len or S, n_frames=frames.shape[1])
        for i, p in enumerate(self.layers):
            k, v = _enc_kv(p.xattn, cfg, enc_out)
            cache["xk"][i].copy_(k)
            cache["xv"][i].copy_(v)
        return self.decode_step(cache, tokens, fresh=True)

    def _decode_layers(self, cache: Dict, x: torch.Tensor, fresh: bool) -> torch.Tensor:
        """Sinusoidal positions from ``cache["length"]`` on, then each
        decoder layer: self-attention against the ring (written in place),
        cross-attention to the cached encoder k/v, the MLP."""
        cfg = self.cfg
        pos = cache["length"]
        x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model, offset=pos)[None]
        for i, p in enumerate(self.layers):
            lc = {"k": cache["k"][i], "v": cache["v"][i], "positions": cache["positions"][i]}
            x = attn_residual_decode(p, cfg, x, lc, pos, fresh)
            c = layers.apply_norm(cfg.norm, p.xattn_norm, x)
            x = x + _xattn(p.xattn, cfg, c, cache["xk"][i], cache["xv"][i])
            x = mlp_residual(p, cfg, x)
        return x
