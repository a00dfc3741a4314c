"""InternVL2-style VLM backbone (arXiv:2404.16821).

The InternViT frontend is a stub, as in the JAX package: the caller gives
precomputed patch embeddings (B, n_patches, patch_dim).  A two-layer MLP
projector (layernorm, ``w``, tanh-GELU, ``w2``) maps them into the dense
backbone, where they are prepended to the token embeddings.  The image
context lives in the KV cache, so ``decode_step`` is :class:`DenseLM`'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers
from .config import ArchConfig
from .transformer import DenseLM, _leaf, _params, _store


class VisionLM(DenseLM):
    """Dense LM plus ``patch_proj.{norm, w, w2}``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=torch.device(device)).manual_seed(0)
        super().__init__(cfg, device=device, generator=generator)
        pd = cfg.vlm.patch_dim or cfg.d_model
        self.patch_proj = nn.Module()
        self.patch_proj.norm = _params(_store(layers.init_norm("layernorm", pd, self.device)))
        proj = _store({"w": layers.dense_init(generator, pd, cfg.d_model),
                       "w2": layers.dense_init(generator, cfg.d_model, cfg.d_model)})
        self.patch_proj.w = _leaf(proj["w"])
        self.patch_proj.w2 = _leaf(proj["w2"])

    def project_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """Patch embeddings (B, P, patch_dim) -> backbone inputs (B, P, d_model)."""
        pp = self.patch_proj
        x = layers.apply_norm("layernorm", pp.norm, layers.cast(patches))
        x = F.gelu(x @ layers.cast(pp.w), approximate="tanh")     # jax.nn.gelu's default
        return x @ layers.cast(pp.w2)

    def apply(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Full-sequence forward -> logits over the text positions only,
        (B, S, padded_vocab); the image prefix precedes the text."""
        x = layers.embed_tokens(self.embedding, self.cfg, tokens)
        if patch_embeds is not None:
            x = torch.cat([self.project_patches(patch_embeds), x], dim=1)
        x = self._forward(x)[:, -tokens.shape[1]:]
        return layers.lm_head(self.embedding, self.cfg, x)

    def loss_aux(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` and, where present, ``batch["patch_embeds"]``
        -> (logits over the text positions, a zero auxiliary loss)."""
        logits = self.apply(batch["tokens"], batch.get("patch_embeds"))
        return logits, logits.new_zeros((), dtype=torch.float32)

    forward = apply

    def prefill(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None, *,
                seq_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Text only: :meth:`DenseLM.prefill`.  With patches: a ring sized
        for the image prefix plus ``seq_len`` text positions (default: the
        prompt length), the prefix run through the layers from its
        embeddings, then the text as a decode step."""
        if patch_embeds is None:
            return super().prefill(tokens, seq_len=seq_len)
        img_x = self.project_patches(patch_embeds)
        B, n_p = img_x.shape[0], img_x.shape[1]
        cache = self.init_cache(B, n_p + (seq_len or tokens.shape[1]))
        self._decode_layers(cache, img_x, fresh=True)
        cache["length"] = cache["length"] + n_p
        return self.decode_step(cache, tokens)
