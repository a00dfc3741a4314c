"""Architecture configuration for the data plane.

One :class:`ArchConfig` instance fully describes a model family member; the
architectures live in :mod:`repro_torch.configs` as module-level
constants built from this dataclass.  ``reduced()`` produces the smoke-test
scale of the same family (same code paths, tiny dims).

The sub-configs of the other families (MoE, SSM, hybrid, enc-dec, VLM) are
kept so ``reduced()`` builds the same dataclass for every family; the dense,
MoE, hybrid and SSM families have a model in this package so far.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int           # hidden width of a single expert FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style block pattern: ``pattern`` repeated over layers.

    'r' = RG-LRU recurrent block, 'a' = local-attention block.
    """

    pattern: str = "rra"
    lru_width: Optional[int] = None     # defaults to d_model
    local_window: int = 2048
    d_conv: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    n_frames: int = 1500
    frame_dim: Optional[int] = None


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256
    patch_dim: Optional[int] = None


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None       # default d_model // n_heads
    mlp: str = "swiglu"                  # swiglu | gelu | geglu
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    qk_norm: bool = False                # qwen3
    qkv_bias: bool = False               # qwen1.5, starcoder2
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # starcoder2 = 4096
    emb_scale: float = 1.0               # minicpm scale_emb
    residual_scale: float = 1.0          # minicpm scale_depth / sqrt(L)
    logit_scale: float = 1.0             # minicpm d_model/dim_model_base scaling
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    scan_layers: bool = True
    remat: str = "full"                  # none | full | dots

    # decode attention over a paged cache: 'gather' materializes the pooled
    # view (the reference), 'paged_kernel' streams pages through the CUDA
    # table-indirect kernel (S=1 decode only; gather still serves chunked
    # prefill and ring caches)
    attn_backend: str = "gather"

    def kv_dim(self) -> int:
        return self.n_kv_heads * self.the_head_dim()

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256; lm_head masks the pad."""
        return -(-self.vocab // 256) * 256

    def the_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def param_count(self, active_only: bool = False) -> int:
        """Parameters (embedding + head + layers), counted as the JAX package
        counts them: an MoE member's experts and router but not moonshot's
        shared expert (``active_only``: the top-k experts of a token)."""
        d, f = self.d_model, self.d_ff
        hd = self.the_head_dim()
        q_dim, kv = self.n_heads * hd, self.n_kv_heads * hd
        attn = d * (q_dim + 2 * kv) + q_dim * d
        mlp = d * f * (3 if self.mlp in ("swiglu", "geglu") else 2)
        if self.family == "ssm":
            s = self.ssm
            di, nh, n_bc = s.d_inner(d), s.n_heads(d), 2 * s.d_state
            # in_proj -> [z, x, B, C, dt], conv over (x, B, C), out_proj,
            # A_log, dt_bias and the gated norm (the JAX package's count)
            per_layer = (d * (2 * di + n_bc + nh) + (di + n_bc) * s.d_conv + di * d
                         + nh * 2 + di)
            n = self.n_layers * per_layer
        elif self.family == "hybrid":
            h = self.hybrid
            lw = h.lru_width or d
            pat = layer_pattern(self)
            # x/y projections, conv, output projection, gates (the JAX
            # package's estimate: block-diagonal gates as 8 blocks)
            rec = d * lw * 2 + lw * h.d_conv + lw * d + 3 * lw + 2 * lw * (lw // 8)
            n = pat.count("r") * rec + pat.count("a") * attn + self.n_layers * mlp
        elif self.family == "moe" and self.moe is not None:
            m = self.moe
            n_exp = m.top_k if active_only else m.n_experts
            experts = n_exp * d * m.d_expert * (3 if self.mlp == "swiglu" else 2)
            n = self.n_layers * (attn + experts + d * m.n_experts)
        else:
            n = self.n_layers * (attn + mlp)
        return n + self.vocab * d * (1 if self.tie_embeddings else 2)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4) if self.family != "hybrid" else 3,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            scan_layers=self.scan_layers,
            remat="none",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                  capacity_factor=self.moe.capacity_factor)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(pattern=self.hybrid.pattern, lru_width=64,
                                        local_window=8, d_conv=4)
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_encoder_layers=2, n_frames=8, frame_dim=64)
        if self.vlm is not None:
            kw["vlm"] = VLMConfig(n_patches=4, patch_dim=64)
        return dataclasses.replace(self, **kw)


def layer_pattern(cfg: ArchConfig) -> str:
    """Expanded per-layer kind string for hybrid archs, e.g. 'rrarra...'."""
    assert cfg.hybrid is not None
    p = cfg.hybrid.pattern
    return (p * math.ceil(cfg.n_layers / len(p)))[: cfg.n_layers]
