"""Shared neural-net building blocks (plain functions on tensors).

Parameters are mappings of tensors (an ``nn.ParameterDict`` or a plain
dict) laid out as in the JAX package: a projection ``w`` is ``(d_in,
d_out)`` and applies as ``x @ w``.  Matrices, biases, norm scales and the
embedding are stored in the compute dtype (bf16): the JAX package keeps
fp32 masters and casts them to bf16 at every use, which gives the same
values.  The qk-norm scales stay fp32 because :func:`rms_norm_head`
computes with them in fp32.

A model built for training (:func:`master_weights`, ``build_model(...,
train=True)``) keeps every leaf as an fp32 master that requires grad, as
the JAX package keeps ``PARAM_DTYPE = float32``; every use casts it, so the
forward computes the same values either way.  :func:`remat` checkpoints a
layer of the full-sequence forward as the config's ``remat`` says.

Rounding follows the JAX package step by step: norm statistics in fp32
with ``inv`` cast to the activation dtype, attention scores and softmax in
fp32 with probabilities cast to bf16 before the PV product, scalar factors
(embedding, residual and logit scales) rounded to bf16 before they multiply.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from ..kernels.flash_attention import flash_attention

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32
NEG_INF = -1e30


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


_MASTERS = contextvars.ContextVar("master_weights", default=False)


@contextlib.contextmanager
def master_weights(on: bool = True):
    """Inside: model constructors keep every parameter an fp32 master with
    ``requires_grad=True`` (a model built for training); outside, each
    leaf is stored in the dtype its uses cast it to, with no grad."""
    token = _MASTERS.set(on)
    try:
        yield
    finally:
        _MASTERS.reset(token)


def building_masters() -> bool:
    return _MASTERS.get()


# Matmul outputs without batch dims, which the ``"dots"`` policy keeps (the
# JAX package's ``dots_with_no_batch_dims_saveable``): the weight products.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn, *args):
    """``fn(*args)``, rematerialized in the backward as ``policy`` says
    (the JAX package's ``remat_wrap``): ``"none"`` saves every activation,
    ``"full"`` only the inputs (``torch.utils.checkpoint``, non-reentrant:
    the forward runs again in the backward), ``"dots"`` also the weight
    matmuls' outputs.  Without grad, or when no input requires it (a
    serving model), it is a plain call."""
    if policy == "none" or not torch.is_grad_enabled() or not any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return fn(*args)
    if policy == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat policy must be none, full or dots, got {policy!r}")


def bf16_scalar(v: float) -> float:
    """``v`` rounded to bf16, as a Python float: multiplying a bf16 tensor
    by it rounds exactly like the JAX package's ``x * jnp.asarray(v, bf16)``."""
    return float(torch.tensor(v, dtype=COMPUTE_DTYPE))


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package, drawn from a
# torch.Generator on the target device)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return std * torch.randn(d_in, d_out, generator=gen, device=gen.device,
                             dtype=PARAM_DTYPE)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn(vocab, d, generator=gen, device=gen.device,
                       dtype=PARAM_DTYPE) * 0.02


def init_norm(kind: str, d: int, device) -> dict:
    p = {"scale": torch.ones(d, dtype=PARAM_DTYPE, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=PARAM_DTYPE, device=device)
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(kind: str, p: Mapping[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalization with fp32 statistics but a bf16 tensor path: only the
    (B, S, 1) moments are fp32, ``inv`` is cast to the activation dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = xf.square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(ms + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))


def rms_norm_head(p_scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qwen3 qk_norm); the
    scale multiplies in fp32."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p_scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Split-halves
    convention: the first and second halves of D form the rotated pairs."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs                   # (..., S, D/2)
    angles = angles[..., None, :]                                   # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg) -> dict:
    d, hd = cfg.d_model, cfg.the_head_dim()
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {
        "wq": dense_init(gen, d, q_dim),
        "wk": dense_init(gen, d, kv_dim),
        "wv": dense_init(gen, d, kv_dim),
        "wo": dense_init(gen, q_dim, d),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            p[name] = torch.zeros(n, dtype=PARAM_DTYPE, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=PARAM_DTYPE, device=gen.device)
        p["k_norm"] = torch.ones(hd, dtype=PARAM_DTYPE, device=gen.device)
    return p


def qkv_project(p, cfg, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,Hkv,D) with RoPE applied."""
    hd = cfg.the_head_dim()
    q = x @ cast(p["wq"])
    k = x @ cast(p["wk"])
    v = x @ cast(p["wv"])
    if cfg.qkv_bias:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_head(p["q_norm"], q)
        k = rms_norm_head(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# Above this many kv positions (with S > 1), sdpa streams the softmax over kv
# blocks so the full (S, T) score tensor is never materialized: a sequence
# attending itself from position 0 (``aligned``, a from-scratch prefill)
# through the flash kernel, which is the case the JAX package gives its
# Pallas kernel (its ``layers.py`` comment at STREAM_KV_THRESHOLD), and a
# query block offset into a longer kv view (a later chunk of chunked
# prefill) through the plain ``_sdpa_streaming``.
STREAM_KV_THRESHOLD = 4096
STREAM_KV_BLOCK = 1024


def takes_flash(S: int, aligned: bool) -> bool:
    """Whether :func:`sdpa` sends an aligned self-attention of ``S`` tokens
    to the flash kernel.  Below the threshold every call keeps the
    materialized-score path, bit for bit."""
    return aligned and S >= STREAM_KV_THRESHOLD


def _attn_mask(q_positions, kv_positions, kv_valid, causal, window):
    qp = q_positions[:, None, None, :, None]      # (B,1,1,S,1)
    kp = kv_positions[:, None, None, None, :]     # (B,1,1,1,T)
    mask = torch.ones(qp.shape[:-1] + (kp.shape[-1],), dtype=torch.bool,
                      device=q_positions.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    return mask


def _default_positions(positions, B: int, n: int, device) -> torch.Tensor:
    if positions is None:
        return torch.arange(n, device=device)[None].expand(B, n)
    return positions


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         q_positions: Optional[torch.Tensor] = None,
         kv_positions: Optional[torch.Tensor] = None,
         kv_valid: Optional[torch.Tensor] = None,
         aligned: bool = False) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention.

    q: (B, S, H, D); k, v: (B, T, Hkv, D).  H must be a multiple of Hkv.
    ``q_positions``/``kv_positions`` (B, S)/(B, T) define the mask when the
    query block is not aligned with the kv block (decode with a cache).
    ``kv_valid`` (B, T) masks unfilled cache lanes.  ``aligned`` is the
    caller's word that q, k and v are one sequence from position 0 (S == T,
    positions ``arange``, no ``kv_valid``): from STREAM_KV_THRESHOLD tokens
    on, that call runs in the flash kernel.  bf16 at a head dim that is a
    multiple of 16 takes its tensor-core route, which rounds the
    probabilities P to bf16 for P.V; fp32 takes its CUDA-core route, with
    fp32 probabilities throughout.
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if aligned and (S != T or kv_valid is not None):
        raise ValueError(f"aligned attention needs S == T and no kv_valid, got S={S}, "
                         f"T={T}, kv_valid {'set' if kv_valid is not None else 'None'}")
    if takes_flash(S, aligned):
        return flash_attention(q, k, v, causal=causal, window=window)
    q_positions = _default_positions(q_positions, B, S, q.device)
    kv_positions = _default_positions(kv_positions, B, T, q.device)

    if S > 1 and T >= STREAM_KV_THRESHOLD and T % STREAM_KV_BLOCK == 0:
        return _sdpa_streaming(q, k, v, causal=causal, window=window,
                               q_positions=q_positions,
                               kv_positions=kv_positions, kv_valid=kv_valid)

    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    scores = scores / math.sqrt(D)
    mask = _attn_mask(q_positions, kv_positions, kv_valid, causal, window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(B, S, H, D)


def sdpa_append(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, *,
                window: Optional[int] = None,
                q_positions: torch.Tensor,
                kv_positions: torch.Tensor,
                kv_valid: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over (old cache || new token), the
    reference semantics of the paged kernel: scores against the pre-update
    cache plus a rank-1 term for the new token, one softmax, probabilities
    and the value accumulation in fp32.  q/k_new/v_new: (B, 1, H*, D)."""
    B, S, H, D = q.shape
    Hkv = ck.shape[2]
    G = H // Hkv
    k_new = k_new.to(ck.dtype)
    v_new = v_new.to(cv.dtype)
    qg = q.reshape(B, S, Hkv, G, D)
    s_old = torch.einsum("bshgd,bthd->bhgst", qg, ck).float() / math.sqrt(D)
    mask = _attn_mask(q_positions, kv_positions, kv_valid, True, window)
    s_old = s_old.masked_fill(~mask, NEG_INF)
    s_new = torch.einsum("bshgd,bthd->bhgst", qg, k_new).float() / math.sqrt(D)
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    p_old, p_new = p[..., :-1], p[..., -1:]
    out = torch.einsum("bhgst,bthd->bshgd", p_old, cv.float())
    out = out + torch.einsum("bhgst,bthd->bshgd", p_new, v_new.float())
    return out.to(q.dtype).reshape(B, S, H, D)


def _sdpa_streaming(q, k, v, *, causal, window, q_positions, kv_positions,
                    kv_valid, block: int = STREAM_KV_BLOCK) -> torch.Tensor:
    """Exact streaming softmax over kv blocks (flash attention in plain ops)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = (q.float() * scale).reshape(B, S, Hkv, G, D)
    if kv_valid is None:
        kv_valid = torch.ones(B, T, dtype=torch.bool, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32, device=q.device)
    for lo in range(0, T, block):
        kc, vc = k[:, lo:lo + block].float(), v[:, lo:lo + block].float()
        s = torch.einsum("bshgd,bthd->bhgst", qg, kc)
        mask = _attn_mask(q_positions, kv_positions[:, lo:lo + block],
                          kv_valid[:, lo:lo + block], causal, window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)                     # (B,S,Hkv,G,D)
    return out.reshape(B, S, H, D).to(q.dtype)


def attention_block(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                    window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention; ``positions`` are ``arange(S)``."""
    q, k, v = qkv_project(p, cfg, x, positions)
    o = sdpa(q, k, v, causal=causal, window=window,
             q_positions=positions, kv_positions=positions, aligned=True)
    B, S = x.shape[0], x.shape[1]
    o = o.reshape(B, S, cfg.n_heads * cfg.the_head_dim())
    return o @ cast(p["wo"])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, f),
            "w_up": dense_init(gen, d, f),
            "w_down": dense_init(gen, f, d),
        }
    return {
        "w_up": dense_init(gen, d, f),
        "b_up": torch.zeros(f, dtype=PARAM_DTYPE, device=gen.device),
        "w_down": dense_init(gen, f, d),
        "b_down": torch.zeros(d, dtype=PARAM_DTYPE, device=gen.device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def apply_mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        g = act(x @ cast(p["w_gate"]))
        u = x @ cast(p["w_up"])
        return (g * u) @ cast(p["w_down"])
    h = _gelu(x @ cast(p["w_up"]) + cast(p["b_up"]))
    return h @ cast(p["w_down"]) + cast(p["b_down"])


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg) -> dict:
    p = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab)
    return p


def embed_tokens(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = cast(p["embed"])[tokens.long()]
    return x * bf16_scalar(cfg.emb_scale)


def lm_head(p, cfg, x: torch.Tensor) -> torch.Tensor:
    w = cast(p["embed"]).t() if cfg.tie_embeddings else cast(p["head"])
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = NEG_INF
    return logits * bf16_scalar(cfg.logit_scale)


def sinusoidal_positions(S: int, d: int, offset=0, device=None) -> torch.Tensor:
    """Length-agnostic absolute embeddings (S, d) in the compute dtype
    (whisper): sines of the first d/2 channels, then cosines.  ``offset``
    may be a 0-d device tensor (the cache length at a decode step)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    pos = (torch.arange(S, dtype=torch.float32, device=device) + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(COMPUTE_DTYPE)
