"""Plain PyTorch version of the flash-attention kernel.

Computes what the TPU kernel's body (``_attn_kernel``) computes, in the
model's layout: q is scaled by ``1/sqrt(D)`` in fp32 before Q.K^T, masked
scores take the finite ``NEG_INF`` (with ``-inf``, ``exp(m_prev - m_new)``
is NaN on a row masked at the start), the running max, normaliser and
accumulator are fp32 and updated one kv block at a time, kv rows at or past
``t_real`` are masked, and the output is cast to q's dtype.  GQA reads kv
head ``h // G`` through the einsum's head axis; no repeat is made.

A row with no key to attend (only when S > T under a window) comes out as
the mean of v over the ``t_real`` rows, the value a plain softmax over
equally masked scores gives (the JAX ``reference_attention`` and
``layers.sdpa`` give it too).  The wrapper in ``kernel.py`` runs this for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.  :func:`bf16_rounding_bound` is the per-element limit the
tensor-core route's bf16 result is held to against this version in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
BLOCK = 1024
BF16_U = 2.0 ** -8          # bf16's unit roundoff: half an ulp, relative


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          t_real: Optional[int] = None, block: int = BLOCK) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D), H a multiple of Hkv -> (B, S, H, D)
    in q's dtype.  Row i and key j sit at positions i and j; j is attended
    iff ``j < t_real`` (default T), ``j <= i`` when ``causal`` and
    ``j > i - window`` when ``window`` is set."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    t_real = T if t_real is None else t_real
    dev = q.device
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, S, Hkv, G, D)
    q_pos = torch.arange(S, device=dev)[:, None]
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32, device=dev)
    for lo in range(0, t_real, block):
        hi = min(lo + block, t_real)
        s = torch.einsum("bshgd,bthd->bhgst", qg, k[:, lo:hi].float())
        k_pos = torch.arange(lo, hi, device=dev)[None, :]
        mask = torch.ones((S, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd", p,
                                                    v[:, lo:hi].float())
        m = m_new
    empty = m == NEG_INF                        # no valid key in any block
    v_sum = v[:, :t_real].float().sum(dim=1)    # (B, Hkv, D)
    acc = torch.where(empty[..., None], v_sum[:, :, None, None, :], acc)
    l = torch.where(empty, float(t_real), l)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def bf16_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        t_real: Optional[int] = None):
    """``(want, bound)``: the fp32 plain output on the (bf16-valued) inputs,
    and the per-element bound of the tensor-core route's two bf16
    roundings: P before P.V (``u sum_j p_j |v_j| / l``) and o at the store
    (``u |o|``, plus ``u^2 sum_j p_j |v_j| / l``), ``u = 2^-8``, with 1e-5
    for fp32 summation order."""
    q32, k32, v32 = (t.float() for t in (q, k, v))
    kw = dict(causal=causal, window=window, t_real=t_real)
    want = flash_attention_plain(q32, k32, v32, **kw)
    pv_abs = flash_attention_plain(q32, k32, v32.abs(), **kw)
    return want, 1e-5 + BF16_U * (want.abs() + (1 + BF16_U) * pv_abs)
