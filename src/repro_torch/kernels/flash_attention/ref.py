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
tensor-core route's bf16 result is held to against this version in fp32;
:func:`bf16_backward_rounding_bound` is its backward's.

:func:`flash_attention_backward_plain` is the plain version of the
kernel's backward: the FlashAttention-2 recompute formulas (P from the
forward's lse, delta = rowsum(dO o), dS = P (dP - delta)) in fp32, one
block of query rows at a time.
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
                          t_real: Optional[int] = None, block: int = BLOCK,
                          return_lse: bool = False):
    """q (B, S, H, D); k, v (B, T, Hkv, D), H a multiple of Hkv -> (B, S, H, D)
    in q's dtype.  Row i and key j sit at positions i and j; j is attended
    iff ``j < t_real`` (default T), ``j <= i`` when ``causal`` and
    ``j > i - window`` when ``window`` is set.  With ``return_lse``: ``(o,
    lse)``, lse (B, H, S) fp32 the log-sum-exp of each row's scaled scores
    (``m + log l``)."""
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
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse.reshape(B, H, S)


def _mask(S: int, lo: int, hi: int, window: Optional[int], device) -> torch.Tensor:
    """(hi - lo, S): query rows [lo, hi) attend key j iff j <= i and, with a
    window, j > i - window."""
    i = torch.arange(lo, hi, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    return mask


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                   window: Optional[int] = None, block: int = BLOCK):
    """The gradients ``(dq, dk, dv)`` of a causal (optionally windowed)
    self-attention, S == T, in the inputs' dtypes: q (B, S, H, D), k and v
    (B, S, Hkv, D), the forward's o and lse (B, H, S), do o's shape.  fp32
    throughout: P = exp(s / sqrt(D) - lse), dV = P^T dO, dP = dO V^T, dS =
    P (dP - rowsum(dO o)), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D); each
    group's query heads sum into their kv head."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Hkv, G, D)
    dog = do.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(-1).reshape(B, S, Hkv, G)
    lse_g = lse.reshape(B, Hkv, G, S)
    dq = torch.empty((B, S, Hkv, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        s = torch.einsum("bshgd,bthd->bhgst", qg[:, lo:hi], kf) * scale
        p = torch.exp(s - lse_g[..., lo:hi, None])
        p = p.masked_fill(~_mask(S, lo, hi, window, q.device), 0.0)
        dv += torch.einsum("bhgst,bshgd->bthd", p, dog[:, lo:hi])
        dp = torch.einsum("bshgd,bthd->bhgst", dog[:, lo:hi], vf)
        ds = p * (dp - delta[:, lo:hi].permute(0, 2, 3, 1)[..., None])
        dq[:, lo:hi] = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
        dk += torch.einsum("bhgst,bshgd->bthd", ds, qg[:, lo:hi]) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


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


def fp32_sum_error(m: int) -> float:
    """Bound, relative to the sum of |terms|, on how far the kernel's and
    the plain version's fp32 sums of the same ``m`` exact terms can differ:
    the plain version's ``m`` round-to-nearest additions (``m 2^-24``) plus
    the kernel's, ``m`` fmaf (``m 2^-24``) or ``m / 16`` mma.sync
    accumulations of at most two ulps (``m 2^-26``)."""
    return m * 2.0 ** -23


def bf16_backward_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                 window: Optional[int] = None, block: int = 512):
    """``(want, bound)``, each ``(dq, dk, dv)`` fp32: the plain backward in
    fp32 on the same inputs (bf16 values; o and lse the kernel forward's),
    and the per-element bound of the tensor-core route's bf16 roundings
    against it (``u = 2^-8``):

    * P rounded before dV = P^T dO: ``u sum_i p_ij |dO_i|``;
    * dS rounded before dK = dS^T Q and dQ = dS K: ``u scale sum |dS| |q|``
      and ``u scale sum |dS| |k|``;
    * the store: ``u |g|``, on the fp32 result;

    and the fp32 differences of the two versions: each sum of ``m`` terms
    within :func:`fp32_sum_error` ``(m)`` of its sum of |terms| (S and dP
    over D, delta over D, dK and dV over the group's attending rows, dQ over
    the keys), and p's relative error ``fp32_sum_error(D) scale |q|.|k| +
    2^-20 (1 + scale |q|.|k| + |lse|)`` (the exponent's roundings and the
    exp2 approximation).  Products of second order are covered by a factor
    ``1 + 4u``.  The CUDA-core route rounds only at the store, so the bound
    holds for it too."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    u = BF16_U
    span = min(S, window or S)
    g_d, g_kv, g_q = fp32_sum_error(D), fp32_sum_error(G * span), fp32_sum_error(span)
    qg = q.float().reshape(B, S, Hkv, G, D)
    dog = do.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    qa, doa, ka, va = qg.abs(), dog.abs(), kf.abs(), vf.abs()
    delta = (do.float() * o.float()).sum(-1).reshape(B, S, Hkv, G).permute(0, 2, 3, 1)
    c = (do.float() * o.float()).abs().sum(-1).reshape(B, S, Hkv, G).permute(0, 2, 3, 1)
    lse_g = lse.reshape(B, Hkv, G, S)
    dq = torch.empty((B, S, Hkv, G, D), dtype=torch.float32, device=q.device)
    eq = torch.empty_like(dq)
    dk = torch.zeros((B, S, Hkv, D), dtype=torch.float32, device=q.device)
    dv, ek, ev = torch.zeros_like(dk), torch.zeros_like(dk), torch.zeros_like(dk)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        rows = slice(lo, hi)
        mask = _mask(S, lo, hi, window, q.device)
        s = torch.einsum("bshgd,bthd->bhgst", qg[:, rows], kf) * scale
        sa = torch.einsum("bshgd,bthd->bhgst", qa[:, rows], ka) * scale
        l_r = lse_g[..., lo:hi, None]
        p = torch.exp(s - l_r).masked_fill(~mask, 0.0)
        del s
        dp = torch.einsum("bshgd,bthd->bhgst", dog[:, rows], vf)
        dpa = torch.einsum("bshgd,bthd->bhgst", doa[:, rows], va)
        ds = p * (dp - delta[..., lo:hi, None])
        del dp
        eps_p = g_d * sa + 2.0 ** -20 * (1.0 + sa + l_r.abs())
        del sa
        dsa = ds.abs()
        # dS's error before its rounding: p's relative error, and dP's and
        # delta's fp32 sums; then its rounding to bf16
        e_ds = u * dsa + (1 + u) * (eps_p * dsa + p * g_d * (dpa + c[..., lo:hi, None]))
        del dpa
        e_p = (u + (1 + u) * eps_p) * p
        del eps_p
        dv += torch.einsum("bhgst,bshgd->bthd", p, dog[:, rows])
        dk += torch.einsum("bhgst,bshgd->bthd", ds, qg[:, rows]) * scale
        dq[:, rows] = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
        ev += torch.einsum("bhgst,bshgd->bthd", e_p + g_kv * p, doa[:, rows])
        ek += torch.einsum("bhgst,bshgd->bthd", e_ds + g_kv * dsa, qa[:, rows]) * scale
        eq[:, rows] = torch.einsum("bhgst,bthd->bshgd", e_ds + g_q * dsa, ka) * scale
        del p, ds, dsa, e_ds, e_p
    want = (dq.reshape(B, S, H, D), dk, dv)
    errs = (eq.reshape(B, S, H, D), ek, ev)
    # the store rounds the fp32 result (and dK, dQ take their scale in fp32)
    bound = tuple((1 + 4 * u) * e + (u + 2.0 ** -22) * (w.abs() + e)
                  for w, e in zip(want, errs, strict=True))
    return want, bound
