"""Model-layout wrapper: (B, 1, H, D) + pool layout -> kernel + append.

Two call modes, matching how the decode paths use the gathered view:

* **append** (``k_new``/``v_new`` given): attention over the *pre-update*
  pool plus an explicit rank-1 term for the just-projected token — the
  paged analogue of :func:`repro_torch.models.layers.sdpa_append`.  The
  kernel streams the pool pages; the one extra logit is spliced into the
  streamed softmax here in fp32 via the kernel's ``(m, l)`` state.
* **post-update** (no ``k_new``): the token was already written into the
  pool; the kernel's accumulator is simply normalized.  ``lengths`` then
  counts the new token too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kernel import paged_attention_kernel
from .ref import _per_slot


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    page_table: torch.Tensor, lengths, *, q_pos=None,
                    k_new: Optional[torch.Tensor] = None,
                    v_new: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, D); kp/vp: (n_pages, page_size, Hkv, D);
    page_table: (B, max_pages) int32; lengths: (B,) attendable pool tokens.

    ``q_pos`` (B,) is the query's absolute position (defaults to
    ``lengths`` — the append case, where the query sits one past the live
    prefix); ``k_new``/``v_new`` (B, 1, Hkv, D) enable append mode.
    Returns (B, 1, H, D) in q.dtype.
    """
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError("paged_attention is a decode (S=1) kernel")
    Hkv = kp.shape[2]
    G = H // Hkv
    lengths = _per_slot(lengths, B, q.device)
    q_pos = lengths if q_pos is None else _per_slot(q_pos, B, q.device)

    qg = q.reshape(B, Hkv, G, D).contiguous()
    acc, m, l = paged_attention_kernel(qg, kp, vp, page_table.contiguous(),
                                       lengths.contiguous(), q_pos.contiguous(),
                                       window=window)
    if k_new is not None:
        # splice the new token's logit into the streamed softmax (fp32);
        # round k/v through the pool dtype first so the result is consistent
        # with the write-then-gather formulation
        kn = k_new.to(kp.dtype).reshape(B, Hkv, D).float()
        vn = v_new.to(vp.dtype).reshape(B, Hkv, D).float()
        s_new = torch.einsum("bhgd,bhd->bhg", qg.float(), kn) / math.sqrt(D)
        m_tot = torch.maximum(m, s_new)
        alpha = torch.exp(m - m_tot)
        beta = torch.exp(s_new - m_tot)
        acc = acc * alpha[..., None] + beta[..., None] * vn[:, :, None, :]
        l = l * alpha + beta
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
