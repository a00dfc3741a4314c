"""Plain PyTorch versions of the paged-attention decode kernel.

* :func:`paged_attention_plain` has the kernel's own contract — the
  unnormalized fp32 online-softmax state ``(acc, m, l)`` over the pool, rows
  with no live lane as ``(0, -1e30, 0)`` — computed in one dense pass
  instead of a page loop.  The wrapper in ``kernel.py`` runs it for tensors
  on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on the card.
* :func:`paged_attention_split_plain` runs :func:`paged_attention_plain`
  over each page split of :mod:`.plan` and merges the states with
  :func:`merge_partials`: what the kernel computes when it splits a
  slot's pages, in plain PyTorch.
* :func:`reference_paged_attention` is the end-to-end oracle: the slot's
  pages gathered in logical order and dense fp32 softmax attention,
  optionally with the appended new token (the gather path the kernel
  replaces).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .plan import live_pages, split_pages

NEG_INF = -1e30


def _per_slot(x, B: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.expand(B) if x.ndim == 0 else x


def paged_attention_plain(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          q_pos: torch.Tensor, *, lane_base: int = 0,
                          pos_stride: Optional[int] = None,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: (B, Hkv, G, D); kp/vp: (n_pages, page_size, Hkv, D);
    page_table: (B, max_pages) int32, -1 = unmapped; lengths/q_pos: (B,).

    Returns ``(acc, m, l)``: acc (B, Hkv, G, D) fp32 unnormalized, m/l
    (B, Hkv, G) fp32.  Lane ``t`` of page ``j`` sits at position
    ``j * pos_stride + lane_base + t``."""
    B, Hkv, G, D = q.shape
    n_pages, ps = kp.shape[0], kp.shape[1]
    max_pages = page_table.shape[1]
    pos_stride = ps if pos_stride is None else pos_stride
    lengths = _per_slot(lengths, B, q.device)
    q_pos = _per_slot(q_pos, B, q.device)
    pt = page_table.long()
    pid = pt.clamp(0, n_pages - 1)
    k = kp[pid].reshape(B, max_pages * ps, Hkv, D).float()
    v = vp[pid].reshape(B, max_pages * ps, Hkv, D).float()
    t_pos = (torch.arange(max_pages, device=q.device)[:, None] * pos_stride
             + lane_base + torch.arange(ps, device=q.device)[None, :]).reshape(-1)
    live = (pt >= 0).repeat_interleave(ps, dim=1) & (t_pos[None] < lengths[:, None])
    if window is not None:
        live &= t_pos[None] > (q_pos - window)[:, None]
    qs = q.float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bthd->bhgt", qs, k)
    mask = live[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    return acc, m, l


def merge_partials(parts) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the ``(acc, m, l)`` states of disjoint lane sets, in order:
    m is the max of the m's, acc and l the sums rescaled by ``exp(m_s -
    m)``.  An empty state ``(0, -1e30, 0)`` drops out, and states that are
    all empty merge to ``(0, -1e30, 0)``."""
    accs, ms, ls = zip(*parts)
    m = torch.stack(ms).amax(dim=0)
    acc, l = torch.zeros_like(accs[0]), torch.zeros_like(ls[0])
    for a_s, m_s, l_s in parts:
        w = torch.exp(m_s - m)
        acc = acc + a_s * w[..., None]
        l = l + l_s * w
    return acc, m, l


def paged_attention_split_plain(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                                page_table: torch.Tensor, lengths: torch.Tensor,
                                q_pos: torch.Tensor, *, n_split: int, lane_base: int = 0,
                                pos_stride: Optional[int] = None,
                                window: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_attention_plain` over each of ``n_split`` splits of every
    slot's live pages (``plan.live_pages``, ``plan.split_pages``; the pages
    outside a split are unmapped for it), merged by :func:`merge_partials`."""
    B, max_pages = page_table.shape
    ps = kp.shape[1]
    pos_stride = ps if pos_stride is None else pos_stride
    lengths = _per_slot(lengths, B, q.device)
    q_pos = _per_slot(q_pos, B, q.device)
    ranges = [live_pages(int(lengths[b]), int(q_pos[b]), window, lane_base, pos_stride, ps,
                         max_pages) for b in range(B)]
    page = torch.arange(max_pages, device=page_table.device)[None]
    parts = []
    for s in range(n_split):
        lo, hi = (torch.tensor(x, device=page_table.device)[:, None] for x in zip(
            *(split_pages(a, b, n_split, s) for a, b in ranges)))
        pt = torch.where((page >= lo) & (page < hi), page_table, -1).to(torch.int32)
        parts.append(paged_attention_plain(q, kp, vp, pt, lengths, q_pos, lane_base=lane_base,
                                           pos_stride=pos_stride, window=window))
    return merge_partials(parts)


def reference_paged_attention(q: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, page_table: torch.Tensor,
                              lengths, *, q_pos=None,
                              k_new: Optional[torch.Tensor] = None,
                              v_new: Optional[torch.Tensor] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Same signature and semantics as :func:`..ops.paged_attention`:
    q (B, 1, H, D) -> (B, 1, H, D) in q.dtype."""
    B, S, H, D = q.shape
    assert S == 1
    n_pages, page_size, Hkv, _ = kp.shape
    G = H // Hkv
    max_pages = page_table.shape[1]
    T = max_pages * page_size
    lengths = _per_slot(lengths, B, q.device)
    q_pos = lengths if q_pos is None else _per_slot(q_pos, B, q.device)

    pt = page_table.long()
    pid = pt.clamp(0, n_pages - 1)
    k = kp[pid].reshape(B, T, Hkv, D).float()
    v = vp[pid].reshape(B, T, Hkv, D).float()
    kv_pos = torch.arange(T, device=q.device)[None]
    valid = (pt >= 0).repeat_interleave(page_size, dim=-1)
    valid &= kv_pos < lengths[:, None]
    if window is not None:
        valid &= kv_pos > (q_pos - window)[:, None]

    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if k_new is not None:
        kn = k_new.to(kp.dtype).reshape(B, Hkv, D).float()
        vn = v_new.to(vp.dtype).reshape(B, Hkv, D).float()
        s_new = torch.einsum("bhgd,bhd->bhg", qg, kn) / math.sqrt(D)
        s = torch.cat([s, s_new[..., None]], dim=-1)
        v = torch.cat([v, vn[:, None]], dim=1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v)
    return out.reshape(B, 1, H, D).to(q.dtype)
