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

Over a pool split across the ``model`` axis of a mesh (the reference's
``shard_map`` decomposition), :func:`sharded_paged_attention` runs the
kernel once per rank on its slice (:func:`paged_shard_partials`: a lane
slice of every page through ``lane_base``/``pos_stride``, or a head slice)
and merges the shards' states with collectives
(:func:`merge_shard_states`); :func:`sharded_paged_attention_local` is the
same decomposition over all shards in one process.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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
    return _finish(q, qg, acc, m, l, k_new, v_new, kp.dtype)


def _finish(q, qg, acc, m, l, k_new, v_new, pool_dtype) -> torch.Tensor:
    """Splice the new token (append mode) into the streamed softmax state
    and normalize: ``(B, Hkv, G, D)`` state -> ``(B, 1, H, D)`` in q.dtype."""
    B, Hkv, G, D = qg.shape
    if k_new is not None:
        # splice the new token's logit into the streamed softmax (fp32);
        # round k/v through the pool dtype first so the result is consistent
        # with the write-then-gather formulation
        kn = k_new.to(pool_dtype).reshape(B, Hkv, D).float()
        vn = v_new.to(pool_dtype).reshape(B, Hkv, D).float()
        s_new = torch.einsum("bhgd,bhd->bhg", qg.float(), kn) / math.sqrt(D)
        m_tot = torch.maximum(m, s_new)
        alpha = torch.exp(m - m_tot)
        beta = torch.exp(s_new - m_tot)
        acc = acc * alpha[..., None] + beta[..., None] * vn[:, :, None, :]
        l = l * alpha + beta
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, Hkv * G, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Per-shard decomposition over a split pool
# ---------------------------------------------------------------------------

SHARD_MODES = ("lane", "head")


def _shard_range(total: int, shard: int, n_shards: int) -> Tuple[int, int]:
    if total % n_shards:
        raise ValueError(f"{total} does not split into {n_shards} shards")
    w = total // n_shards
    return shard * w, (shard + 1) * w


def pool_shard(kp: torch.Tensor, shard: int, n_shards: int, mode: str) -> torch.Tensor:
    """Shard ``shard`` of ``n_shards`` of a full pool ``(..., n_pages,
    page_size, Hkv, D)``, contiguous: lanes ``[shard * ps/n, (shard + 1) *
    ps/n)`` of every page (``"lane"``) or kv heads ``[shard * Hkv/n, ...)``
    (``"head"``)."""
    if mode not in SHARD_MODES:
        raise ValueError(f"mode must be one of {SHARD_MODES}, got {mode!r}")
    dim = kp.ndim - 3 if mode == "lane" else kp.ndim - 2
    lo, hi = _shard_range(kp.shape[dim], shard, n_shards)
    return kp.narrow(dim, lo, hi - lo).contiguous()


def paged_shard_partials(qg: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         q_pos: torch.Tensor, *, shard: int, n_shards: int, mode: str,
                         page_size: int, window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's ``(acc, m, l)`` over one shard's slice of the pool.

    ``qg`` (B, Hkv, G, D) holds every kv head's queries; ``kp``/``vp`` are
    the shard's slice of the pool (:func:`pool_shard`).  ``"lane"``: the
    kernel runs over ``page_size / n_shards`` lanes of every page, lane
    ``t`` of page ``j`` at position ``j * page_size + shard * page_size /
    n_shards + t`` (``lane_base`` and ``pos_stride``), for every head.
    ``"head"``: the kernel runs the shard's kv heads over whole pages, and
    the state covers only those heads.  On a CUDA tensor the kernel
    launches (or raises); on the CPU its plain version runs."""
    if mode == "lane":
        lo, _ = _shard_range(page_size, shard, n_shards)
        return paged_attention_kernel(qg, kp, vp, page_table, lengths, q_pos,
                                      lane_base=lo, pos_stride=page_size, window=window)
    if mode != "head":
        raise ValueError(f"mode must be one of {SHARD_MODES}, got {mode!r}")
    lo, hi = _shard_range(qg.shape[1], shard, n_shards)
    return paged_attention_kernel(qg[:, lo:hi].contiguous(), kp, vp, page_table, lengths,
                                  q_pos, window=window)


def merge_shard_states(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *, mode: str,
                       policy=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the shards' softmax states into the whole pool's.

    ``"lane"``: the fp32 running-max combine — ``m_tot = max m``, ``alpha =
    exp(m - m_tot)``, ``l = sum l * alpha``, ``acc = sum acc * alpha``; an
    empty shard ``(0, -1e30, 0)`` drops out.  ``"head"``: the shards' head
    groups side by side.

    With ``policy=None`` the states carry a leading shard dim and merge in
    this process.  With a :class:`~repro_torch.dist.sharding.ShardingPolicy`
    they are this rank's shard and merge through collectives over the
    ``model`` axis: ``all_reduce(MAX)`` of ``m``, then one
    ``all_reduce(SUM)`` of the rescaled ``acc`` and ``l`` (lane), or one
    ``all_reduce(SUM)`` of a zero-filled buffer of every head's state in
    which each rank writes its heads (head).  Every rank ends with the
    whole state."""
    if policy is None:
        if mode == "lane":
            m_tot = m.amax(dim=0)
            alpha = torch.exp(m - m_tot)
            return (acc * alpha[..., None]).sum(dim=0), m_tot, (l * alpha).sum(dim=0)
        if mode == "head":
            return (torch.cat(list(acc), dim=1), torch.cat(list(m), dim=1),
                    torch.cat(list(l), dim=1))
        raise ValueError(f"mode must be one of {SHARD_MODES}, got {mode!r}")
    if mode == "lane":
        m_tot = policy.all_reduce(m.clone(), "max")
        alpha = torch.exp(m - m_tot)
        buf = torch.cat([(acc * alpha[..., None]).reshape(-1), (l * alpha).reshape(-1)])
        policy.all_reduce(buf, "sum")
        n = acc.numel()
        return buf[:n].view_as(acc), m_tot, buf[n:].view_as(l)
    if mode != "head":
        raise ValueError(f"mode must be one of {SHARD_MODES}, got {mode!r}")
    pool = policy.pool
    B, Hl, G, D = acc.shape
    buf = acc.new_zeros((B, Hl * pool.count, G, D + 2))
    lo, hi = pool.heads()
    buf[:, lo:hi, :, :D] = acc
    buf[:, lo:hi, :, D] = m
    buf[:, lo:hi, :, D + 1] = l
    policy.all_reduce(buf, "sum")
    return buf[..., :D], buf[..., D], buf[..., D + 1]


def _decode_inputs(q, page_table, lengths, q_pos):
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError("paged_attention is a decode (S=1) kernel")
    lengths = _per_slot(lengths, B, q.device).contiguous()
    q_pos = lengths if q_pos is None else _per_slot(q_pos, B, q.device).contiguous()
    return lengths, q_pos, page_table.contiguous()


def sharded_paged_attention_local(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                                  page_table: torch.Tensor, lengths, *, n_shards: int,
                                  mode: str, q_pos=None,
                                  k_new: Optional[torch.Tensor] = None,
                                  v_new: Optional[torch.Tensor] = None,
                                  window: Optional[int] = None) -> torch.Tensor:
    """The in-process form of :func:`sharded_paged_attention`: the whole
    pool is cut into ``n_shards`` slices (:func:`pool_shard`), the kernel
    runs once per slice, and the states merge over a stacked shard dim
    (:func:`merge_shard_states` with no policy) before the new token is
    spliced in and the result normalized.  Same signature and result as
    :func:`paged_attention`, up to fp32 summation order."""
    B, _, H, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    lengths, q_pos, page_table = _decode_inputs(q, page_table, lengths, q_pos)
    qg = q.reshape(B, Hkv, H // Hkv, D).contiguous()
    parts = [paged_shard_partials(qg, pool_shard(kp, r, n_shards, mode),
                                  pool_shard(vp, r, n_shards, mode), page_table, lengths,
                                  q_pos, shard=r, n_shards=n_shards, mode=mode,
                                  page_size=ps, window=window)
             for r in range(n_shards)]
    acc, m, l = merge_shard_states(*(torch.stack(x) for x in zip(*parts)), mode=mode)
    return _finish(q, qg, acc, m, l, k_new, v_new, kp.dtype)


def sharded_paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                            page_table: torch.Tensor, lengths, *, policy, q_pos=None,
                            k_new: Optional[torch.Tensor] = None,
                            v_new: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """:func:`paged_attention` decomposed over the ``model`` axis of a live
    mesh: ``kp``/``vp`` are this rank's slice of the pool, laid out as
    ``policy.pool`` says (``cache_shardings``' pool rule), and q, the page
    table, the lengths and the new token are this rank's slot rows with
    every head (dense compute is replicated over ``model``).

    * **lane** (``page_size % |model| == 0``, the pool rule's first pick):
      the kernel runs over the rank's lanes of every page through
      ``lane_base``/``pos_stride``; the partial states merge with the fp32
      running-max combine (``all_reduce`` MAX then SUM over ``model``) and
      the new token is spliced in after the merge.  Not bitwise the
      unsharded kernel (summation order), the same fp32 contract.
    * **head** (kv heads divide ``model``): the kernel runs the rank's kv
      heads; the states are gathered head by head (one SUM of a zero-filled
      buffer), then spliced and normalized as one.

    A replicated pool (``|model| == 1``, or neither divides and the pages
    did not either) makes the plain unsharded call; a page-sharded pool is
    refused where the policy is built.  The bytes each collective sends
    are counted on ``policy`` (``collective_bytes()``), and they do not
    depend on the pool's size."""
    pool = policy.pool
    if pool is None or not pool.split:
        return paged_attention(q, kp, vp, page_table, lengths, q_pos=q_pos, k_new=k_new,
                               v_new=v_new, window=window)
    B, _, H, D = q.shape
    Hkv = pool.n_kv_heads
    lengths, q_pos, page_table = _decode_inputs(q, page_table, lengths, q_pos)
    qg = q.reshape(B, Hkv, H // Hkv, D).contiguous()
    acc, m, l = paged_shard_partials(qg, kp, vp, page_table, lengths, q_pos, shard=pool.index,
                                     n_shards=pool.count, mode=pool.mode,
                                     page_size=pool.page_size, window=window)
    acc, m, l = merge_shard_states(acc, m, l, mode=pool.mode, policy=policy)
    return _finish(q, qg, acc, m, l, k_new, v_new, kp.dtype)
