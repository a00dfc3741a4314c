"""Decode-time caches: per-slot rings and the shared paged-block KV pool.

Two storage layouts behind one layer-level interface
(:func:`cache_update_layer` / :func:`cache_kv_view` dispatch on the keys).
A cache is a dict of tensors; KV leaves are stacked over layers.

**Ring** (solo generation, and the scheduler's ``kv_mode='ring'``)::

  k, v      : (L, B, T, Hkv, D)  ring buffer (T = window for SWA archs)
  positions : (L, B, T) int32    absolute position stored in each lane (-1 empty)
  length    : () or (B,) int32   absolute position of the next token

**Paged pool** (continuous-batching serving)::

  kp, vp     : (L, n_pages + 1, page_size, Hkv, D)  shared block pool; the
                                                    last page is scratch
  page_table : (B, max_pages) int32                 slot's logical->physical
                                                    map (-1 = unmapped)
  length     : (B,) int32

**Recurrent rows** (hybrid and SSM models, beside either layout)::

  h          : (n_rec, B, W) fp32                 RG-LRU state per slot
  ssm        : (n_layers, B, H, P, N) fp32        SSD state per slot
  conv       : (n_rec, B, K-1, W) bf16            conv tail per slot

The K/V leaves stack only the layers that keep K/V (``model.n_kv_layers``:
every layer of a dense model, the local-attention layers of a hybrid, none
of an SSM, whose paged cache has no pool at all).

Token at absolute position ``p`` of slot ``b`` lives at
``kp[:, page_table[b, p // page_size], p % page_size]``.  One page table
serves every layer (the JAX package replicates it per layer so its layer
scan carries one pytree; a Python loop over layers needs no copy).  Pages
are handed out by the host-side :class:`PageAllocator` (alloc-on-write,
free-on-completion).  Validity is derived, not stored: lane ``t`` is
attendable iff its page is mapped and ``t < upto``.

**K/V writes are in place.**  The JAX package returns a new cache from
every update; here ``cache_update_layer``, ``cache_clear_slot``,
``set_page_row`` and ``cache_insert_slot`` write into the caller's tensors,
so the pool is never copied.  A decode step returns new recurrent rows
instead (they are small), and :func:`mask_slot_rows` merges them into the
old rows in place, keeping the old ones for inactive slots.  A
write through an unmapped page-table entry goes to the scratch page, which
no table maps, so a freed slot's stale decode traffic can never land in a
page that now belongs to another slot.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .layers import COMPUTE_DTYPE

# Leaf keys of the shared page pool: no slot axis, never sliced per slot.
POOL_KEYS = frozenset({"kp", "vp"})
# Per-slot ring leaves, stacked over layers: the slot axis is 1.
RING_KEYS = ("k", "v", "positions")
# Per-slot recurrent leaves, stacked over layers: the slot axis is 1.
RECURRENT_KEYS = ("h", "conv", "ssm")


def init_attn_cache(n_layers: int, B: int, T: int, n_kv: int, head_dim: int,
                    device) -> Dict[str, torch.Tensor]:
    shape = (n_layers, B, T, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        "positions": torch.full((n_layers, B, T), -1, dtype=torch.int32, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_positions(pos: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(B, S) absolute query positions for a decode step; ``pos`` is the
    scalar shared length or a (B,) per-slot length vector."""
    pos = pos.to(torch.int32)
    if pos.ndim == 1:
        pos = pos[:, None]
    ar = torch.arange(S, dtype=torch.int32, device=pos.device)
    return (pos + ar).expand(B, S)


def is_paged(cache: Dict) -> bool:
    """A paged cache or layer cache (it has a page table; an SSM's paged
    cache has the table but no pool)."""
    return "page_table" in cache


def cache_capacity(layer_cache: Dict) -> int:
    """Token capacity of one row of a layer cache (ring T, or the page
    table's logical span for the pool)."""
    if is_paged(layer_cache):
        return layer_cache["page_table"].shape[-1] * layer_cache["kp"].shape[-3]
    return layer_cache["k"].shape[-3]


def cache_update_layer(layer_cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor) -> Dict:
    """Write S_new tokens at absolute position ``pos``, in place.

    One layer's cache: ring ``k``/``v`` (B, T, Hkv, D) + ``positions``
    (B, T), or pool ``kp``/``vp`` (n_pages, page_size, Hkv, D) +
    ``page_table``.  k_new/v_new: (B, S, Hkv, D); ``pos`` scalar or (B,).
    """
    if is_paged(layer_cache):
        return _paged_update_layer(layer_cache, k_new, v_new, pos)
    k, v, positions = layer_cache["k"], layer_cache["v"], layer_cache["positions"]
    T = k.shape[1]
    B, S = k_new.shape[0], k_new.shape[1]
    pos = pos.to(torch.int32)
    if S > T:
        # prefill longer than the (windowed) ring: only the trailing T
        # tokens can ever be attended to
        k_new, v_new = k_new[:, -T:], v_new[:, -T:]
        pos = pos + (S - T)
        S = T
    if pos.ndim == 0:
        pos = pos.expand(B)
    abs_pos = pos[:, None] + torch.arange(S, dtype=torch.int32, device=pos.device)
    slots = (abs_pos % T).long()
    b = torch.arange(B, device=pos.device)[:, None]
    k[b, slots] = k_new.to(k.dtype)
    v[b, slots] = v_new.to(v.dtype)
    positions[b, slots] = abs_pos
    return layer_cache


def _paged_update_layer(layer_cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                        pos: torch.Tensor) -> Dict:
    kp, vp, pt = layer_cache["kp"], layer_cache["vp"], layer_cache["page_table"]
    page_size = kp.shape[1]
    max_pages = pt.shape[-1]
    B, S = k_new.shape[0], k_new.shape[1]
    pos = pos.to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B)
    abs_pos = pos[:, None] + torch.arange(S, dtype=torch.int32, device=pos.device)
    page_idx = (abs_pos // page_size).long()
    offset = (abs_pos % page_size).long()
    pid = torch.gather(pt, 1, page_idx.clamp(0, max_pages - 1)).long()
    # unmapped / out-of-table positions go to the scratch page no table
    # maps, i.e. they are dropped: a freed or admitting slot's stale traffic
    # never lands in a page it does not own (and no host sync is needed to
    # filter them out)
    keep = (page_idx < max_pages) & (pid >= 0)
    pid = torch.where(keep, pid, kp.shape[0] - 1)
    kp[pid, offset] = k_new.to(kp.dtype)
    vp[pid, offset] = v_new.to(vp.dtype)
    return layer_cache


def cache_kv_view(layer_cache: Dict, upto: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, v, kv_positions, kv_valid) for :func:`layers.sdpa`.

    The ring is read directly (``positions`` doubles as the validity mask).
    The pool is gathered in logical page order; ``upto`` (scalar or (B,)
    live length) is required there — lanes at or past it, and lanes on
    unmapped pages, are masked invalid.
    """
    if is_paged(layer_cache):
        if upto is None:
            raise ValueError("paged cache view needs `upto` (the live length)")
        return _paged_kv_view(layer_cache, upto)
    pos = layer_cache["positions"]
    return layer_cache["k"], layer_cache["v"], pos, pos >= 0


def _paged_kv_view(layer_cache: Dict, upto: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    kp, vp, pt = layer_cache["kp"], layer_cache["vp"], layer_cache["page_table"]
    n_pages, page_size, n_kv, head_dim = kp.shape
    B, max_pages = pt.shape
    T = max_pages * page_size
    pid = pt.clamp(0, n_pages - 1).long()
    k = kp[pid].reshape(B, T, n_kv, head_dim)
    v = vp[pid].reshape(B, T, n_kv, head_dim)
    kv_pos = torch.arange(T, dtype=torch.int32, device=pt.device)[None].expand(B, T)
    upto = upto.to(torch.int32)
    if upto.ndim == 0:
        upto = upto.expand(B)
    mapped = (pt >= 0).repeat_interleave(page_size, dim=-1)               # (B, T)
    return k, v, kv_pos, mapped & (kv_pos < upto[:, None])


def paged_attn_decode(layer_cache: Dict, q: torch.Tensor, pos: torch.Tensor, *,
                      window: Optional[int] = None,
                      k_new: Optional[torch.Tensor] = None,
                      v_new: Optional[torch.Tensor] = None,
                      include_new: bool = False) -> torch.Tensor:
    """Table-indirect decode attention over the paged pool through the CUDA
    kernel (``attn_backend='paged_kernel'``): the slot's K/V pages stream
    straight from the pool, the gathered (B, T, Hkv, D) view never exists.

    ``pos`` is the slot's live length before this token's write (scalar or
    (B,)).  With ``k_new``/``v_new`` the just-projected token is appended in
    fp32 on top of the streamed softmax (the :func:`layers.sdpa_append`
    contract: the pre-update pool plus a rank-1 new-token term).  The pool
    may already hold the token at lane ``pos`` — writes are in place — but
    the kernel masks lanes ``>= lengths = pos``, so it is not read twice.
    With ``include_new`` the token was already written into the pool
    (hybrid local-attention layers) and lane ``pos`` itself is attended
    (lengths ``pos + 1``).  q: (B, 1, H, D).
    """
    from ..kernels.paged_attention import paged_attention

    B = q.shape[0]
    pos = pos.to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B)
    lengths = pos + 1 if include_new else pos
    return paged_attention(q, layer_cache["kp"], layer_cache["vp"],
                           layer_cache["page_table"], lengths, q_pos=pos,
                           window=window, k_new=k_new, v_new=v_new)


# ---------------------------------------------------------------------------
# Host-side page allocator (free list over the shared pool's page ids)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list allocator for the paged pool.

    Pure host-side bookkeeping: the device only ever sees the page table.
    :meth:`alloc` hands a page out with refcount 1 and :meth:`release` drops
    one reference — the page returns to the free list when its last
    reference dies.  (Extra references arrive with prefix sharing, which is
    not ported yet.)

    Invariants (checked by :meth:`check` and the scheduler's ``audit()``):
    ``free_count + in_use == n_pages``, every in-use page has refcount >= 1,
    no free page carries a refcount, and :meth:`reset` returns the pool to
    fully free.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))  # pop() -> 0 first
        self._rc: Dict[int, int] = {}       # page -> reference count (mapped only)
        self.high_water = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._rc)

    @property
    def total_refs(self) -> int:
        return sum(self._rc.values())

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free "
                f"of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.high_water = max(self.high_water, len(self._rc))
        return pages

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page with none left is freed."""
        for p in pages:
            rc = self._rc.get(p)
            if rc is None:
                raise ValueError(f"releasing unmapped page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1

    def check(self) -> None:
        """Raise if the allocator invariants do not hold."""
        if len(self._free) + len(self._rc) != self.n_pages:
            raise AssertionError(
                f"page leak: {len(self._free)} free + {len(self._rc)} mapped "
                f"!= {self.n_pages}")
        if any(rc < 1 for rc in self._rc.values()):
            raise AssertionError(f"mapped page with refcount < 1: {self._rc}")
        overlap = set(self._free) & set(self._rc)
        if overlap:
            raise AssertionError(f"pages both free and mapped: {overlap}")

    def reset(self) -> None:
        """Back to fully free; the high-water gauge restarts too."""
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._rc.clear()
        self.high_water = 0


# ---------------------------------------------------------------------------
# Batched-cache construction & slot-level surgery (scheduler support)
# ---------------------------------------------------------------------------


def batched_cache(model, n_slots: int, seq_len: int) -> Dict[str, torch.Tensor]:
    """A ring decode cache for ``n_slots`` independent sequences: the model's
    own cache (rings sized ``cache_len(seq_len)``, recurrent rows) with the
    shared scalar ``length`` widened to a per-slot ``(n_slots,)`` vector."""
    cache = dict(model.init_cache(n_slots, seq_len))
    cache["length"] = torch.zeros((n_slots,), dtype=torch.int32, device=model.device)
    return cache


def paged_cache(model, n_slots: int, *, page_size: int, n_pages: int,
                max_pages: int) -> Dict[str, torch.Tensor]:
    """A paged decode cache for ``n_slots`` slots on the model's device:
    a shared pool for the layers that keep K/V, an unmapped ``(n_slots,
    max_pages)`` page table, per-slot lengths and the model's per-slot
    recurrent rows (none for a dense model).  The pool holds ``n_pages``
    allocatable pages plus one scratch page at index ``n_pages`` that no
    table maps: writes through unmapped entries land there (the JAX package
    drops them as out-of-bounds scatters).  A model with no K/V layers (an
    SSM) gets no pool."""
    cfg, device = model.cfg, model.device
    cache = {
        "page_table": torch.full((n_slots, max_pages), -1, dtype=torch.int32,
                                 device=device),
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }
    if model.n_kv_layers:
        shape = (model.n_kv_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                 cfg.the_head_dim())
        for key in ("kp", "vp"):
            cache[key] = torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
    cache.update(model.recurrent_rows(n_slots))
    return cache


def _recurrent(cache: Dict):
    return [k for k in RECURRENT_KEYS if k in cache]


def _per_slot(cache: Dict):
    """Per-slot leaves stacked over layers (slot axis 1): ring and recurrent."""
    return [k for k in RING_KEYS + RECURRENT_KEYS if k in cache]


def mask_slot_rows(new_cache: Dict, old_cache: Dict, keep: torch.Tensor) -> Dict:
    """Keep a decode step's updates only for slots where ``keep`` is True,
    written into ``old_cache``'s own ``length`` and recurrent rows.

    A decode step replaces ``length`` and the recurrent rows with new
    tensors; each is merged into the old tensor in place (the new row where
    ``keep``, the old one elsewhere), so a batched step cannot advance an
    inactive slot's length or evolve its recurrent state, and the caller's
    tensors keep their storage (a CUDA graph replays into them).  Returns
    ``new_cache`` with those leaves replaced by the old cache's tensors.
    K/V writes are in place and are not restored.  In the pool an inactive
    slot's write lands in a page it owns past its length — overwritten by
    its next chunk before any read — or is dropped by an unmapped table row.
    In a ring it lands in the slot's own row, at lane ``length % T``: a ring
    slot is only ever EMPTY or ACTIVE (admission is one monolithic prefill),
    and :func:`cache_insert_slot` overwrites the whole row, every lane of
    ``k``, ``v`` and ``positions``, before the next request reads it."""
    out = dict(new_cache)
    for key in ("length", *_recurrent(new_cache)):
        old = old_cache[key]
        k = keep if key == "length" else keep.reshape((1, -1) + (1,) * (old.ndim - 2))
        out[key] = torch.where(k, new_cache[key], old, out=old)
    return out


def _slot_rows(leaf: torch.Tensor, dim: int, slot) -> torch.Tensor:
    """Row ``slot`` of ``leaf`` along ``dim``, kept as a size-1 axis: a view
    for an int, a copy (``index_select``) for a 0-d device tensor."""
    if isinstance(slot, torch.Tensor):
        return leaf.index_select(dim, slot.reshape(1))
    return leaf.narrow(dim, slot, 1)


def cache_slot_view(batch_cache: Dict, slot) -> Dict:
    """The B=1 cache of one slot: its page-table row, length, ring rows and
    recurrent rows, the pool passed through whole.  ``slot`` is an int (the
    rows are views into the batch cache) or a 0-d int64 device tensor (the
    rows are copies, so no host sync picks them; :func:`cache_insert_slot`
    writes back what the step changes, and the pool is written in place)."""
    view = {key: batch_cache[key] for key in POOL_KEYS if key in batch_cache}
    if "page_table" in batch_cache:
        view["page_table"] = _slot_rows(batch_cache["page_table"], 0, slot)
    view["length"] = _slot_rows(batch_cache["length"], 0, slot)
    for key in _per_slot(batch_cache):
        view[key] = _slot_rows(batch_cache[key], 1, slot)
    return view


def cache_clear_slot(batch_cache: Dict, slot) -> Dict:
    """Unmap one slot's page-table row, empty its ring rows (positions -1)
    and zero its length and recurrent rows, in place: fresh state for an
    admission (a request admitted into a reused slot must not start from its
    predecessor's state) and, on completion, an unmapped row so the freed
    slot's residual decode writes go to the scratch page.  ``slot`` is an
    int or a 0-d int64 device tensor."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1)
        if "page_table" in batch_cache:
            batch_cache["page_table"].index_fill_(0, idx, -1)
        batch_cache["length"].index_fill_(0, idx, 0)
        for key in _per_slot(batch_cache):
            batch_cache[key].index_fill_(1, idx, -1 if key == "positions" else 0)
        return batch_cache
    if "page_table" in batch_cache:
        batch_cache["page_table"][slot] = -1
    batch_cache["length"][slot] = 0
    for key in _per_slot(batch_cache):
        batch_cache[key][:, slot] = -1 if key == "positions" else 0
    return batch_cache


def set_page_row(batch_cache: Dict, slot: int, row) -> Dict:
    """Install a slot's (max_pages,) page-table row in place (a host copy:
    the scheduler calls it between steps, never inside a captured one)."""
    pt = batch_cache["page_table"]
    pt[slot] = torch.as_tensor(np.asarray(row, np.int32)).to(pt.device)
    return batch_cache


def cache_insert_slot(batch_cache: Dict, one_cache: Dict, slot) -> Dict:
    """Copy a B=1 cache into row ``slot`` (an int or a 0-d int64 device
    tensor): the slot's length, its whole ring rows (``k``, ``v``,
    ``positions``: a ring prefill-on-admit) and its recurrent rows.  The
    pool and the page-table row of a chunk step on a
    :func:`cache_slot_view` were written through in place."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1)
        batch_cache["length"].index_copy_(0, idx, one_cache["length"].reshape(1))
        for key in _per_slot(batch_cache):
            batch_cache[key].index_copy_(1, idx, one_cache[key])
        return batch_cache
    batch_cache["length"][slot] = one_cache["length"].reshape(())
    for key in _per_slot(batch_cache):
        batch_cache[key][:, slot] = one_cache[key][:, 0]
    return batch_cache


def kv_bytes_per_token(cache: Dict) -> int:
    """Bytes of K/V state per stored token, summed over layers (pool ``kp``/
    ``vp`` or ring ``k``/``v`` leaves; recurrent rows are O(1) per slot and
    left out)."""
    total = 0
    for key in ("kp", "vp", "k", "v"):
        if key in cache:
            leaf = cache[key]              # (L, Np, ps, H, D) or (L, B, T, H, D)
            total += leaf.numel() * leaf.element_size() // (leaf.shape[1] * leaf.shape[2])
    return total
