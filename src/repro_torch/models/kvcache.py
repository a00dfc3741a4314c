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

**A split pool** (the scheduler's ``mesh=`` mode): under a sharding policy
whose :class:`~repro_torch.dist.sharding.PoolShard` is a lane or head
shard, this rank's ``kp``/``vp`` hold lanes ``[lo, hi)`` of every page, or
kv heads ``[lo, hi)``, of the global pool; the page table and positions
stay global.  :func:`cache_update_layer` writes only the rank's lanes (the
others go to the scratch page, still without a host sync) or heads;
:func:`paged_attn_decode` runs the kernel per shard and merges across ranks;
:func:`attend_cache` assembles a chunk's attention over the shards in
plain torch.  Split rings (a :class:`~repro_torch.dist.sharding.RingShard`)
hold kv heads ``[lo, hi)``, or ring lanes ``[lo, hi)`` of the global T plus
one scratch lane, with ``positions`` split as ``k``/``v`` are; the same
three functions serve them, with T and the lanes always the global ones.

Pages are refcounted (:class:`PageAllocator`): a page may be mapped by
several slots, published in the :class:`PrefixIndex` and retained by a
parked session at once, and a writer copy-on-write splits a shared page
(:func:`copy_pages`) before it writes.  :func:`gather_pages` /
:func:`scatter_pages` move pages to and from host blobs (preemption and
parked-session offload), and :func:`gather_slot_state` /
:func:`scatter_slot_state` snapshot a slot's rows; the writers are in
place too.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dist.sharding import current_policy
from . import layers
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


def _pool_shard():
    """This rank's slice of a split pool (lane or head shard) from the
    active sharding policy, or None (no policy, or the pool is whole)."""
    policy = current_policy()
    pool = getattr(policy, "pool", None)
    return pool if pool is not None and pool.split else None


def _ring_shard():
    """This rank's slice of split rings (head or T shard) from the active
    sharding policy, or None."""
    ring = getattr(current_policy(), "ring", None)
    return ring if ring is not None and ring.split else None


def _page_size(layer_cache: Dict) -> int:
    """The pool's page size (the global one when this rank holds a lane
    shard)."""
    shard = _pool_shard()
    return shard.page_size if shard is not None else layer_cache["kp"].shape[-3]


def cache_capacity(layer_cache: Dict) -> int:
    """Token capacity of one row of a layer cache (ring T, or the page
    table's logical span for the pool; the global ones on a shard)."""
    if is_paged(layer_cache):
        return layer_cache["page_table"].shape[-1] * _page_size(layer_cache)
    shard = _ring_shard()
    return shard.T if shard is not None else layer_cache["k"].shape[-3]


def cache_update_layer(layer_cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor) -> Dict:
    """Write S_new tokens at absolute position ``pos``, in place.

    One layer's cache: ring ``k``/``v`` (B, T, Hkv, D) + ``positions``
    (B, T), or pool ``kp``/``vp`` (n_pages, page_size, Hkv, D) +
    ``page_table``.  k_new/v_new: (B, S, Hkv, D); ``pos`` scalar or (B,).
    On a ring shard (a :class:`~repro_torch.dist.sharding.RingShard` in the
    active policy) the lanes are the global ring's: a head shard writes its
    kv heads, a T shard the tokens whose lane ``abs_pos % T`` it holds, the
    others into its scratch lane, without a host sync.
    """
    if is_paged(layer_cache):
        return _paged_update_layer(layer_cache, k_new, v_new, pos)
    k, v, positions = layer_cache["k"], layer_cache["v"], layer_cache["positions"]
    shard = _ring_shard()
    T = shard.T if shard is not None else k.shape[1]
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
    if shard is not None and shard.mode == "head":
        lo, hi = shard.heads()
        k_new, v_new = k_new[:, :, lo:hi], v_new[:, :, lo:hi]
    elif shard is not None:
        # S <= T here, so each lane takes at most one token; the lanes of
        # other shards all go to the scratch lane past this shard's own
        lo, hi = shard.lanes()
        own = (slots >= lo) & (slots < hi)
        slots = torch.where(own, slots - lo, hi - lo)
    b = torch.arange(B, device=pos.device)[:, None]
    k[b, slots] = k_new.to(k.dtype)
    v[b, slots] = v_new.to(v.dtype)
    positions[b, slots] = abs_pos
    return layer_cache


def _paged_update_layer(layer_cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                        pos: torch.Tensor) -> Dict:
    kp, vp, pt = layer_cache["kp"], layer_cache["vp"], layer_cache["page_table"]
    shard = _pool_shard()
    page_size = _page_size(layer_cache)
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
    if shard is not None and shard.mode == "lane":
        # a lane shard holds lanes [lo, hi) of every page: the others'
        # tokens go to the scratch page too, still without a host sync
        lo, hi = shard.lanes()
        keep &= (offset >= lo) & (offset < hi)
        offset = (offset - lo).clamp(0, hi - lo - 1)
    elif shard is not None:
        lo, hi = shard.heads()
        k_new, v_new = k_new[:, :, lo:hi], v_new[:, :, lo:hi]
    pid = torch.where(keep, pid, kp.shape[0] - 1)
    kp[pid, offset] = k_new.to(kp.dtype)
    vp[pid, offset] = v_new.to(vp.dtype)
    return layer_cache


def cache_kv_view(layer_cache: Dict, upto: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, v, kv_positions, kv_valid) for :func:`layers.sdpa`.

    The ring is read directly (``positions`` doubles as the validity mask;
    a T shard's scratch lane is left out).  The pool is gathered in logical
    page order; ``upto`` (scalar or (B,) live length) is required there —
    lanes at or past it, and lanes on unmapped pages, are masked invalid.
    """
    if is_paged(layer_cache):
        if upto is None:
            raise ValueError("paged cache view needs `upto` (the live length)")
        return _paged_kv_view(layer_cache, upto)
    k, v, pos = layer_cache["k"], layer_cache["v"], layer_cache["positions"]
    shard = _ring_shard()
    if shard is not None and shard.scratch:
        n = k.shape[1] - shard.scratch
        k, v, pos = k[:, :n], v[:, :n], pos[:, :n]
    return k, v, pos, pos >= 0


def _paged_kv_view(layer_cache: Dict, upto: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The slot rows' pages gathered in logical order.  On a lane shard the
    view holds this rank's lanes of each page, at their global positions;
    on a head shard, its kv heads of every lane."""
    kp, vp, pt = layer_cache["kp"], layer_cache["vp"], layer_cache["page_table"]
    n_pages, page_size, n_kv, head_dim = kp.shape
    B, max_pages = pt.shape
    T = max_pages * page_size
    pid = pt.clamp(0, n_pages - 1).long()
    k = kp[pid].reshape(B, T, n_kv, head_dim)
    v = vp[pid].reshape(B, T, n_kv, head_dim)
    shard = _pool_shard()
    if shard is not None and shard.mode == "lane":
        lo, _ = shard.lanes()
        lane = torch.arange(page_size, dtype=torch.int32, device=pt.device)
        page = torch.arange(max_pages, dtype=torch.int32, device=pt.device)
        kv_pos = (page[:, None] * shard.page_size + lo + lane[None]).reshape(1, T).expand(B, T)
    else:
        kv_pos = torch.arange(T, dtype=torch.int32, device=pt.device)[None].expand(B, T)
    upto = upto.to(torch.int32)
    if upto.ndim == 0:
        upto = upto.expand(B)
    mapped = (pt >= 0).repeat_interleave(page_size, dim=-1)               # (B, T)
    return k, v, kv_pos, mapped & (kv_pos < upto[:, None])


def attend_cache(layer_cache: Dict, q: torch.Tensor, positions: torch.Tensor,
                 upto: torch.Tensor, *, window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of ``q`` (B, S, H, D) at ``positions`` over a layer
    cache's view up to ``upto`` (:func:`cache_kv_view` + :func:`layers.sdpa`:
    the chunk path, and S=1 decode on the ``gather`` backend).

    On a split pool or split rings each rank sees a slice of the view, so
    the attention is assembled across the ``model`` axis in plain torch (no
    kernel): a head shard attends its own kv heads' queries and the heads
    are gathered (a SUM of a zero-filled buffer); a lane shard of the pool
    or a T shard of the rings computes its lanes' scores,
    and the softmax is the fp32 running-max combine over shards (MAX of the
    row maxima, SUM of the exponentials) before the probabilities are
    rounded to the compute dtype, as :func:`layers.sdpa` rounds them, and
    the shards' P.V products are summed.  Equal to the unsharded call up to
    fp32 summation order."""
    ck, cv, kv_pos, kv_valid = cache_kv_view(layer_cache, upto=upto)
    shard = _pool_shard() if is_paged(layer_cache) else _ring_shard()
    if shard is None:
        return layers.sdpa(q, ck, cv, causal=True, window=window, q_positions=positions,
                           kv_positions=kv_pos, kv_valid=kv_valid)
    policy = current_policy()
    B, S, H, D = q.shape
    if shard.mode == "head":
        lo, hi = shard.heads()
        G = H // shard.n_kv_heads
        o = layers.sdpa(q[:, :, lo * G:hi * G], ck, cv, causal=True, window=window,
                        q_positions=positions, kv_positions=kv_pos, kv_valid=kv_valid)
        out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
        out[:, :, lo * G:hi * G] = o.float()
        return policy.all_reduce(out, "sum").to(q.dtype)
    Hkv = ck.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, ck).float() / math.sqrt(D)
    mask = layers._attn_mask(positions, kv_pos, kv_valid, True, window)
    scores = scores.masked_fill(~mask, layers.NEG_INF)
    m = policy.all_reduce(scores.amax(dim=-1), "max")
    e = torch.exp(scores - m[..., None])
    l = policy.all_reduce(e.sum(dim=-1), "sum")
    # the unsharded call streams past STREAM_KV_THRESHOLD with fp32
    # probabilities; below it, it rounds them to the compute dtype
    T = ck.shape[1] * shard.count
    if S > 1 and T >= layers.STREAM_KV_THRESHOLD and T % layers.STREAM_KV_BLOCK == 0:
        out = torch.einsum("bhgst,bthd->bshgd", e, cv.float())
        out = policy.all_reduce(out, "sum") / l.permute(0, 3, 1, 2)[..., None]
    else:
        p = (e / l[..., None]).to(q.dtype).float()
        out = policy.all_reduce(torch.einsum("bhgst,bthd->bshgd", p, cv.float()), "sum")
    return out.to(q.dtype).reshape(B, S, H, D)


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
    from ..kernels.paged_attention import paged_attention, sharded_paged_attention

    B = q.shape[0]
    pos = pos.to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B)
    lengths = pos + 1 if include_new else pos
    args = (q, layer_cache["kp"], layer_cache["vp"], layer_cache["page_table"], lengths)
    policy = current_policy()
    if policy is not None and policy.shard_map_pool:
        # the per-shard kernel over this rank's slice of the pool, and the
        # softmax merge across the model axis (the reference's shard_map)
        return sharded_paged_attention(*args, policy=policy, q_pos=pos, window=window,
                                       k_new=k_new, v_new=v_new)
    if _pool_shard() is not None:
        raise ValueError("a split pool needs the per-shard decomposition "
                         "(a policy with shard_map_pool)")
    return paged_attention(*args, q_pos=pos, window=window, k_new=k_new, v_new=v_new)


# ---------------------------------------------------------------------------
# Host-side page allocator (free list over the shared pool's page ids)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list allocator for the paged pool.

    Pure host-side bookkeeping: the device only ever sees the page table.
    Pages are a *shared* resource: :meth:`alloc` hands a page out with
    refcount 1, :meth:`share` takes an additional reference (a second slot
    mapping the page read-only, the prefix index publishing it, a parked
    session retaining it), and :meth:`release` drops one reference — the
    page only returns to the free list when its last reference dies.

    Invariants (checked by :meth:`check` and the scheduler's ``audit()``):
    ``free_count + in_use == n_pages``, every in-use page has refcount >= 1,
    no free page carries a refcount, no page is handed out twice, and
    :meth:`reset` returns the pool to fully free.
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
        """Sum of refcounts over mapped pages (== the mappings held by slots,
        the prefix index and parked sessions; the audit cross-checks)."""
        return sum(self._rc.values())

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

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

    def share(self, pages: Sequence[int]) -> None:
        """Take one extra reference on each (already mapped) page."""
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"sharing unmapped page {p}")
            self._rc[p] += 1

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

    # The name completion-time frees had before refcounts: one release.
    free = release

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
# Prefix index: content-addressed full pages for cross-request sharing
# ---------------------------------------------------------------------------


def page_hashes(tokens, page_size: int) -> List[bytes]:
    """Chain hashes of the *full* pages of a token sequence.

    ``h_i = H(h_{i-1} || tokens[i*ps : (i+1)*ps])`` (blake2b, 16-byte
    digest, int32 token bytes) — keyed on the whole token prefix, not the
    page content alone, so two sequences share a chain entry iff they agree
    on every token up to that page boundary.  Only full pages get a hash: a
    partial page's content is still growing and cannot be content-addressed.
    The bytes are the JAX package's, entry for entry.
    """
    arr = np.asarray(tokens, np.int32).reshape(-1)
    out: List[bytes] = []
    h = b"\x00" * 16
    for i in range(len(arr) // page_size):
        m = hashlib.blake2b(digest_size=16)
        m.update(h)
        m.update(arr[i * page_size:(i + 1) * page_size].tobytes())
        h = m.digest()
        out.append(h)
    return out


INDEX_JOURNAL_PREFIX = "index/"


class PrefixIndex:
    """Content-addressed map from token-chain hashes to resident pool pages.

    A full page whose tokens are fixed is an immutable journal entry, so it
    can be shared read-only by any request whose prompt carries the same
    token prefix.  The index holds **one allocator reference per published
    page** (taken via :meth:`PageAllocator.share` at publish time), which is
    what keeps a page alive after the slot that wrote it completes.  Pages
    are immutable once published: appends only ever write at
    ``pos >= length``, and a writer that must touch a shared page first
    copy-on-write splits it.

    Eviction is LRU over publish/hit order and only reclaims the *index's*
    reference — a page another slot or parked session still maps survives
    with its remaining refcount.

    The index itself is worker-local (physical page ids mean nothing outside
    one pool), but its *entries* are durable content: :meth:`journal` pushes
    each published page to a blob store under its chain hash, and
    :meth:`rebuild` re-adopts journaled pages into a fresh pool on worker
    start — how shared prefixes survive a fleet worker's death.
    """

    def __init__(self):
        self._pages: Dict[bytes, int] = {}       # chain hash -> physical page

    def __len__(self) -> int:
        return len(self._pages)

    @property
    def pages(self) -> List[int]:
        return list(self._pages.values())

    def has(self, h: bytes) -> bool:
        return h in self._pages

    @staticmethod
    def journal_key(h: bytes) -> str:
        """Blob-store key of one journaled entry: content-addressed by the
        token-chain hash, so concurrent workers journaling the same prefix
        write the same key with the same bytes (decode-written KV is bitwise
        prefill KV)."""
        return INDEX_JOURNAL_PREFIX + h.hex()

    def journal(self, pairs, blob_store, extract, pool_split: int = 1) -> int:
        """Persist ``(hash, physical page)`` entries to ``blob_store``: each
        page's contents are gathered via ``extract(page_ids) -> blob`` (a
        host blob) and PUT under :meth:`journal_key`, billed at the whole
        page's size (a split pool's blob is one of ``pool_split`` shards).
        Entries whose key is already stored are skipped (same hash, same
        bytes).  Returns how many blobs were written."""
        n = 0
        for h, pid in pairs:
            key = self.journal_key(h)
            if key in blob_store.blobs:
                continue
            blob = extract([int(pid)])
            blob_store.put(key, blob, blob_nbytes(blob, pool_split))
            n += 1
        return n

    def adopt(self, h: bytes, pid: int) -> None:
        """Record an entry whose allocator reference the caller *transfers*
        (vs :meth:`publish`, which takes its own): the rebuild path allocates
        a fresh page, scatters journaled contents into it, and hands the
        alloc-time reference straight to the index."""
        self._pages[h] = int(pid)

    def rebuild(self, blob_store, allocator, budget, install) -> int:
        """Re-adopt journaled entries into a fresh pool (worker cold start).

        For every ``index/<hash>`` blob in the store not already indexed,
        while ``budget()`` pages remain adoptable: allocate one page, call
        ``install(pid, blob)`` to scatter the journaled contents into it,
        and adopt the entry.  Entries that do not fit stay in the store — a
        missed entry just re-prefills.  Returns the number of pages
        adopted."""
        n = 0
        for key in list(blob_store.blobs):
            if not key.startswith(INDEX_JOURNAL_PREFIX):
                continue
            h = bytes.fromhex(key[len(INDEX_JOURNAL_PREFIX):])
            if h in self._pages:
                continue
            if budget() < 1:
                break
            pid = allocator.alloc(1)[0]
            install(pid, blob_store.get(key))
            self.adopt(h, pid)
            n += 1
        return n

    def publish(self, hashes: Sequence[bytes], page_ids: Sequence[int],
                allocator: PageAllocator) -> int:
        """Publish (hash, page) pairs not already indexed; the index takes
        one reference per page it actually adopts.  Returns how many."""
        n = 0
        for h, pid in zip(hashes, page_ids, strict=True):
            if h in self._pages:
                continue
            allocator.share([pid])
            self._pages[h] = int(pid)
            n += 1
        return n

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest indexed chain prefix: physical pages for ``hashes[:k]``
        where ``k`` is the first miss.  Hits are re-marked most recent."""
        out: List[int] = []
        for h in hashes:
            pid = self._pages.get(h)
            if pid is None:
                break
            self._pages[h] = self._pages.pop(h)   # LRU bump
            out.append(pid)
        return out

    def evict(self, allocator: PageAllocator, need_free: int,
              pinned: Sequence[int] = ()) -> int:
        """Drop LRU entries (releasing the index's reference) until the
        allocator has ``need_free`` free pages or every unpinned entry is
        gone.  ``pinned`` pages are skipped — the admission driving the
        eviction may be about to map them.  Returns the number dropped."""
        keep = set(pinned)
        n = 0
        for h in list(self._pages):               # LRU first
            if allocator.free_count >= need_free:
                break
            pid = self._pages[h]
            if pid in keep:
                continue
            allocator.release([self._pages.pop(h)])
            n += 1
        return n

    def clear(self, allocator: Optional[PageAllocator] = None) -> None:
        if allocator is not None:
            for pid in self._pages.values():
                allocator.release([pid])
        self._pages.clear()


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
                max_pages: int, device=None) -> Dict[str, torch.Tensor]:
    """A paged decode cache for ``n_slots`` slots on the model's device:
    a shared pool for the layers that keep K/V, an unmapped ``(n_slots,
    max_pages)`` page table, per-slot lengths and the model's per-slot
    recurrent rows (none for a dense model).  The pool holds ``n_pages``
    allocatable pages plus one scratch page at index ``n_pages`` that no
    table maps: writes through unmapped entries land there (the JAX package
    drops them as out-of-bounds scatters).  A model with no K/V layers (an
    SSM) gets no pool.  ``device`` puts the page table, the lengths and the
    pool elsewhere (the meta device, for their shapes alone); the recurrent
    rows stay on the model's."""
    cfg = model.cfg
    device = model.device if device is None else torch.device(device)
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
    slot's write lands at its length: in a page it owns past its live
    tokens (an ADMITTING slot's next chunk, or a RESTORING slot's next
    decode step, overwrites it before any read), or in the scratch page
    through an unmapped table row (EMPTY, PARKED and PREEMPTED slots have
    one).  The page under the length must never be shared: an admission
    over a resident prefix that ends inside a page copy-on-write splits
    that page before the next decode step, so the masked write cannot land
    in a page the prefix index, a parked session or another slot reads.
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


def _own_slice(key: str, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a per-slot ``leaf`` (slot axis 1) under the
    active policy, where the leaf is whole (its split axis at the global
    size): the ring shard's kv heads or lanes, the SSD state's heads.  A
    leaf that is already this rank's part, and every other leaf, comes
    back as it is."""
    ring = _ring_shard()
    if ring is not None and key in ("k", "v") and ring.mode == "head":
        lo, hi = ring.heads()
        return leaf[..., lo:hi, :] if leaf.shape[-2] == ring.n_kv_heads else leaf
    if ring is not None and key in RING_KEYS and ring.mode == "seq":
        lo, hi = ring.lanes()
        return leaf[:, :, lo:hi] if leaf.shape[2] == ring.T else leaf
    ssm = getattr(current_policy(), "ssm", None)
    if key == "ssm" and ssm is not None and ssm.split:
        lo, hi = ssm.heads()
        return leaf[:, :, lo:hi] if leaf.shape[2] == ssm.n_heads else leaf
    return leaf


def cache_insert_slot(batch_cache: Dict, one_cache: Dict, slot) -> Dict:
    """Copy a B=1 cache into row ``slot`` (an int or a 0-d int64 device
    tensor): the slot's length, its whole ring rows (``k``, ``v``,
    ``positions``: a ring prefill-on-admit) and its recurrent rows.  The
    pool and the page-table row of a chunk step on a
    :func:`cache_slot_view` were written through in place.  Under an
    active policy that splits the rings or the SSD state, a leaf of
    ``one_cache`` at the global size (a ring prefill run whole) gives
    ``batch_cache``, this rank's part, its slice (an int ``slot`` only; a
    T shard's scratch lane is left as it was)."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1)
        batch_cache["length"].index_copy_(0, idx, one_cache["length"].reshape(1))
        for key in _per_slot(batch_cache):
            batch_cache[key].index_copy_(1, idx, one_cache[key])
        return batch_cache
    batch_cache["length"][slot] = one_cache["length"].reshape(())
    for key in _per_slot(batch_cache):
        src = _own_slice(key, one_cache[key])[:, 0]
        dst = batch_cache[key][:, slot]
        if key in RING_KEYS:
            dst = dst.narrow(1, 0, src.shape[1])
        dst.copy_(src)
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


# ---------------------------------------------------------------------------
# Page-level offload and slot snapshots (preemption, sharing, parking)
# ---------------------------------------------------------------------------
#
# A blob is ``{"kp": (L, n, page_size, Hkv, D), "vp": ...}``: the pool
# leaves restricted to ``n`` pages, in the order their ids were given.  A
# slot snapshot is ``{"length": (1,), "h": (n_rec, 1, W), ...}``: every
# per-slot leaf at one slot, the slot axis kept.  The writers work in place
# (``index_copy_``) and return nothing: the scheduler's CUDA graphs read the
# pool, the rows and the lengths at the addresses they captured.

_PAGE_DIM = 1     # page axis of a pool leaf (L, n_pages + 1, page_size, Hkv, D)


def _ids(page_ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(page_ids, np.int64).reshape(-1)).to(device)


def gather_pages(cache: Dict, page_ids) -> Dict[str, torch.Tensor]:
    """Copy physical pages ``page_ids`` out of every pool leaf, on the
    pool's device.  The caller supplies the ids in *logical* order (the
    slot's page-table order), so the blob is position-ordered however
    scrambled the physical table is.  Exact inverse of
    :func:`scatter_pages` through any page table."""
    out = {}
    for key in sorted(POOL_KEYS):
        if key in cache:
            leaf = cache[key]
            out[key] = leaf.index_select(_PAGE_DIM, _ids(page_ids, leaf.device))
    return out


def scatter_pages(cache: Dict, page_ids, blob: Dict) -> None:
    """Write a page blob (on any device) into the pool at physical pages
    ``page_ids``, in place — the restore half of offload; the ids need not
    be those the blob was gathered from (the page table re-maps them).  A
    host blob crosses to the card one layer at a time: a restore chunk is a
    view along the page axis, so each layer's slice is one contiguous run
    (of pinned memory, for a blob :func:`to_host` made), while the whole
    view is not."""
    for key, src in blob.items():
        leaf = cache[key]
        if src.device != leaf.device:
            staged = torch.empty(src.shape, dtype=src.dtype, device=leaf.device)
            for layer in range(src.shape[0]):
                staged[layer].copy_(src[layer], non_blocking=True)
            src = staged
        leaf.index_copy_(_PAGE_DIM, _ids(page_ids, leaf.device), src.to(leaf.dtype))


def copy_pages(cache: Dict, src_ids, dst_ids) -> None:
    """Copy pool pages ``src_ids`` onto ``dst_ids``, in place: the
    copy-on-write split (a writer about to mutate a page with refcount > 1
    duplicates it onto a fresh page and remaps its own table; every other
    reference keeps reading the original bytes)."""
    for key in sorted(POOL_KEYS):
        if key in cache:
            leaf = cache[key]
            vals = leaf.index_select(_PAGE_DIM, _ids(src_ids, leaf.device))
            leaf.index_copy_(_PAGE_DIM, _ids(dst_ids, leaf.device), vals)


def gather_slot_state(cache: Dict, slot: int) -> Dict[str, torch.Tensor]:
    """Snapshot one slot's per-slot rows: its length and recurrent rows
    (and ring rows in ring mode) — everything but the shared pool and the
    page table, which the scheduler mirrors on the host.  A copy, on the
    cache's device; :func:`scatter_slot_state` is its exact inverse into
    any slot.  ``slot`` is a row of ``cache`` as this rank holds it (under
    a mesh, its local row; a head-split ``ssm`` snapshots this rank's
    heads)."""
    idx = torch.tensor([slot], device=cache["length"].device)
    out = {"length": cache["length"].index_select(0, idx)}
    for key in _per_slot(cache):
        out[key] = cache[key].index_select(1, idx)
    return out


def scatter_slot_state(cache: Dict, slot: int, state: Dict) -> None:
    """Install a :func:`gather_slot_state` snapshot (on any device) into row
    ``slot``, in place (the restore half of parked-slot eviction; the
    target slot need not be the one the snapshot came from)."""
    for key, src in state.items():
        leaf = cache[key]
        idx = torch.tensor([slot], device=leaf.device)
        leaf.index_copy_(0 if key == "length" else 1, idx,
                         src.to(device=leaf.device, dtype=leaf.dtype))


def slice_page_blob(blob: Dict, lo: int, hi: int) -> Dict[str, torch.Tensor]:
    """Pages ``[lo, hi)`` of a blob (views) — the unit of a chunked restore."""
    return {key: leaf[:, lo:hi] for key, leaf in blob.items()}


def blob_nbytes(blob: Dict, pool_split: int = 1) -> int:
    """Payload size of a page blob or a row snapshot (drives the storage
    billing).  ``pool_split``: the blob's pool leaves are this rank's
    ``1/pool_split`` of the pool (a lane or head shard), and the size billed
    is the whole blob's, so every rank bills what ``mesh=None`` bills."""
    return sum(leaf.numel() * leaf.element_size() * (pool_split if key in POOL_KEYS else 1)
               for key, leaf in blob.items())


def to_host(blob: Dict) -> Dict[str, torch.Tensor]:
    """A blob's leaves copied to host memory (the object store holds CPU
    tensors; a blob left on the card would free nothing).  Leaves on the
    card go to pinned memory, and the copies are waited for, so the blob
    is readable when this returns; CPU leaves pass through."""
    out, card = {}, None
    for key, leaf in blob.items():
        if leaf.device.type == "cuda":
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            out[key], card = host, leaf.device
        else:
            out[key] = leaf
    if card is not None:
        torch.cuda.current_stream(card).synchronize()
    return out
