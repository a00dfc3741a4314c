"""Slot-based continuous-batching decode scheduler over a paged KV pool
(or per-slot rings).

A fixed-width decode batch (``n_slots``) steps one token per active slot per
call; free slots are re-admitted from a shared cross-session queue of pending
requests.  Every slot runs the explicit lifecycle in
:mod:`repro_torch.serve.lifecycle`::

    EMPTY -> ADMITTING -> ACTIVE -> (PREEMPTED -> RESTORING -> ACTIVE)* -> DRAINED

KV lives in one shared ``(n_pages, page_size, Hkv, D)`` pool per layer plus
a per-slot page table (:func:`repro_torch.models.kvcache.paged_cache`).
Pages are handed out by a host-side refcounted free list
(:class:`~repro_torch.models.kvcache.PageAllocator`) — mapped on first
write, released on completion — so KV memory scales with live tokens, not
``n_slots * max_seq``.  Admission is **chunked**: the prompt is split into
``prefill_chunk``-sized pieces and one chunk runs per :meth:`step` (a B=1
forward against the shared pool, interleaved with the batch's decode step),
so a long prompt never stalls the other slots for more than one chunk.
Admission is reservation-gated: a request is admitted only when the pool's
uncommitted pages cover its worst case, so lazy mapping can never deadlock
mid-decode.

**Storage-backed preemption** (``offload=True``, paged mode): durable state
belongs in cloud storage, compute is reclaimable.  When a pending request
is pool-gated, the preemption policy picks victims among the ACTIVE slots
(longest resident first, then most pages pinned; ``idle_preempt_steps`` is
the minimum residency), gathers each victim's pages through its page table
into a position-ordered blob, copies it to host memory, puts it in the
:class:`~repro_torch.core.storage.PageBlobStore`, and releases the pages
and the victim's whole reservation.  The victim sits in PREEMPTED: its rows
(recurrent state, length, output ring) stay frozen under the decode mask,
but it pins no pool capacity.  When pool pressure clears (no pending request
is pool-gated and the uncommitted margin covers the victim's worst case),
the blob is fetched and written back **chunk by chunk, interleaved with
decode like prefill chunks** onto freshly allocated pages, and the slot
resumes ACTIVE — token for token a never-preempted run, because gather and
scatter are exact inverses through the page table and the masked rows never
advanced.  Restores are FIFO in preemption order and run to completion once
funded, so offload cannot deadlock or livelock the pool.  Storage traffic is
journaled on the blob store and billed by the serving frontend.

**Refcounted copy-on-write prefix sharing** (``prefix_sharing=True``, paged
mode): completed requests publish their *full* pages — generated span
included, since decode-written KV is bitwise prefill KV — into a
content-addressed :class:`~repro_torch.models.kvcache.PrefixIndex` keyed by
token-chain hashes, and a new request whose prompt carries an indexed prefix
maps those pages **read-only** (one extra reference each) and prefills only
its tail.  Any write through a page with refcount > 1 first copy-on-write
splits the page onto a fresh one and remaps only the writer's table row.
Index sharing serves only pure-attention families (dense, moe): recurrent
rows cannot be rebuilt from KV pages.

**Cross-request session parking** (``park_sessions=True``): a completed slot
enters PARKED instead of releasing its pages; a per-session record takes
ownership of the page references, the token history and (once the slot is
reclaimed) a host snapshot of the slot's rows, so the session's next request
— whose prompt extends the recorded history — maps the parked pages shared
and prefills only the new tokens.  Parked capacity is reclaimable: a new
admission may take the slot (rows snapshot to the record), and under pool
pressure parked pages offload through the blob store, after which the next
request restores the blob instead of re-prefilling.  ``park_ttl_steps``
bounds retention.  ``reset()`` clears the prefix index, the parked table and
(by default) the blob store.

The batched decode step masks non-ACTIVE slots out of the token write, the
output ring, the length advance and (hybrid models) the recurrent rows
(:func:`kvcache.mask_slot_rows`).  Their K/V writes still happen: each lands
at the slot's length in a page it owns (past its live tokens), or in the
scratch page through an unmapped row — EMPTY, PARKED and PREEMPTED slots
have one.  An admission over a resident prefix that ends inside a page
splits that shared page at once, before the next decode step, so the masked
write cannot reach a page another holder reads.

Per-session FIFO is structural: a session's next request is admitted only
after its predecessor completes, and the pending list is scanned in arrival
order.

``attn_backend='paged_kernel'`` sends every S=1 decode layer through the
CUDA paged-attention kernel; ``'gather'`` materializes each slot's pages
and runs the chunk path at S=1.  Chunked prefill always gathers.

An MoE model is attention-only here, as a dense one is: its layers keep
K/V and no recurrent rows, and it routes drop-free in every step (a
token's expert output does not depend on what shares its step).

An SSM keeps no K/V: its paged cache has a page table but no pool, the
allocator holds 0 pages, admissions reserve none, and only its per-slot
recurrent rows (``ssm``, ``conv``) are masked, cleared and written back;
offload, sharing and parking do nothing for it.

``kv_mode='ring'`` is the baseline the pool replaces: every slot owns a
ring sized ``cache_len(max_seq)`` (:func:`kvcache.batched_cache`), and
admission is one monolithic ``model.prefill(prompt, seq_len=max_seq)``
whose cache is copied whole into the slot's rows (EMPTY -> ACTIVE within
one call).  A from-scratch prefill of STREAM_KV_THRESHOLD tokens or more
attends its fresh k/v through the flash-attention kernel.  There is no
pool, so ``paged_kernel``, offload, sharing and parking are refused, and
``reset``/``audit`` have no pool to touch.

On a CUDA device the batched decode step and the ``prefill_chunk``-token
chunk step each run as a CUDA graph (:mod:`repro_torch.serve.graphs`),
captured at their first call and replayed after, the counterpart of the
reference's jitted steps.  The decode step is fixed-shape and mask-only:
every row is computed, and ``active`` decides per row what is kept.  Both
steps read their inputs from, and write their results into, tensors whose
storage never moves: the cache, ``last_tokens``, ``out_buf``, ``out_pos``,
the ``active`` mask and the chunk's token and slot buffers.  So every write
the scheduler makes between steps — a restored or copy-on-write page, a
reinstalled row, a rewound length, a page-table row — goes into those
tensors in place; a rebound tensor would raise no error, the graphs would
go on reading the old storage.  A chunk of another length (a prompt's tail,
or the whole prompt when ``prefill_chunk`` is None) and ring mode's
monolithic prefill run eagerly on the same kernels.  On the CPU every step
runs eagerly.

**Draft-and-verify speculative decoding** (``draft_model=..., spec_k=k``;
paged, ``gather`` and greedy only): a draft model (dense or moe, the
target's vocab, its own per-slot ring) proposes ``k`` tokens per active
slot per tick; the target scores them and the pending canonical token in
one chunked step against the shared pool and accepts the longest prefix
that matches its own argmax, emitting 1..k+1 tokens a round
(:meth:`_spec_round`).  Every emitted token is the target's argmax over a
canonical prefix, so the stream is the non-speculative one wherever the
verify chunk computes what S=1 steps compute, which the port holds on the
CPU.  Rejected K/V is rewound by length, and a hybrid target's recurrent
rows are restored and the accepted span replayed on a partial accept.  On
the card the draft step and the verify step replay their own graphs; the
catch-up, whose width changes every round, and the hybrid replay run
eagerly.

**Fleet hooks** (:mod:`repro_torch.serve.fleet`): ``index_journal=True``
journals every published prefix-index page to the (shared) blob store
under its chain hash, ``blob_ns`` namespaces this worker's transient blob
keys (``kv/<ns>...`` spills, ``park/<ns>...`` journals),
:meth:`externalize_session` detaches a parked journal as host data plus a
blob key, :meth:`adopt_parked` installs one a dead worker left, and
:meth:`adopt_index_journal` scatters journaled index pages into this
worker's pool in place (the graphs read the pool they captured).

**Mesh mode** (``mesh=`` a ``(data, model)`` ``DeviceMesh`` over the live
process group, ``launch/mesh.make_smoke_mesh``): explicit SPMD.  Every rank
is one process that runs this same host logic on the same submits and holds
plain local tensors, placed by
:func:`repro_torch.dist.sharding.serving_cache_specs`: the pool's lanes of
every page on ``model``, else its kv heads (replicated over ``data``); the
rings' kv heads on ``model``, else their T axis (each rank keeps one
scratch lane past its own); the SSD state's heads on ``model``; page
tables, lengths, the rings, the SSD state and the recurrent rows by slot on
``data`` when ``n_slots`` divides, else replicated.  So each rank holds
``1/|model|`` of the pool, the rings and the SSD state, and the conv tails
and RG-LRU state of its slots whole.  A decode step runs the rank's slot
rows (dense compute replicated over ``model``; the paged kernel per lane
or head shard, or a ring shard's scores, the softmax states merged across
``model`` by ``all_reduce``; the SSD scan per head shard, its output
gathered over ``model``) and shares the next tokens over ``data``, so
every rank's host state stays identical.  A chunk, or ring mode's
monolithic prefill, runs on every rank of the owning slot's ``model``
group and its first token is shared the same way; the ring prefill runs
whole (the flash kernel at 4096 tokens or more, replicated over
``model``) and each rank keeps its slice of the ring.  The page moves of
offload, sharing and parking run on every rank, each on its own part of
the pool, with no collective: a blob is this rank's lanes or heads of its
pages (each rank's blob store holds its own, under the same key), billed
at the whole blob's size.  The fleet's hand-over works the same way: an
index-journal blob is this rank's shard of the page, and a parked record
(:meth:`externalize_session`, :meth:`adopt_parked`) carries the whole slot
rows and the key of this rank's blob shard; both are read back only on the
mesh shape that wrote them (a record from another ``(data, model)`` shape
is refused).  A slot's rows (length and recurrent state,
snapshot when a parked slot is reclaimed) move over ``data`` as a SUM of a
zero-filled buffer, so a session may come back in a slot another data
group holds.  The steps run under the policy's scope
(:func:`..dist.sharding.activation_sharding`) and eagerly: a collective
cannot be captured in a CUDA graph.  The MoE family runs each layer on
the rank's expert shard (:class:`..dist.sharding.ExpertShard`; the model,
from ``build_model(..., mesh=)``, holds only those experts) with one
all-reduce over ``model`` a layer; ring mode's
prefill runs under the policy without its state shards
(``ShardingPolicy.whole_state``).  Speculation runs the reference's mesh
branch: the draft has a ring placed as ring mode's (kv heads on
``model``, else T) and a policy of its own (a MoE draft holds that
policy's experts; a self-draft is the target's module), each data group
runs the catch-up, the draft steps and the verify chunk on its own slots'
rows, and the verify's tokens and each slot's acceptance are shared over
``data`` in one collective a round (``last_round_wire_bytes``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.storage import PageBlobStore
from ..dist import sharding
from ..dist.compat import DeviceMesh
from ..kernels.moe_experts.kernel import launch_kind
from ..models import kvcache
from . import sampling
from .engine import (make_chunk_step, make_draft_catchup_step, make_draft_step,
                     make_offload_steps, make_spec_verify_step, spec_emit)
from .graphs import StepGraphs
from .lifecycle import Slot, SlotState

CONTINUOUS_FAMILIES = ("dense", "moe", "ssm", "hybrid")

PREEMPT_POLICIES = ("none", "pressure")


def supports_continuous(cfg) -> bool:
    return getattr(cfg, "family", None) in CONTINUOUS_FAMILIES


@dataclasses.dataclass
class _Request:
    session: str
    request_id: str
    prompt: Any                 # (P,) int tokens
    max_new: int
    submit_step: int = 0
    hashes: Any = None          # prompt page-chain hashes, computed once (a
    # held request is re-matched every _fill_slots pass)


@dataclasses.dataclass
class CompletedRequest:
    session: str
    request_id: str
    tokens: np.ndarray          # (max_new,) generated tokens
    admitted_step: int
    finished_step: int
    submitted_step: int = 0     # admission stall = admitted - submitted
    preempts: int = 0           # times this request was preempted mid-decode
    reused_tokens: int = 0      # prompt tokens served from shared/parked pages


@dataclasses.dataclass
class ParkedSession:
    """The durable half of a parked session: the KV-page journal a completed
    request leaves behind so its session's next request restores instead of
    re-prefilling.  Owns one allocator reference per resident page; the
    journal is immutable (writers copy-on-write split), dropped only when
    superseded by a longer history, diverged from, expired, or reset."""

    session: str
    history: np.ndarray         # prompt + generated tokens
    consumed: int               # tokens whose KV/recurrent state is captured
    # (decode-written KV is bitwise what a re-prefill would write — the S=1
    # decode path IS the chunk path at S=1 — so the whole consumed span is
    # reusable, generated tokens included)
    page_row: np.ndarray        # logical -> physical page map at park time
    pages: List[int]            # resident page references the record owns
    slot: Optional[int] = None  # still holding its slot (rows live on the card)
    state: Any = None           # host row snapshot once the slot is reclaimed
    blob_key: Optional[str] = None        # pages offloaded under pool pressure
    blob_pidx: List[int] = dataclasses.field(default_factory=list)
    parked_step: int = 0
    mesh_shape: Optional[tuple] = None    # (data, model) of the mesh that wrote it


@dataclasses.dataclass
class _MatchPlan:
    """How much of an arriving prompt is already resident, and where."""

    kind: str = "none"          # none | park | park-blob | index
    C: int = 0                  # matched tokens (their KV will be reused)
    pages: List[int] = dataclasses.field(default_factory=list)  # logical order
    record: Optional[ParkedSession] = None


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


def _same_everywhere(params, group=None) -> None:
    """Raise unless every rank of ``group`` (default: all) holds the same
    ``params``: two all-reduced checksums (a ramp-weighted and an absolute
    sum of the leaves' sums)."""
    import torch.distributed as dist

    sums = torch.stack([p.detach().float().sum() for p in params]).double().cpu()
    ramp = torch.arange(1, len(sums) + 1, dtype=torch.float64)
    local = torch.stack([(sums * ramp).sum(), sums.abs().sum()])
    hi, lo = local.clone(), -local
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(hi, -lo):
        raise RuntimeError(f"ranks hold different weights (checksums span {(-lo).tolist()} "
                           f"to {hi.tolist()}): build every rank's model from one seed")


def ranks_agree(record, group=None) -> bool:
    """Whether every rank of ``group`` (default: all) holds the same
    ``record`` (stats dicts, event tuples: anything whose ``repr`` is equal
    for equal values): its SHA-256 words all-reduced by MAX and by MAX of
    their negations, as :func:`_same_everywhere` checks weights."""
    import hashlib

    import torch.distributed as dist

    words = np.frombuffer(hashlib.sha256(repr(record).encode()).digest(), dtype=np.int32)
    local = torch.from_numpy(words.astype(np.int64))
    hi, lo = local.clone(), -local
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
    return torch.equal(hi, -lo)


class DecodeScheduler:
    """Continuous batching over a shared paged pool (or per-slot rings)."""

    def __init__(self, model, *, n_slots: int = 4, max_seq: int = 64,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 kv_mode: str = "paged", page_size: int = 16,
                 kv_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 offload: bool = False,
                 preempt_policy: Optional[str] = None,
                 idle_preempt_steps: int = 0,
                 blob_store: Optional[PageBlobStore] = None,
                 prefix_sharing: bool = False,
                 park_sessions: bool = False,
                 park_ttl_steps: int = 0,
                 attn_backend: str = "gather", device="cuda",
                 mesh=None, index_journal: bool = False,
                 draft_model=None, spec_k: int = 0):
        if not supports_continuous(model.cfg):
            raise ValueError(
                f"family {model.cfg.family!r} has no per-slot decode path here; "
                f"continuous batching supports {CONTINUOUS_FAMILIES}")
        if kv_mode not in ("paged", "ring"):
            raise ValueError(f"kv_mode must be 'paged' or 'ring', got {kv_mode!r}")
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                # the reference also takes an abstract mesh, to compute the
                # cache's specs without placing it (the dry run's use)
                raise _not_ported(f"mesh= of type {type(mesh).__name__} (a live DeviceMesh "
                                  f"from launch/mesh.make_smoke_mesh is served; the spec-only "
                                  f"abstract mesh is ROADMAP 1.9)")
        if attn_backend not in ("gather", "paged_kernel"):
            raise ValueError("attn_backend must be 'gather' or 'paged_kernel', "
                             f"got {attn_backend!r}")
        device = torch.device(device)
        if model.device.type != device.type:
            raise ValueError(f"model is on {model.device}, scheduler on {device}")
        self._has_kv = model.n_kv_layers > 0     # an SSM's state is pool-free
        if attn_backend == "paged_kernel":
            if kv_mode != "paged":
                raise ValueError(
                    "attn_backend='paged_kernel' streams the shared page pool "
                    "through the CUDA kernel; it needs kv_mode='paged'")
            if not self._has_kv:
                raise ValueError("attn_backend='paged_kernel' needs attention layers; "
                                 "SSM decode has no KV pool")
            # rebind a shallow copy (shared weights) so a gather-mode
            # scheduler sharing this model object keeps the reference dispatch
            model = copy.copy(model)
            model.cfg = dataclasses.replace(model.cfg, attn_backend="paged_kernel")
        if preempt_policy is None:
            preempt_policy = "pressure" if offload else "none"
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"preempt_policy must be one of {PREEMPT_POLICIES}, "
                             f"got {preempt_policy!r}")
        if offload and kv_mode != "paged":
            raise ValueError("KV offload needs the paged pool (kv_mode='paged'); "
                             "per-slot rings have no page granularity to evict")
        if (prefix_sharing or park_sessions) and kv_mode != "paged":
            raise ValueError(
                "prefix sharing / session parking need the paged pool "
                "(kv_mode='paged'); per-slot rings have no shareable pages")
        self.attn_backend = attn_backend
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.top_k = top_k
        self.kv_mode = kv_mode
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        paged_kv = kv_mode == "paged" and self._has_kv
        self.offload = bool(offload) and paged_kv
        self.preempt_policy = preempt_policy if self.offload else "none"
        self.idle_preempt_steps = idle_preempt_steps
        # -- prefix sharing / session parking -------------------------------
        self.prefix_sharing = bool(prefix_sharing) and paged_kv
        self.park_sessions = bool(park_sessions) and paged_kv
        self.park_ttl_steps = park_ttl_steps
        # index sharing rebuilds state from KV pages alone, which only
        # pure-attention families allow (hybrid conv/RG-LRU rows are not in
        # the pool); parking keeps the rows, so it covers every family
        self._attention_only = model.cfg.family in ("dense", "moe")
        self._index_sharing = self.prefix_sharing and self._attention_only
        self.prefix_index = kvcache.PrefixIndex()
        # fleet mode: journal every published index entry to the (shared)
        # blob store so shared prefixes survive this worker's death, and
        # namespace this worker's transient blob keys (preempt spills,
        # parked-journal offloads) so a dead worker's keys can be garbage
        # collected without racing a successor's
        self.index_journal = bool(index_journal) and self._index_sharing
        self.blob_ns = ""
        self.index_journal_puts = 0
        self.index_adopted = 0
        self._parked: Dict[str, ParkedSession] = {}
        self.shared_prefix_tokens = 0   # prompt tokens never re-prefilled
        self.park_hits = 0
        self.park_misses = 0
        self.index_hits = 0
        self.cow_splits = 0
        self.parks = 0
        self.park_evictions = 0         # parked slots reclaimed for admissions
        self.park_offloads = 0          # parked page sets pushed to the blob store
        self.park_expirations = 0

        self.page_size = page_size
        self.max_pages = -(-max_seq // page_size)
        self.n_pages = kv_pages if kv_pages is not None else n_slots * self.max_pages
        if not paged_kv:
            self.n_pages = 0
        elif self.n_pages < self.max_pages:
            raise ValueError(f"kv_pages={self.n_pages} cannot hold even one slot's "
                             f"max_pages={self.max_pages}")
        self.prefill_chunk = prefill_chunk   # None -> whole prompt, one chunk
        self.allocator = kvcache.PageAllocator(self.n_pages)
        # host mirror of the device page table + pages committed to
        # admitted-but-not-yet-mapped growth (the admission gate)
        self._page_rows = np.full((n_slots, self.max_pages), -1, np.int32)
        self._reserved = 0
        self._mesh = mesh
        self._mesh_shape = tuple(int(n) for n in mesh.shape) if mesh is not None else None
        self._policy = None
        self._draft_policy = None
        self._rows: Optional[slice] = None     # this rank's slot rows (mesh mode)
        self._slot_split = False               # slots placed on data (mesh mode)
        self.last_step_wire_bytes = 0          # collective bytes of the last decode step
        self.last_step_wire_ms = 0.0           # ... and their host ms
        self.last_chunk_wire_bytes = 0         # ... of the last chunk this rank ran
        self.last_chunk_wire_ms = 0.0
        self.last_round_wire_bytes = 0         # ... of the last speculation round
        self.last_round_wire_ms = 0.0
        self.chunks_run = 0                    # prefill chunks (or ring prefills) this rank ran
        self.row_wire_bytes = 0                # collective bytes of slot-row moves (mesh mode)
        self.page_wire_bytes = 0               # ... of page moves: none by design
        self.kv_share_bytes = 0                # ... of written K/V shared over data
        if mesh is not None:
            self.cache = self._place_cache(model, mesh)
            self._check_same_weights(model)
        elif kv_mode == "paged":
            self.cache = kvcache.paged_cache(model, n_slots, page_size=page_size,
                                             n_pages=self.n_pages, max_pages=self.max_pages)
        else:
            self.cache = kvcache.batched_cache(model, n_slots, max_seq)
        if kv_mode == "paged":
            self._chunk = make_chunk_step(model, policy=self._policy)
        # where slots split over data, a data group computes (and writes the
        # K/V of) its own slots alone; once pages can be read or stored
        # outside the slot that wrote them, every write is shared over data,
        # so each data group's copy of the pool holds every page
        self._share_kv = (mesh is not None and self._slot_split and paged_kv
                          and (self.offload or self.prefix_sharing or self.park_sessions))

        # -- offload plumbing ------------------------------------------------
        self.blob_store = blob_store if blob_store is not None else PageBlobStore()
        self._extract, self._inject = make_offload_steps(policy=self._policy)
        # billed blob size: a lane or head shard holds 1/count of each page
        self._pool_split = (self._policy.pool.count
                            if self._policy is not None and self._policy.pool is not None
                            and self._policy.pool.split else 1)
        # restore chunking mirrors prefill chunking: a restore step moves
        # about one prefill chunk's worth of tokens (>= 1 page)
        self._restore_chunk_pages = (max(1, prefill_chunk // page_size)
                                     if kv_mode == "paged" and prefill_chunk else None)
        self._preempted_order: List[int] = []   # slot indices, FIFO restores
        self.preemptions = 0
        self.restores = 0
        self.restore_chunks = 0
        self.offload_pages = 0
        self.restored_pages = 0

        # -- draft-and-verify speculative decoding ---------------------------
        self.spec_k = int(spec_k)
        self._spec = draft_model is not None and self.spec_k >= 1
        if self._spec:
            self._init_spec(draft_model, temperature)
        self.spec_rounds = 0
        self.spec_proposed = 0          # draft tokens offered to the verifier
        self.spec_accepted = 0          # draft tokens accepted
        self.spec_emitted = 0           # tokens emitted by verify rounds
        self.spec_rollbacks = 0         # hybrid partial accepts replayed

        self.slots: List[Slot] = [Slot(index=i) for i in range(n_slots)]
        # device-side per-slot output ring: tokens accumulate on device and
        # are pulled to the host once per completion, not once per step
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.out_buf = torch.zeros((n_slots, max_seq), dtype=torch.int32, device=self.device)
        self.out_pos = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        # static inputs of the graphed steps: the decode step's slot mask,
        # and the full-size chunk's tokens and slot index
        self._active = torch.zeros((n_slots,), dtype=torch.bool, device=self.device)
        self._chunk_tokens = torch.zeros((1, prefill_chunk or 0), dtype=torch.int32,
                                         device=self.device)
        self._chunk_at = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graphs = (StepGraphs(self.device, self._gen)
                       if self.device.type == "cuda" and mesh is None else None)
        self.pending: List[_Request] = []
        self._active_sessions: set = set()
        self._chunk_rr = 0            # round-robin over admitting slots
        self._restore_rr = 0          # round-robin over restoring slots
        # -- occupancy / throughput accounting --------------------------------
        self.steps = 0
        self.slot_steps = 0           # sum over steps of active slots
        self.page_step_sum = 0        # sum over steps of pages in use
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.decode_tokens = 0
        self.admitted = 0
        self.completed = 0

    # -- mesh mode -----------------------------------------------------------------

    def _build_policy(self, model, mesh, pool, ring, ssm) -> sharding.ShardingPolicy:
        """ShardingPolicy for one model on the live mesh: slots on dp when
        they divide, heads on model when the kv-head count divides (else the
        seq fallback), the per-shard paged kernel for the fused backend, and
        this rank's slices of the pool, the rings and the SSD state."""
        rules = sharding.MeshRules.for_mesh(mesh)
        msize = rules.model_size(mesh)
        cfg = model.cfg
        n_kv = getattr(cfg, "n_kv_heads", 0) or getattr(cfg, "n_heads", 1)
        experts = None
        if cfg.family == "moe":
            experts = sharding.ExpertShard.for_mesh(mesh, cfg.moe.n_experts)
            if model.expert_shard != experts:
                raise ValueError(f"the model holds {model.expert_shard} but this rank of the "
                                 f"mesh computes {experts}: build it with "
                                 f"build_model(..., mesh=mesh)")
        return sharding.ShardingPolicy.default(
            mesh,
            batch_shardable=bool(rules.dp) and self.n_slots % rules.dp_size(mesh) == 0,
            attn_mode="head" if n_kv % msize == 0 else "seq",
            decode_stationary=True,
            shard_map_pool=self.attn_backend == "paged_kernel",
            pool=pool, ring=ring, ssm=ssm, experts=experts)

    def _place_cache(self, model, mesh) -> Dict[str, torch.Tensor]:
        """This rank's part of the cache (paged or rings), by
        :func:`~repro_torch.dist.sharding.serving_cache_specs`: the global
        cache's shapes are laid out on fake tensors (nothing allocated) and
        each leaf allocated at its local shape, so no rank ever holds the
        whole pool, rings or SSD state; a T-split ring gets its scratch lane.
        Builds the policy and this rank's slot rows."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        rules = sharding.MeshRules.for_mesh(mesh)
        if rules.axis_names != ("data", "model"):
            raise ValueError(f"the scheduler takes a ('data', 'model') mesh, got "
                             f"{rules.axis_names}")
        with FakeTensorMode():
            if self.kv_mode == "paged":
                glob = kvcache.paged_cache(model, self.n_slots, page_size=self.page_size,
                                           n_pages=self.n_pages, max_pages=self.max_pages)
            else:
                glob = kvcache.batched_cache(model, self.n_slots, self.max_seq)
        shapes = {key: tuple(leaf.shape) for key, leaf in glob.items()}
        placed = sharding.cache_shardings({k: glob[k] for k in ("kp", "k", "ssm") if k in glob},
                                          mesh)
        pool = (sharding.PoolShard.for_pool(placed["kp"], shapes["kp"], mesh)
                if "kp" in glob else None)
        ring = (sharding.RingShard.for_ring(placed["k"], shapes["k"], mesh)
                if "k" in glob else None)
        ssm = (sharding.SSMShard.for_state(placed["ssm"], shapes["ssm"], mesh)
               if "ssm" in glob else None)
        self._policy = self._build_policy(model, mesh, pool, ring, ssm)
        cache, specs = self._allocate(glob, mesh, ring)
        rows = sharding.local_shard(torch.arange(self.n_slots), specs["length"], mesh)
        self._rows = slice(int(rows[0]), int(rows[-1]) + 1)
        self._slot_split = len(rows) < self.n_slots
        return cache

    def _allocate(self, glob, mesh, ring) -> tuple:
        """This rank's leaves of the global cache ``glob`` (fake tensors),
        placed by :func:`~repro_torch.dist.sharding.serving_cache_specs`
        and allocated at their local shapes (a T-split ring with its
        scratch lane); returns them and the specs."""
        specs = sharding.serving_cache_specs(glob, mesh,
                                             batch_shardable=self._policy.batch_shardable)
        cache = {}
        for key, leaf in glob.items():
            shape = list(sharding.local_shard(torch.empty(tuple(leaf.shape), device="meta"),
                                              specs[key], mesh).shape)
            if key in kvcache.RING_KEYS and ring.scratch:
                shape[2] += ring.scratch
            fill = -1 if key in ("page_table", "positions") else 0
            cache[key] = torch.full(shape, fill, dtype=leaf.dtype, device=self.device)
        return cache, specs

    def _place_draft_cache(self, draft_model, depth: int) -> Dict[str, torch.Tensor]:
        """This rank's part of the draft's per-slot ring, placed as ring
        mode places a target's (kv heads on ``model``, else T with a
        scratch lane; slots on ``data`` where they divide), and the draft's
        own policy (the reference's ``_build_policy(draft_model, mesh)``)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        mesh = self._mesh
        with FakeTensorMode():
            glob = kvcache.batched_cache(draft_model, self.n_slots, depth)
        placed = sharding.cache_shardings({"k": glob["k"]}, mesh)
        ring = sharding.RingShard.for_ring(placed["k"], tuple(glob["k"].shape), mesh)
        self._draft_policy = self._build_policy(draft_model, mesh, None, ring, None)
        return self._allocate(glob, mesh, ring)[0]

    def _check_same_weights(self, model) -> None:
        """Every rank must hold the same weights (each builds its model from
        the same seed): an all-reduced checksum, once.  A rank holding only
        its experts checks them against its ``data`` group (the ranks of its
        ``model`` coordinate), and every other leaf against every rank."""
        split = model.cfg.family == "moe" and model.expert_shard.split
        named = list(model.named_parameters())
        _same_everywhere([p for n, p in named if not (split and ".moe.experts." in n)])
        if split:
            _same_everywhere([p for n, p in named if ".moe.experts." in n],
                             self._mesh.get_group("data"))

    def _local_row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's cache, or None where another data
        group holds it."""
        if self._rows is None:
            return slot
        return slot - self._rows.start if self._rows.start <= slot < self._rows.stop else None

    def _set_row(self, slot: int) -> None:
        """Push the host page-table row of ``slot`` to the device."""
        row = self._local_row(slot)
        if row is not None:
            kvcache.set_page_row(self.cache, row, self._page_rows[slot])

    def _clear_row(self, slot: int) -> None:
        row = self._local_row(slot)
        if row is not None:
            kvcache.cache_clear_slot(self.cache, row)

    def _set_length(self, slot: int, n: int) -> None:
        row = self._local_row(slot)
        if row is not None:
            self.cache["length"][row] = n

    def _put_rows(self, slot: int, state: Dict[str, torch.Tensor]) -> None:
        """Install a row snapshot (:meth:`_snapshot_rows`) into ``slot``'s
        rows, where this rank holds them."""
        row = self._local_row(slot)
        if row is not None:
            kvcache.scatter_slot_state(self.cache, row, state)

    def _share_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The (n_slots,) tokens of every slot from this rank's rows: a SUM
        over ``data`` of a zero-filled buffer each data group writes its rows
        into (the identity where slots are not split)."""
        if not self._slot_split:
            return local
        full = torch.zeros((self.n_slots,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[self._rows] = local
        return self._policy.all_reduce(full, "sum", axis="data")

    def held_bytes(self, keys) -> int:
        """Bytes of the cache leaves ``keys`` this process holds."""
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   for k in keys if k in self.cache)

    def pool_bytes(self) -> int:
        """Bytes of the pool this process holds (``1/|model|`` of the whole
        pool under a split mesh)."""
        return self.held_bytes(kvcache.POOL_KEYS)

    def ring_scratch_bytes(self) -> int:
        """Bytes of the K/V scratch lanes of T-split rings (none otherwise)."""
        ring = self._policy.ring if self._policy is not None else None
        if ring is None or not ring.scratch:
            return 0
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   // self.cache[k].shape[2] * ring.scratch for k in ("k", "v"))

    def _init_spec(self, draft_model, temperature: float) -> None:
        """Refuse what speculative decoding cannot serve (the reference's
        checks, the same ``ValueError``s), then build the draft's ring, the
        three steps and the static buffers their graphs read and write."""
        if self.kv_mode != "paged" or not self._has_kv:
            raise ValueError(
                "speculative decoding verifies chunks against the shared "
                "paged pool; it needs kv_mode='paged' and a KV-bearing "
                "target (dense/moe/hybrid)")
        if temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only: accept/reject compares "
                "the target's argmax, which temperature sampling does not produce")
        if self.attn_backend != "gather":
            raise ValueError(
                "speculative decoding needs attn_backend='gather': the paged "
                "kernel only serves S=1 steps, so a verify chunk would switch "
                "dispatch mid-request")
        if getattr(draft_model.cfg, "family", None) not in ("dense", "moe"):
            raise ValueError(
                "draft family must be dense or moe: the draft rewinds to the "
                "accepted prefix every round, which recurrent state cannot do cheaply")
        if draft_model.cfg.vocab != self.model.cfg.vocab:
            raise ValueError(f"draft vocab {draft_model.cfg.vocab} != target vocab "
                             f"{self.model.cfg.vocab}")
        if draft_model.device != self.device:
            raise ValueError(f"draft model is on {draft_model.device}, "
                             f"target on {self.device}")
        self.draft_model = draft_model
        # per-slot ring sized for the deepest proposal the draft reaches (the
        # page table's span can overhang max_seq by a partial page) plus the
        # batched catch-up's back-padding: a round's widest pending span W
        # pads every row, so a row at canonical length L writes (never read)
        # lanes up to L + W - 1; with L <= span + k and W <= max_seq + 1 the
        # ring must be deeper than that, or a pad write would wrap onto a
        # live lane
        depth = 2 * self.max_pages * self.page_size + self.spec_k + 2
        if self._mesh is None:
            self.draft_cache = kvcache.batched_cache(draft_model, self.n_slots, depth)
        else:
            self.draft_cache = self._place_draft_cache(draft_model, depth)
            if draft_model is not self.model:
                self._check_same_weights(draft_model)
        self._draft_catchup = make_draft_catchup_step(draft_model, policy=self._draft_policy)
        self._draft_step = make_draft_step(draft_model, policy=self._draft_policy)
        self._verify = make_spec_verify_step(self.model, max_seq=self.max_seq,
                                             policy=self._policy)
        # static storage of the verify and draft graphs: the verify tokens
        # (column 0 the target's newest token, then the k drafts, newest
        # last), each slot's acceptance cap, the draft step's new token, and
        # a hybrid target's recurrent rows as they were before the verify
        i32 = dict(dtype=torch.int32, device=self.device)
        self._vtok = torch.zeros((self.n_slots, self.spec_k + 1), **i32)
        self._k_eff = torch.zeros((self.n_slots,), **i32)
        self._dtok = torch.zeros((self.n_slots,), **i32)
        self._spec_rows = {key: torch.zeros_like(self.cache[key])
                           for key in ("h", "conv") if key in self.cache}

    # -- admission ----------------------------------------------------------------

    def submit(self, session: str, request_id: str, prompt, max_new: int) -> None:
        """Enqueue a request; admitted into a free slot as soon as its
        session has no in-flight predecessor (per-session FIFO gate) and the
        pool's uncommitted pages cover its worst case (or the preemption
        policy can evict enough to make them).

        ``max_new`` is clamped to what the slot can hold: the output ring
        caps it at ``max_seq``, and on full attention generation past
        ``max_seq - len(prompt)`` would wrap the ring or run off the page
        table; a prompt that leaves no decode room is rejected outright.
        Windowed rings wrap by design; the page table is linear, so windowed
        families are bounded by its ``max_pages * page_size`` span instead,
        and an SSM's state by nothing but the output ring.
        """
        prompt = np.asarray(prompt)
        P = int(prompt.shape[-1])
        limit = self.max_seq
        if self._has_kv and self.model.cache_len(self.max_seq + 1) > self.max_seq:
            room = self.max_seq - P
            if room <= 0:
                raise ValueError(
                    f"request {request_id!r}: prompt of {P} "
                    f"tokens leaves no decode room in the max_seq={self.max_seq} "
                    "full-attention ring; size max_seq >= prompt + max_new")
            limit = min(limit, room)
        elif self.kv_mode == "paged" and self._has_kv:
            room = self.max_pages * self.page_size - P
            if room <= 0:
                raise ValueError(
                    f"request {request_id!r}: prompt of {P} tokens overruns "
                    f"the {self.max_pages}x{self.page_size} page table")
            limit = min(limit, room)
        max_new = max(1, min(max_new, limit))
        self.pending.append(_Request(session, request_id, prompt, max_new,
                                     submit_step=self.steps))
        self._fill_slots()

    def busy(self) -> bool:
        """In-flight work pending.  PARKED retention is not work: a parked
        slot is a cache entry, not a request."""
        return any(s.working for s in self.slots) or bool(self.pending)

    def free_slots(self) -> int:
        """Slots a new admission can take (EMPTY, plus PARKED ones — parked
        residency is reclaimable, its record survives on the host)."""
        return sum(1 for s in self.slots if s.empty or s.parked)

    def parked_slots(self) -> int:
        return sum(1 for s in self.slots if s.parked)

    def active_slots(self) -> int:
        """Slots decoding+sampling this step (admitting/preempted excluded)."""
        return sum(1 for s in self.slots if s.decoding)

    def admitting_slots(self) -> int:
        return sum(1 for s in self.slots if s.state is SlotState.ADMITTING)

    def preempted_slots(self) -> int:
        return sum(1 for s in self.slots
                   if s.state in (SlotState.PREEMPTED, SlotState.RESTORING))

    def wants_more(self) -> bool:
        """Whether claiming more queued work could improve occupancy: any
        free slot does (held-back requests wait in ``pending`` in arrival
        order and are requeued on a crash, so over-claiming never loses or
        reorders work)."""
        return self.free_slots() > 0

    def _pages_needed(self, req: _Request) -> int:
        """Worst-case page count: prompt + all decode writes (the completing
        step samples its last token from a write at P + max_new - 2); 0 for
        a model that keeps no K/V or keeps it in rings."""
        if not (self.kv_mode == "paged" and self._has_kv):
            return 0
        tokens = int(np.asarray(req.prompt).shape[-1]) + req.max_new - 1
        return -(-tokens // self.page_size)

    def _uncommitted(self) -> int:
        """Pool pages not yet promised to anyone (the admission currency)."""
        return self.allocator.free_count - self._reserved

    def _fill_slots(self) -> None:
        held: List[_Request] = []
        held_sessions: set = set()    # a held request gates its whole session:
        # a page-starved r0 must not be overtaken by its session's smaller r1
        pool_starved = False
        if self.park_sessions and self.park_ttl_steps > 0:
            self._expire_parked()
        for req in self.pending:
            if req.session in self._active_sessions or req.session in held_sessions:
                held.append(req)      # FIFO gate: predecessor decoding or held
                held_sessions.add(req.session)
                continue
            plan = self._match_prefix(req)
            slot = self._slot_for(plan)
            if slot is None and not any(s.parked for s in self.slots):
                held.append(req)
                held_sessions.add(req.session)
                continue
            need = self._plan_pages(req, plan)
            if need and self._uncommitted() < need:
                # pool gate: reclaim shareable capacity first (index refs,
                # then parked retention), then try the preemption policy
                self._reclaim_pool(need, keep=plan.record, pinned=plan.pages)
                if self._uncommitted() < need and not self._preempt_for(need):
                    pool_starved = True
                    held.append(req)
                    held_sessions.add(req.session)
                    continue
            if slot is None:
                # only now — with the pool gate passed — reclaim a parked
                # residency (a held request must not cost a snapshot);
                # _reclaim_pool may already have freed one by offloading
                slot = next((s for s in self.slots if s.empty), None)
                if slot is None:
                    victim = min((s for s in self.slots if s.parked),
                                 key=lambda s: s.parked_step)
                    self._evict_parked_slot(self._parked[victim.session])
                    slot = self.slots[victim.index]
            self._admit(slot, req, plan)
        self.pending = held
        # restores only start when pool pressure has cleared: no pending
        # request is pool-gated, and the uncommitted margin funds the
        # victim's whole worst case (prevents preempt<->restore thrash)
        if not pool_starved:
            self._start_restores()

    # -- prefix matching / parked-capacity planning -------------------------

    def _match_prefix(self, req: _Request) -> _MatchPlan:
        """The longest resident prefix of this prompt: the session's parked
        journal if the prompt extends it (pages or blob), else the longest
        indexed full-page chain.  At least the last prompt token always
        re-runs — its logits seed sampling."""
        plan = _MatchPlan()
        if not (self.kv_mode == "paged" and self._has_kv):
            return plan
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        P = len(prompt)
        rec = self._parked.get(req.session) if self.park_sessions else None
        if rec is not None:
            lim = min(P, len(rec.history))
            eq = prompt[:lim] == rec.history[:lim]
            common = lim if eq.all() else int(np.argmin(eq))
            if self._attention_only:
                # reuse everything consumed — generated tokens included
                # (decode KV is bitwise prefill KV) — capped at P-1: the
                # last prompt token always re-runs to seed sampling
                C = min(rec.consumed, common, P - 1)
            else:
                # recurrent rows advanced through every consumed token and
                # cannot rewind: all or nothing, with >= 1 tail token left
                # to re-run for the seeding logits
                C = rec.consumed if (common >= rec.consumed
                                     and P >= rec.consumed + 1) else 0
            if C > 0:
                plan.kind = "park-blob" if rec.blob_key else "park"
                plan.C = C
                plan.record = rec
                if not rec.blob_key:
                    plan.pages = [int(rec.page_row[i])
                                  for i in range(-(-C // self.page_size))]
                return plan
            if common < lim:
                # the prompt *contradicts* the journal: it can never serve
                # this session again (per-session FIFO — this req is next)
                self._drop_record(self._parked.pop(req.session))
                self.park_misses += 1
            # else: consistent but too short to reuse (hybrid: an exact
            # resubmission of the recorded history) — keep the journal;
            # completion supersedes it
        if self._index_sharing:
            if req.hashes is None:
                req.hashes = kvcache.page_hashes(prompt, self.page_size)
            k_max = max(0, P - 1) // self.page_size   # tail >= 1 token
            pids = self.prefix_index.lookup(req.hashes[:k_max])
            if pids:
                plan.kind = "index"
                plan.C = len(pids) * self.page_size
                plan.pages = [int(p) for p in pids]
        return plan

    def _plan_pages(self, req: _Request, plan: _MatchPlan) -> int:
        """Reservation size under the plan: full worst case minus the full
        pages mapped read-only (shared pages cost nothing until a CoW split;
        the boundary partial page's split is inside the writable span, and a
        blob unpark re-allocates its pages out of the same reservation)."""
        total = self._pages_needed(req)
        if plan.kind in ("park", "index"):
            return total - plan.C // self.page_size
        return total

    def _slot_for(self, plan: _MatchPlan) -> Optional[Slot]:
        """A free admission target: the plan's own parked slot (in-place
        unpark) or any EMPTY slot.  PARKED residencies are reclaimable too,
        but only *after* the pool gate passes — ``_fill_slots`` defers that
        eviction so a held request never costs a journal its row snapshot."""
        if plan.kind == "park" and plan.record.slot is not None:
            return self.slots[plan.record.slot]
        return next((s for s in self.slots if s.empty), None)

    def _admit(self, slot: Slot, req: _Request, plan: _MatchPlan) -> None:
        if self.kv_mode == "paged":
            self._admit_paged(slot, req, plan)
            return
        # ring: one monolithic prefill into a fresh B=1 ring, copied whole
        # into the slot's rows; the slot is ACTIVE when this returns.  Under
        # a mesh the owning data group runs it whole (replicated over
        # model) and each rank keeps its slice of the ring
        self._begin(slot, req)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32).reshape(1, -1))
        row = self._local_row(slot.index)
        logits = None
        if row is not None and self._mesh is None:
            with launch_kind("prefill"):
                logits, one = self.model.prefill(prompt.to(self.device), seq_len=self.max_seq)
        elif row is not None:
            # the fresh B=1 ring is whole; an MoE layer still runs on this
            # rank's experts and all-reduces over its model group
            wire = self._policy.wire
            sent, secs = wire.bytes, wire.seconds
            with sharding.activation_sharding(self._policy.whole_state()), launch_kind("prefill"):
                logits, one = self.model.prefill(prompt.to(self.device), seq_len=self.max_seq)
            self.last_chunk_wire_bytes = wire.bytes - sent
            self.last_chunk_wire_ms = (wire.seconds - secs) * 1e3
            self.chunks_run += 1
        if row is not None:
            with sharding.activation_sharding(self._policy):
                kvcache.cache_insert_slot(self.cache, one, row)
        slot.len = prompt.shape[1]
        self.prefill_tokens += prompt.shape[1]
        self._activate(slot, logits)

    def _admit_paged(self, slot: Slot, req: _Request, plan: _MatchPlan) -> None:
        """Begin a chunked admission.  With no resident prefix the slot's
        rows are cleared and the whole prompt is staged; with one, the
        matched pages are mapped read-only (shared) or restored from the
        parked blob, the parked rows are reinstalled if the slot changed,
        and only the prompt's tail is staged in ``prefill_chunk`` pieces (a
        1-token final chunk is fine — the S=1 forward is the chunk path).
        Every write goes into the cache's tensors in place."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        C = plan.C
        need = self._plan_pages(req, plan)
        tail = prompt[C:]
        size = self.prefill_chunk or len(tail)
        in_place = plan.kind == "park" and plan.record.slot == slot.index
        if not in_place:
            self._clear_row(slot.index)
            self._page_rows[slot.index, :] = -1
        self._reserved += need
        self._begin(slot, req)
        slot.session = None
        slot.chunks = [tail[i:i + size] for i in range(0, len(tail), size)]
        slot.chunk_i = 0
        slot.len = C                  # host mirror of the slot's live length
        slot.pages = []
        slot.shared = []
        slot.need = need
        slot.reused = C
        slot.preempts = 0
        if plan.kind in ("park", "index"):
            # map the matched prefix read-only: one extra reference per page
            self.allocator.share(plan.pages)
            slot.shared = list(plan.pages)
            self._page_rows[slot.index, :len(plan.pages)] = plan.pages
            self._set_row(slot.index)
            if plan.kind == "park":
                rec = plan.record
                if in_place:
                    # the new request will overwrite the live rows; keep the
                    # journal self-contained so it can offload mid-flight
                    rec.state = self._snapshot_rows(slot.index)
                    rec.slot = None
                elif rec.state is not None:
                    self._put_rows(slot.index, rec.state)
                self.park_hits += 1
            else:
                # index pages carry KV only (index matches are gated to
                # pure-attention families: no recurrent rows to rebuild)
                self.index_hits += 1
            # the snapshot's length is rec.consumed; rewind to the matched
            # span C (attention families may reuse less than consumed)
            self._set_length(slot.index, C)
        elif plan.kind == "park-blob":
            # restore only the reused span of the journal's blob out of
            # this admission's own reservation; the record keeps its whole
            # blob until superseded
            rec = plan.record
            npg = -(-C // self.page_size)
            pids = self.allocator.alloc(npg)
            self._reserved -= npg
            slot.pages = list(pids)
            self._page_rows[slot.index, rec.blob_pidx[:npg]] = pids
            blob = self.blob_store.get(rec.blob_key)
            if npg < len(rec.blob_pidx):
                blob = kvcache.slice_page_blob(blob, 0, npg)
            self._page_move(self._inject, self.cache, pids, blob)
            self._set_row(slot.index)
            self._put_rows(slot.index, rec.state)
            self._set_length(slot.index, C)
            self.park_hits += 1
        self.shared_prefix_tokens += C
        if C % self.page_size and slot.shared:
            # split the partial boundary page now: the batched decode step's
            # masked rows still write at the slot's length, so a shared page
            # this slot will write into must go private before the next
            # decode step, not lazily at chunk time
            self._prepare_write_span(slot, C, 1)

    def _snapshot_rows(self, slot: int) -> Dict[str, torch.Tensor]:
        """A host copy of one slot's rows (length, recurrent state; under a
        mesh this rank's part of them, the SSD state's heads).  Where slots
        are split over ``data``, the owning data group's rows reach every
        rank as a SUM over ``data`` of a zero-filled buffer (counted in
        ``row_wire_bytes``), so any data group can install them."""
        row = self._local_row(slot)
        if not self._slot_split:
            return kvcache.to_host(kvcache.gather_slot_state(self.cache, row))
        state = kvcache.gather_slot_state(self.cache, 0 if row is None else row)
        wire = self._policy.wire
        sent = wire.bytes
        for key, leaf in state.items():
            if row is None:
                leaf.zero_()
            self._policy.all_reduce(leaf, "sum", axis="data")
        self.row_wire_bytes += wire.bytes - sent
        return kvcache.to_host(state)

    def _share_written(self, spans, pad_to: int = 0) -> None:
        """Keep the pool replicated over ``data`` where slots are split
        (``_share_kv``): the K/V the owning data group just wrote at the
        positions of ``spans`` (``(slot, pos0, count)``) go into every other
        data group's copy of the pool, as one SUM over ``data`` of a
        zero-filled buffer of those pool cells (exact).  Each rank moves the
        cells of its own lanes or heads; a position no page maps, or whose
        lane another model shard holds, is a scratch cell, as are the
        ``pad_to`` fillers that keep a decode step's bytes fixed."""
        pool = self._policy.pool
        lo, hi = pool.lanes() if pool is not None else (0, self.page_size)
        cells, own = [], []
        for slot, pos0, count in spans:
            mine = self._local_row(slot) is not None
            for pos in range(pos0, pos0 + count):
                page, lane = divmod(pos, self.page_size)
                pid = int(self._page_rows[slot, page]) if page < self.max_pages else -1
                if pid >= 0 and lo <= lane < hi:
                    cells.append((pid, lane - lo))
                    own.append(mine)
        while len(cells) < pad_to:
            cells.append((self.n_pages, 0))
            own.append(False)
        if not cells:
            return
        pid, lane = (torch.tensor(c, dtype=torch.long, device=self.device) for c in zip(*cells))
        keep = torch.tensor(own, device=self.device)[None, None, :, None, None]
        kv = torch.stack([self.cache["kp"][:, pid, lane], self.cache["vp"][:, pid, lane]])
        kv = torch.where(keep, kv, torch.zeros((), dtype=kv.dtype, device=self.device))
        sent = self._policy.wire.bytes
        self._policy.all_reduce(kv, "sum", axis="data")
        self.kv_share_bytes += self._policy.wire.bytes - sent
        self.cache["kp"][:, pid, lane] = kv[0]
        self.cache["vp"][:, pid, lane] = kv[1]

    def _page_move(self, fn, *args):
        """``fn(*args)`` (a page extract, inject or copy), its collective
        bytes (none by design: each rank moves its own part of the pool)
        counted in ``page_wire_bytes``."""
        if self._policy is None:
            return fn(*args)
        sent = self._policy.wire.bytes
        out = fn(*args)
        self.page_wire_bytes += self._policy.wire.bytes - sent
        return out

    def _blob_nbytes(self, blob) -> int:
        return kvcache.blob_nbytes(blob, self._pool_split)

    def _begin(self, slot: Slot, req: _Request) -> None:
        """-> ADMITTING: bind the request and close its session's FIFO gate."""
        slot.to(SlotState.ADMITTING)
        slot.req = req
        slot.n_out = 0
        slot.admitted_step = self.steps
        slot.submitted_step = req.submit_step
        self._active_sessions.add(req.session)

    def _activate(self, slot: Slot, logits: Optional[torch.Tensor]) -> None:
        """ADMITTING -> ACTIVE: the prompt's last logits give the first token
        (under a mesh, shared from the data group that ran the chunk; the
        others pass no logits)."""
        if logits is None:
            tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
        else:
            tok = self._sample(logits[:, -1])
        if self._slot_split:
            full = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
            full[slot.index] = tok[0]
            tok = self._policy.all_reduce(full, "sum", axis="data")[slot.index:slot.index + 1]
        self.last_tokens[slot.index] = tok[0]
        self.out_buf[slot.index, 0] = tok[0]
        self.out_pos[slot.index] = 1
        slot.to(SlotState.ACTIVE)
        slot.active_since = self.steps
        slot.n_out = 1
        self.admitted += 1
        if self._spec:
            # one host sync per admission: the draft starts from scratch on
            # the whole canonical stream (the prompt and the first token)
            slot.spec_last = int(tok[0])
            slot.spec_pending = [int(t) for t in
                                 np.asarray(slot.req.prompt, np.int32).reshape(-1)]
            slot.spec_pending.append(slot.spec_last)
            slot.draft_len = 0
            row = self._local_row(slot.index)
            if row is not None:
                self.draft_cache["length"][row] = 0

    def _map_page(self, slot: Slot, page_idx: int) -> None:
        """Host-side mapping only — the caller pushes the updated row to the
        device once per chunk/step."""
        pid = self.allocator.alloc(1)[0]
        self._page_rows[slot.index, page_idx] = pid
        slot.pages.append(pid)
        self._reserved -= 1

    def _unmap_row(self, slot: int) -> None:
        self._page_rows[slot, :] = -1
        self._set_row(slot)

    def _release_slot(self, slot: Slot) -> None:
        """Release a DRAINED slot's page references (owned pages free when
        their last reference dies; shared pages just drop one count) and any
        unused reservation, and unmap its device page-table row so residual
        decode traffic is dropped."""
        slot.to(SlotState.EMPTY)
        if self.kv_mode == "paged":
            self._reserved -= slot.need - len(slot.pages)
            if slot.pages or slot.shared:
                self.allocator.release(slot.pages + slot.shared)
            self._unmap_row(slot.index)
        self.slots[slot.index] = Slot(index=slot.index)

    # -- session parking (cross-request KV retention) ------------------------

    def _publish_index(self, row: np.ndarray, history: np.ndarray,
                       hashes=None) -> None:
        """Publish a finished sequence's full pages — generated span
        included — into the prefix index (the index takes one reference per
        adopted page).  Resident KV covers ``len(history) - 1`` tokens (the
        final sampled token was never consumed).  ``hashes`` reuses the
        request's prompt chain when it already covers the span (the chain
        property makes the prompt hashes a prefix of the history hashes)."""
        full = (len(history) - 1) // self.page_size
        if not full:
            return
        if hashes is None or len(hashes) < full:
            hashes = kvcache.page_hashes(history[: full * self.page_size],
                                         self.page_size)
        pids = [int(row[i]) for i in range(full)]
        self.prefix_index.publish(hashes[:full], pids, self.allocator)
        if self.index_journal:
            # persist the published entries: each full page's contents go to
            # the shared store under its chain hash, so a successor worker
            # can re-adopt this prefix after this worker dies
            self.index_journal_puts += self.prefix_index.journal(
                zip(hashes[:full], pids, strict=True), self.blob_store,
                lambda ids: self._page_move(self._extract, self.cache, ids), self._pool_split)

    def _park_slot(self, slot: Slot, req: _Request, tokens: np.ndarray) -> None:
        """Park a DRAINED slot: ownership of every mapped page transfers to
        the session's journal record, full pages are published to the prefix
        index, and the slot enters PARKED with its device row unmapped (so
        its masked decode traffic can never touch the journal)."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        history = np.concatenate([prompt, np.asarray(tokens, np.int32).reshape(-1)])
        row = self._page_rows[slot.index].copy()
        self._reserved -= slot.need - len(slot.pages)
        if self._index_sharing:
            self._publish_index(row, history, hashes=req.hashes)
        old = self._parked.pop(req.session, None)
        if old is not None:
            self._drop_record(old)          # superseded journal
        self._parked[req.session] = ParkedSession(
            session=req.session, history=history, consumed=slot.len,
            page_row=row, pages=slot.pages + slot.shared, slot=slot.index,
            parked_step=self.steps, mesh_shape=self._mesh_shape)
        self._unmap_row(slot.index)
        slot.to(SlotState.PARKED)
        slot.session = req.session
        slot.parked_step = self.steps
        slot.req = None
        slot.pages, slot.shared = [], []
        slot.need = 0
        self.parks += 1

    def _evict_parked_slot(self, rec: ParkedSession) -> None:
        """Reclaim a parked slot for a new admission: snapshot its rows to
        the host (length + recurrent state; the pages stay resident, owned
        by the record) and free the slot."""
        slot = self.slots[rec.slot]
        rec.state = self._snapshot_rows(rec.slot)
        slot.to(SlotState.EMPTY)
        self.slots[rec.slot] = Slot(index=rec.slot)
        rec.slot = None
        self.park_evictions += 1

    def _offload_parked(self, rec: ParkedSession) -> None:
        """Pool pressure: push a parked journal's pages to the blob store
        (position-ordered, like a preemption) and release the references —
        the session's next request restores the blob instead of
        re-prefilling, paying a storage GET for prompt-length compute."""
        if rec.slot is not None:
            self._evict_parked_slot(rec)
        npg = -(-rec.consumed // self.page_size)
        blob = self._page_move(self._extract, self.cache, rec.page_row[:npg])
        key = f"park/{self.blob_ns}{rec.session}/s{self.steps}"
        self.blob_store.put(key, blob, self._blob_nbytes(blob))
        rec.blob_key = key
        rec.blob_pidx = list(range(npg))
        self.allocator.release(rec.pages)
        rec.pages = []
        self.park_offloads += 1

    def _drop_record(self, rec: ParkedSession) -> None:
        """Forget a journal (superseded, diverged, expired, or reclaimed):
        release its page references and delete its blob; a still-resident
        slot goes back to EMPTY."""
        if rec.slot is not None:
            self.slots[rec.slot].to(SlotState.EMPTY)
            self.slots[rec.slot] = Slot(index=rec.slot)
        if rec.pages:
            self.allocator.release(rec.pages)
        if rec.blob_key:
            self.blob_store.delete(rec.blob_key)

    def _expire_parked(self) -> None:
        for session, rec in list(self._parked.items()):
            if self.steps - rec.parked_step > self.park_ttl_steps:
                self._drop_record(self._parked.pop(session))
                self.park_expirations += 1

    # -- fleet hooks (worker drain / cold start) -----------------------------

    def externalize_session(self, session: str) -> ParkedSession:
        """Fleet drain: detach one parked journal from this worker entirely.
        The record's pages are pushed to the (shared) blob store if still
        resident, its slot is reclaimed (its rows snapshot to the host
        first: a parked record always holds pages), and the record — now host data (numpy history and page row,
        CPU row tensors) plus a blob key — is popped and returned for the
        controller to hand to a successor worker.  After this the worker
        holds no reference to the session, and nothing in the record
        aliases this worker's device rows, which ``reset()`` overwrites.
        Under a mesh the record holds the slot's whole rows (shared over
        ``data`` when they were snapshot) and the key of this rank's blob
        shard, and names the mesh shape that wrote it."""
        rec = self._parked.pop(session)
        if rec.pages:
            self._offload_parked(rec)
        return rec

    def adopt_parked(self, rec: ParkedSession) -> None:
        """Fleet routing: install an externalized (blob-resident) journal so
        the next admission for its session restores from the shared store
        instead of re-prefilling.  The record must hold no pool references —
        those died with the worker that wrote it — and must come from a
        scheduler on this mesh shape (``mesh=None`` included): its blob is a
        shard of this shape's pool."""
        if rec.mesh_shape != self._mesh_shape:
            raise ValueError(
                f"session {rec.session!r} was parked on mesh shape {rec.mesh_shape} and this "
                f"scheduler serves mesh shape {self._mesh_shape}: a parked record is read "
                f"back only on the (data, model) shape that wrote it")
        if rec.pages or rec.slot is not None:
            raise ValueError(
                f"adopting session {rec.session!r} with live pool state "
                "(pages/slot are worker-local and do not transfer)")
        rec.parked_step = self.steps
        self._parked[rec.session] = rec

    def adopt_index_journal(self) -> int:
        """Worker cold start: re-adopt journaled prefix-index entries from
        the shared blob store into this pool (allocate, scatter, adopt — the
        alloc-time reference transfers to the index).  Each page is
        scattered into the existing pool in place: a recycled worker keeps
        its captured graphs, which read the pool's storage.  Bounded so
        adoption always leaves at least one slot's worst case uncommitted;
        index pages are reclaimable cache either way, so a skipped entry
        only costs a re-prefill.  Under a mesh each blob is this rank's
        shard of its page, written on this mesh shape (a blob of another
        shard's page shape is refused by the inject)."""
        if not self.index_journal:
            return 0

        def install(pid, blob):
            self._page_move(self._inject, self.cache, [pid], blob)

        n = self.prefix_index.rebuild(
            self.blob_store, self.allocator,
            budget=lambda: self._uncommitted() - self.max_pages,
            install=install)
        self.index_adopted += n
        return n

    def _reclaim_pool(self, need: int, keep: Optional[ParkedSession] = None,
                      pinned: Sequence[int] = ()) -> None:
        """Pool-gated admission: reclaim shareable capacity cheapest-first —
        drop LRU prefix-index references (free if nobody else maps the
        page), then offload parked journals to the blob store, oldest
        first.  ``keep`` is the record the admission itself consumes and
        ``pinned`` the index pages its plan is about to map."""
        self.prefix_index.evict(self.allocator, self._reserved + need, pinned=pinned)
        if self._uncommitted() >= need:
            return
        for rec in sorted((r for r in self._parked.values()
                           if r.pages and r is not keep),
                          key=lambda r: r.parked_step):
            if self._uncommitted() >= need:
                break
            self._offload_parked(rec)

    # -- preemption / restore (storage-backed slot reclamation) -----------------

    def _preempt_for(self, need: int) -> bool:
        """Free at least ``need - uncommitted`` pages by preempting ACTIVE
        victims; all-or-nothing (a partial eviction would pay the offload
        transfer without unblocking the admission)."""
        if self.preempt_policy != "pressure":
            return False
        deficit = need - self._uncommitted()
        victims = [s for s in self.slots
                   if s.state is SlotState.ACTIVE and s.pages
                   and s.age(self.steps) >= self.idle_preempt_steps]
        # idleness-driven ranking: the longest-resident slot first (the
        # mostly-idle long-runner), then the one pinning the most pages
        victims.sort(key=lambda s: (s.age(self.steps), len(s.pages)), reverse=True)
        chosen, freed = [], 0
        for v in victims:
            if freed >= deficit:
                break
            chosen.append(v)
            freed += v.need   # eviction releases pages AND reservation
        if freed < deficit:
            return False
        for v in chosen:
            self._preempt(v)
        return True

    def preempt(self, index: int) -> None:
        """Preempt one ACTIVE slot now (the policy calls this; exposed so
        tests and drivers can force a preemption point)."""
        self._preempt(self.slots[index])

    def _preempt(self, slot: Slot) -> None:
        slot.to(SlotState.PREEMPTED)
        row = self._page_rows[slot.index]
        pidx = [i for i in range(self.max_pages) if row[i] >= 0]
        phys = [int(row[i]) for i in pidx]
        # gather in logical order and copy to the host: the blob is
        # position-ordered however scrambled the physical table was
        blob = self._page_move(self._extract, self.cache, phys)
        key = f"kv/{self.blob_ns}{slot.req.request_id}/p{slot.preempts}"
        self.blob_store.put(key, blob, self._blob_nbytes(blob))
        slot.blob_key = key
        slot.blob_pidx = pidx
        slot.restore_i = 0
        slot.preempts += 1
        # release the slot's whole pool commitment: page references dropped
        # (owned pages free; shared prefix pages keep their other holders),
        # unmapped growth back to the uncommitted margin.  The restore owns
        # every page it injects — the blob covers shared prefix pages too —
        # so the reservation grows back to the full worst case.
        self._reserved -= slot.need - len(slot.pages)
        self.allocator.release(slot.pages + slot.shared)
        slot.pages = []
        slot.shared = []
        slot.need = self._pages_needed(slot.req)
        self._unmap_row(slot.index)
        self._preempted_order.append(slot.index)
        self.preemptions += 1
        self.offload_pages += len(phys)

    def _start_restores(self) -> None:
        """Fund restores FIFO in preemption order: a later blob must not
        overtake an earlier one."""
        for idx in list(self._preempted_order):
            slot = self.slots[idx]
            if self._uncommitted() < slot.need:
                # retention must never starve a restore: index references
                # and parked journals are reclaimable cache, a preempted
                # request is real work (nothing else calls the reclaim path
                # when the pending queue is empty)
                self._reclaim_pool(slot.need)
            if self._uncommitted() < slot.need:
                break
            slot.to(SlotState.RESTORING)
            self._reserved += slot.need
            slot.blob = self.blob_store.get(slot.blob_key)
            self._preempted_order.remove(idx)
            self.restores += 1

    def _run_restore_chunk(self, slot: Slot) -> None:
        """Write one chunk of a restoring slot's blob back: allocate fresh
        physical pages, scatter the blob slice into them, re-map the page
        table.  The final chunk reactivates the slot — it rejoins the decode
        batch the same step, like an admission whose last chunk landed."""
        n = len(slot.blob_pidx)
        hi = min(slot.restore_i + (self._restore_chunk_pages or n), n)
        phys = []
        for j in range(slot.restore_i, hi):
            pid = self.allocator.alloc(1)[0]
            self._reserved -= 1
            slot.pages.append(pid)
            self._page_rows[slot.index, slot.blob_pidx[j]] = pid
            phys.append(pid)
        self._page_move(self._inject, self.cache, phys,
                        kvcache.slice_page_blob(slot.blob, slot.restore_i, hi))
        self._set_row(slot.index)
        self.restored_pages += hi - slot.restore_i
        slot.restore_i = hi
        self.restore_chunks += 1
        if hi == n:
            self.blob_store.delete(slot.blob_key)
            slot.blob = None
            slot.blob_key = None
            slot.blob_pidx = []
            slot.to(SlotState.ACTIVE)
            slot.active_since = self.steps

    def drain_offload_ops(self) -> list:
        """Storage ops since the last drain — the frontend bills these under
        the calibrated obj_read/obj_write latency and Table-4 cost models."""
        return self.blob_store.drain_ops()

    def _prepare_write_span(self, slot: Slot, pos0: int, count: int) -> None:
        """Make the pages under ``[pos0, pos0 + count)`` writable for this
        slot: map unmapped pages (alloc-on-write, within the reservation)
        and copy-on-write split any mapped page that another reference
        still reads — the writer gets a private copy on a fresh page and
        remaps only its own table row, so the prefix index / parked journal
        / sibling slot keeps reading the original bytes.  The copy and the
        row go into the cache in place; the row is pushed once."""
        changed = False
        hi = min((pos0 + count - 1) // self.page_size, self.max_pages - 1)
        for pidx in range(pos0 // self.page_size, hi + 1):
            pid = int(self._page_rows[slot.index, pidx])
            if pid < 0:
                if len(slot.pages) < slot.need:
                    self._map_page(slot, pidx)
                    changed = True
                # else: reservation exhausted — the final dangling write past
                # it goes to the scratch page
            elif self.allocator.refcount(pid) > 1:
                new = self.allocator.alloc(1)[0]
                if pid in slot.shared:
                    # the split of a shared prefix page was part of this
                    # admission's reservation (need counts every writable page)
                    self._reserved -= 1
                    slot.shared.remove(pid)
                else:
                    # an owned page some external holder (index/journal) still
                    # references: swap it out, reservation-neutral
                    slot.pages.remove(pid)
                slot.pages.append(new)
                self._page_move(kvcache.copy_pages, self.cache, [pid], [new])
                self.allocator.release([pid])
                self._page_rows[slot.index, pidx] = new
                self.cow_splits += 1
                changed = True
        if changed:
            self._set_row(slot.index)

    def _run_chunk(self, slot: Slot) -> None:
        """One prefill chunk for one admitting slot (alloc-on-write: map the
        pages the chunk's span touches, CoW-splitting any shared one, then a
        B=1 forward against the shared pool); the final chunk's logits seed
        the slot's first token."""
        chunk = slot.chunks[slot.chunk_i]
        C = len(chunk)
        if self._has_kv:
            self._prepare_write_span(slot, slot.len, C)
        logits = self._chunk_logits(chunk, slot.index)
        if self._share_kv:
            self._share_written([(slot.index, slot.len, C)])
        slot.len += C
        slot.chunk_i += 1
        self.prefill_tokens += C
        self.prefill_chunks += 1
        if slot.chunk_i == len(slot.chunks):
            slot.chunks = None
            self._activate(slot, logits)

    def _chunk_logits(self, chunk: np.ndarray, slot: int) -> torch.Tensor:
        """Run one prefill chunk for ``slot`` and return its logits.  On the
        card a ``prefill_chunk``-token chunk replays the chunk graph from
        the static token and slot buffers (the logits are the graph's
        output, valid until its next replay); any other chunk runs
        eagerly.  Under a mesh, a rank whose data group does not hold the
        slot runs nothing and returns None."""
        with launch_kind("chunk"):
            if self._mesh is not None:
                row = self._local_row(slot)
                if row is None:
                    return None
                self.chunks_run += 1
                wire = self._policy.wire
                sent, secs = wire.bytes, wire.seconds
                tokens = torch.as_tensor(chunk, dtype=torch.int32).to(self.device)[None]
                logits = self._chunk(self.cache, tokens, row)[0]
                self.last_chunk_wire_bytes = wire.bytes - sent
                self.last_chunk_wire_ms = (wire.seconds - secs) * 1e3
                return logits
            if self.graphs is not None and len(chunk) == self.prefill_chunk:
                self._chunk_tokens.copy_(torch.from_numpy(chunk).view(1, -1))
                self._chunk_at.fill_(slot)
                return self.graphs.run("chunk", lambda: self._chunk(
                    self.cache, self._chunk_tokens, self._chunk_at)[0])
            tokens = torch.as_tensor(chunk, dtype=torch.int32).to(self.device)[None]
            return self._chunk(self.cache, tokens, slot)[0]

    # -- decode loop ---------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return sampling.greedy(logits)
        return sampling.temperature_sample(self._gen, logits, self.temperature,
                                           self.top_k)

    def _step_impl(self, cache, last_tokens, out_buf, out_pos, active) -> None:
        """Decode one token per slot, sample, append to the output ring,
        all on the device and in place: nothing returns to the host, and
        the results go into the given ``cache``, ``last_tokens``,
        ``out_buf`` and ``out_pos``.  Fixed-shape and mask-only: every row
        is computed, and ``active`` (n_slots,) bool keeps freed,
        mid-admission, preempted and parked slots' tokens, output rings,
        lengths and recurrent rows as they were."""
        logits, new_cache = self.model.decode_step(cache, last_tokens[:, None])
        kvcache.mask_slot_rows(new_cache, cache, active)
        toks = torch.where(active, self._sample(logits[:, -1]), last_tokens)
        self._emit(toks, last_tokens, out_buf, out_pos, active)

    def _emit(self, toks, last_tokens, out_buf, out_pos, active) -> None:
        """Append a decode step's tokens to the output ring, in place."""
        col = (out_pos % self.max_seq).long()[:, None]
        out_buf.scatter_(1, col, torch.where(active[:, None], toks[:, None],
                                             out_buf.gather(1, col)))
        out_pos.add_(active.to(torch.int32))
        last_tokens.copy_(toks)

    def _graphed(self, key: str, fn):
        """``fn()``'s result: on the card the replay of ``key``'s graph
        (captured at the first call), on the CPU the eager step."""
        return fn() if self.graphs is None else self.graphs.run(key, fn)

    def _mesh_decode(self) -> None:
        """The decode step of mesh mode: this rank's slot rows against its
        part of the cache under the policy, the tokens shared over
        ``data``; the collective bytes it sent are kept in
        ``last_step_wire_bytes``."""
        rows, wire = self._rows, self._policy.wire
        sent, secs = wire.bytes, wire.seconds
        active, last = self._active[rows], self.last_tokens[rows]
        with sharding.activation_sharding(self._policy):
            logits, new_cache = self.model.decode_step(self.cache, last[:, None])
            kvcache.mask_slot_rows(new_cache, self.cache, active)
            if self._share_kv:
                self._share_written([(s.index, s.len, 1) for s in self.slots if s.decoding],
                                    pad_to=self.n_slots)
            toks = self._share_rows(torch.where(active, self._sample(logits[:, -1]), last))
        self._emit(toks, self.last_tokens, self.out_buf, self.out_pos, self._active)
        self.last_step_wire_bytes = wire.bytes - sent
        self.last_step_wire_ms = (wire.seconds - secs) * 1e3

    def _decode(self) -> None:
        """The batched decode step over ``self._active``."""
        with launch_kind("decode"):
            if self._mesh is not None:
                self._mesh_decode()
                return
            self._graphed("decode", lambda: self._step_impl(
                self.cache, self.last_tokens, self.out_buf, self.out_pos, self._active))

    def _spec_round(self, active: List[int]) -> None:
        """One draft-and-verify round over the ACTIVE slots (``_active``
        holds their mask): the draft
        proposes ``spec_k`` tokens per slot, the target scores all of them
        in one chunked step against the shared pool, and each slot emits
        the accepted prefix and the target's bonus or correction token
        (1..spec_k+1 tokens a round, the tokens S=1 decode would emit).

        One device-to-host copy a round (the emitted tokens and accepted
        counts).  The draft's catch-up replays the canonical tokens its ring
        has not consumed (the whole prompt after an admission, 1-2 tokens a
        round after that) in one batched, masked, back-padded call that runs
        eagerly (its width changes every round); the draft steps and the
        verify replay their graphs on the card.  Rejected proposals rewind
        the draft rows' lengths, so the draft ring tracks the canonical
        stream.

        Rollback: K/V pages need no copy, since the verify's rejected
        positions sit past the rewound length and the next write covers
        them before a read; pages mapped or split for the span stay with the
        slot.  A hybrid target's recurrent rows did consume the rejected
        tokens, so on a partial accept they are restored from the copy the
        verify step took before it ran, and the canonical span (the pending
        token and the ``a`` accepted drafts) replays through the chunk path."""
        k = self.spec_k
        spec = [self.slots[i] for i in active]
        rows = self._rows if self._rows is not None else slice(None)
        wire = self._policy.wire if self._policy is not None else None
        sent, secs = (wire.bytes, wire.seconds) if wire is not None else (0, 0.0)
        # 1) the draft catches up on the canonical stream: one masked call
        #    over every slot's pending span, back-padded to the widest, its
        #    last real token landing in the newest draft column (under a
        #    mesh each data group over its own slots' rows)
        W = max(len(st.spec_pending) for st in spec)
        tok_rows = np.zeros((self.n_slots, W), np.int32)
        cnt_rows = np.ones((self.n_slots,), np.int32)
        for st in spec:
            tok_rows[st.index, :len(st.spec_pending)] = st.spec_pending
            cnt_rows[st.index] = len(st.spec_pending)
            st.draft_len += len(st.spec_pending)
            st.spec_pending = []
        with launch_kind("draft"):
            self._draft_catchup(self.draft_cache, torch.from_numpy(tok_rows[rows]).to(self.device),
                                torch.from_numpy(cnt_rows[rows]).to(self.device),
                                self._active[rows], self._vtok[rows, k])
            # 2) k-1 batched draft steps finish the proposal window
            for _ in range(k - 1):
                self._graphed("draft", self._draft_step_impl)
        # 3) make the verify span writable (alloc-on-write and CoW split, as
        #    decode growth but k+1 positions at once), and cap each slot's
        #    acceptance so it cannot overrun its max_new budget
        k_eff = np.zeros((self.n_slots,), np.int32)
        for st in spec:
            self._prepare_write_span(st, st.len, k + 1)
            k_eff[st.index] = min(k, st.req.max_new - st.n_out - 1)
        self._k_eff.copy_(torch.from_numpy(k_eff))
        with launch_kind("verify"):
            ya = self._graphed("verify", self._verify_impl)[0]
        if self._share_kv:
            self._share_written([(st.index, st.len, k + 1) for st in spec],
                                pad_to=self.n_slots * (k + 1))
        ya = ya.cpu().numpy()                  # the round's one host sync
        hybrid = bool(self._spec_rows)
        for st in spec:
            i = st.index
            a = int(ya[i, -1])
            y = ya[i, :-1]
            if hybrid and a < k:
                # the rows consumed all k+1 verify tokens: restore the copy
                # taken before the verify and replay the canonical span
                # through the chunk path (its K/V rewrites the same lanes),
                # on the ranks that hold the slot
                row = self._local_row(i)
                if row is not None:
                    for key, saved in self._spec_rows.items():
                        self.cache[key][:, row] = saved[:, row]
                self._set_length(i, st.len)
                self._chunk_logits(np.asarray([st.spec_last, *y[:a]], np.int32), i)
                if self._share_kv:
                    self._share_written([(i, st.len, a + 1)])
                self.spec_rollbacks += 1
            emitted = a + 1
            st.n_out += emitted
            st.len += emitted
            st.spec_last = int(y[a])
            adv = min(a, k - 1)       # drafts d1..d_adv proved canonical
            st.draft_len += adv
            # canonical tokens the draft has not consumed: y[adv..a]
            st.spec_pending = [int(t) for t in y[adv:a + 1]]
            self.spec_accepted += a
            self.spec_emitted += emitted
            self.decode_tokens += emitted
        # rejected proposals rewind the draft rows to the canonical length
        held = [(self._local_row(st.index), st.draft_len) for st in spec]
        held = [(row, n) for row, n in held if row is not None]
        if held:
            idx = torch.tensor([row for row, _ in held], device=self.device)
            lens = torch.tensor([n for _, n in held], dtype=torch.int32, device=self.device)
            self.draft_cache["length"].index_copy_(0, idx, lens)
        self.spec_proposed += k * len(spec)
        self.spec_rounds += 1
        if wire is not None:
            self.last_round_wire_bytes = wire.bytes - sent
            self.last_round_wire_ms = (wire.seconds - secs) * 1e3

    def _draft_step_impl(self) -> None:
        """One batched draft step, in place: the newest draft column in,
        the columns shifted one left and the new token appended (under a
        mesh, over this rank's slot rows)."""
        rows = self._rows if self._rows is not None else slice(None)
        drafts, dtok = self._vtok[rows, 1:], self._dtok[rows]
        self._draft_step(self.draft_cache, drafts[:, -1], self._active[rows], dtok)
        drafts.copy_(torch.cat([drafts[:, 1:], dtok[:, None]], dim=1))

    def _verify_impl(self):
        """The verify step over ``_vtok``, in place; returns ``(y | a, logits)``:
        each slot's ``k + 1`` argmax tokens with its accepted count in the
        last column, and the verify logits.  Under a mesh the step scores
        this rank's slot rows, ``y | a`` is shared over ``data`` (one
        collective a round, as a decode step's tokens) and every slot's
        tokens are emitted from it, so every rank's output ring agrees."""
        for key, saved in self._spec_rows.items():
            saved.copy_(self.cache[key])
        self._vtok[:, 0].copy_(self.last_tokens)
        rows = self._rows if self._rows is not None else slice(None)
        y, a, logits = self._verify(self.cache, self._vtok[rows], self._active[rows],
                                    self._k_eff[rows], None, None, None)
        ya = self._share_rows(torch.cat([y, a[:, None]], dim=1))
        spec_emit(ya[:, :-1], ya[:, -1], self._active, self.out_buf, self.out_pos,
                  self.last_tokens, max_seq=self.max_seq)
        return ya, logits

    def step(self) -> List[CompletedRequest]:
        """One scheduler tick: at most one prefill chunk (round-robin over
        admitting slots) and one restore chunk (round-robin over restoring
        slots), then one batched decode step (or, with speculation on, one
        draft-and-verify round) over the active slots; returns the requests
        that completed this step (their slots are refilled from the pending
        list before returning)."""
        self._fill_slots()
        admitting = [s for s in self.slots if s.state is SlotState.ADMITTING]
        if admitting:
            pick = admitting[self._chunk_rr % len(admitting)]
            self._chunk_rr += 1
            self._run_chunk(pick)
        restoring = [s for s in self.slots if s.state is SlotState.RESTORING]
        if restoring:
            pick = restoring[self._restore_rr % len(restoring)]
            self._restore_rr += 1
            self._run_restore_chunk(pick)
        active = [s.index for s in self.slots if s.decoding]
        if not active:
            return []
        mask = np.zeros((self.n_slots,), bool)
        mask[active] = True
        self._active.copy_(torch.from_numpy(mask))
        if self._spec:
            self._spec_round(active)
        else:
            if self.kv_mode == "paged" and self._has_kv:
                for i in active:
                    # alloc-on-write for decode growth: make the page this
                    # step's token write lands in writable — map it if
                    # unmapped (within the reservation), CoW-split it if shared
                    st = self.slots[i]
                    self._prepare_write_span(st, st.len, 1)
            self._decode()
            self.decode_tokens += len(active)
            for i in active:
                self.slots[i].n_out += 1
                self.slots[i].len += 1
        self.steps += 1
        self.slot_steps += len(active)
        self.page_step_sum += self.allocator.in_use
        finished: List[CompletedRequest] = []
        for i in active:
            st = self.slots[i]
            if st.n_out >= st.req.max_new:
                req = st.req
                st.to(SlotState.DRAINED)
                # a copy: on the CPU, .numpy() would alias the output ring
                tokens = self.out_buf[i, : req.max_new].cpu().numpy().copy()
                finished.append(CompletedRequest(
                    session=req.session, request_id=req.request_id, tokens=tokens,
                    admitted_step=st.admitted_step, finished_step=self.steps,
                    submitted_step=st.submitted_step, preempts=st.preempts,
                    reused_tokens=st.reused))
                if self.park_sessions:
                    self._park_slot(st, req, tokens)
                else:
                    if self._index_sharing:
                        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
                        self._publish_index(self._page_rows[st.index],
                                            np.concatenate([prompt, tokens.astype(np.int32)]),
                                            hashes=req.hashes)
                    self._release_slot(st)
                self._active_sessions.discard(req.session)
                self.completed += 1
        if finished:
            self._fill_slots()
        return finished

    def reset(self, *, clear_blob_store: bool = True) -> None:
        """Abort all in-flight work (crash recovery: the queue layer
        redelivers; completed requests are deduped by the frontend).  The
        pool returns to fully free and every page-table row to unmapped, the
        prefix index and the parked-session table are cleared and (unless
        ``clear_blob_store=False``) the blob store is emptied — a
        redelivered admission replays from its prompt, never from an
        orphaned blob or another life's shared pages.  The schedule and the
        sampling generator restart, so a replay is a pure function of the
        submitted work.  Rings have no pool: each admission overwrites its
        slot's rows whole.  The CUDA graphs are kept: their static buffers
        are zeroed in place."""
        self.slots = [s.force_empty() for s in self.slots]
        self.pending = []
        self._active_sessions.clear()
        self._preempted_order = []
        self._chunk_rr = 0
        self._restore_rr = 0
        self._gen.manual_seed(self._seed)
        # allocator.reset() below wipes every reference wholesale, so the
        # index and the parked table just forget their entries
        self.prefix_index.clear()
        self._parked.clear()
        if clear_blob_store:
            self.blob_store.clear()
        self.last_tokens.zero_()
        self.out_buf.zero_()
        self.out_pos.zero_()
        self._active.zero_()
        self._chunk_tokens.zero_()
        self._chunk_at.zero_()
        if self.kv_mode == "paged":
            self.allocator.reset()
            self._reserved = 0
            self._page_rows[:] = -1
            for slot in range(self.n_slots):
                self._clear_row(slot)
        if self._spec:
            # draft rows replay from scratch at the next admission; zero
            # lengths so stale ring lanes are invalid until overwritten
            self.draft_cache["length"].zero_()
            self._vtok.zero_()
            self._k_eff.zero_()
            self._dtok.zero_()

    # -- invariant audit -------------------------------------------------------------

    def audit(self) -> None:
        """Raise AssertionError if an allocator, refcount, page-table or
        reservation invariant is violated: ``free + in_use == n_pages``;
        every mapped page has refcount >= 1; the refcount total equals the
        references actually held (slot owned + slot shared + parked
        journals + prefix index); no page is owned by two slots; each slot's
        host row maps exactly the pages it holds and equals the device row;
        the reservation ledger equals the outstanding worst-case growth;
        parked records and PARKED slots point at each other.  Rings have no
        pool to audit."""
        if self.kv_mode != "paged":
            return
        a = self.allocator
        a.check()
        refs = 0
        owned: set = set()
        for s in self.slots:
            refs += len(s.pages) + len(s.shared)
            for p in s.pages:
                assert p not in owned, f"page {p} owned by two slots"
                owned.add(p)
        refs += sum(len(rec.pages) for rec in self._parked.values())
        refs += len(self.prefix_index)
        assert refs == a.total_refs, (
            f"refcount drift: holders sum to {refs}, allocator says {a.total_refs}")
        device_rows = self.cache["page_table"].cpu().numpy()
        for s in self.slots:
            row = self._page_rows[s.index]
            mapped = {int(p) for p in row if p >= 0}
            held = set(s.pages) | set(s.shared)
            assert mapped == held, (
                f"slot {s.index} ({s.state.value}): row maps {mapped}, holds {held}")
            for p in mapped:
                assert a.refcount(p) >= 1, f"slot {s.index} maps freed page {p}"
            local = self._local_row(s.index)
            assert local is None or (device_rows[local] == row).all(), (
                f"slot {s.index}: device page-table row drifted from the host mirror")
        reserved = sum(s.need - len(s.pages) for s in self.slots
                       if s.state in (SlotState.ADMITTING, SlotState.ACTIVE,
                                      SlotState.RESTORING))
        assert reserved == self._reserved, (
            f"reservation ledger drift: slots imply {reserved}, "
            f"ledger says {self._reserved}")
        assert self._uncommitted() >= 0, (
            f"over-committed pool: {self._reserved} reserved, {a.free_count} free")
        for session, rec in self._parked.items():
            if rec.slot is not None:
                s = self.slots[rec.slot]
                assert s.state is SlotState.PARKED and s.session == session, (
                    f"parked record {session} points at slot {rec.slot} "
                    f"in state {s.state.value} (session {s.session})")
            assert not (rec.blob_key and rec.pages), (
                f"parked record {session} is both resident and offloaded")
        for s in self.slots:
            if s.parked:
                rec = self._parked.get(s.session)
                assert rec is not None and rec.slot == s.index, (
                    f"PARKED slot {s.index} for session {s.session} has no resident record")

    # -- reporting ------------------------------------------------------------------

    def occupancy(self) -> float:
        """Mean active slots per decode step (the batching lever)."""
        return self.slot_steps / self.steps if self.steps else 0.0

    def pool_occupancy(self) -> float:
        """Mean fraction of the pool in use per decode step."""
        if not (self.steps and self.n_pages):
            return 0.0
        return self.page_step_sum / (self.steps * self.n_pages)

    def kv_memory_stats(self) -> Dict[str, float]:
        """KV bytes: allocated pool or ring footprint and the live
        high-water mark (rings are allocated whole, so the two are equal)."""
        per_token = kvcache.kv_bytes_per_token(self.cache)
        if self.kv_mode == "ring":
            ring_tokens = self.model.cache_len(self.max_seq) if self._has_kv else 0
            return {
                "kv_bytes_per_token": per_token,
                "kv_pool_bytes": per_token * self.n_slots * ring_tokens,
                "kv_high_water_bytes": per_token * self.n_slots * ring_tokens,
            }
        return {
            "kv_bytes_per_token": per_token,
            "kv_pool_bytes": per_token * self.n_pages * self.page_size,
            "kv_high_water_bytes": per_token * self.allocator.high_water * self.page_size,
            "kv_pages": self.n_pages,
            "kv_pages_high_water": self.allocator.high_water,
            "kv_pages_in_use": self.allocator.in_use,
            "kv_pool_occupancy": round(self.pool_occupancy(), 3),
        }

    def offload_stats(self) -> Dict[str, float]:
        """Offload traffic gauges: preempt/restore counts, page counts, and
        the byte flows to and from the blob store (bytes_out = offloaded,
        bytes_in = restored)."""
        bs = self.blob_store
        return {
            "preemptions": self.preemptions,
            "restores": self.restores,
            "restore_chunks": self.restore_chunks,
            "offload_pages": self.offload_pages,
            "restored_pages": self.restored_pages,
            "offload_puts": bs.puts,
            "offload_gets": bs.gets,
            "offload_bytes": bs.bytes_out,
            "restore_bytes": bs.bytes_in,
            "offload_stored_bytes": bs.bytes_stored,
            "offload_stored_high_water_bytes": bs.high_water_bytes,
        }

    def sharing_stats(self) -> Dict[str, float]:
        """Prefix-sharing / parking gauges: prompt tokens served from
        resident pages instead of re-prefilled, hit/miss counts, CoW
        splits, and the parked-retention flows."""
        return {
            "shared_prefix_tokens": self.shared_prefix_tokens,
            "park_hits": self.park_hits,
            "park_misses": self.park_misses,
            "index_hits": self.index_hits,
            "cow_splits": self.cow_splits,
            "parks": self.parks,
            "park_evictions": self.park_evictions,
            "park_offloads": self.park_offloads,
            "park_expirations": self.park_expirations,
            "parked_sessions": len(self._parked),
            "index_pages": len(self.prefix_index),
            "index_journal_puts": self.index_journal_puts,
            "index_adopted": self.index_adopted,
        }

    def spec_stats(self) -> Dict[str, float]:
        """Speculation gauges: acceptance rate (accepted / proposed drafts)
        and verify steps per emitted token (1.0 = no speedup; 1/(k+1) =
        every draft accepted); ``spec_rollbacks`` counts a hybrid target's
        partial accepts, each a row restore and a replayed chunk."""
        return {
            "spec_k": self.spec_k,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_rollbacks": self.spec_rollbacks,
            "spec_acceptance_rate": round(self.spec_accepted / self.spec_proposed, 4)
            if self.spec_proposed else 0.0,
            "spec_steps_per_token": round(self.spec_rounds / self.spec_emitted, 4)
            if self.spec_emitted else 0.0,
        }

    def stats(self) -> Dict[str, float]:
        out = {
            "steps": self.steps,
            "occupancy": round(self.occupancy(), 3),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "admitted": self.admitted,
            "completed": self.completed,
            "kv_mode": self.kv_mode,
            "attn_backend": self.attn_backend,
            "prefill_chunks": self.prefill_chunks,
        }
        if self.offload:
            out.update(self.offload_stats())
        if self.prefix_sharing or self.park_sessions:
            out.update(self.sharing_stats())
        if self._spec:
            out.update(self.spec_stats())
        return out
