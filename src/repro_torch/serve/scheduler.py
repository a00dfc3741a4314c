"""Slot-based continuous-batching decode scheduler over a paged KV pool
(or per-slot rings).

A fixed-width decode batch (``n_slots``) steps one token per active slot per
call; free slots are re-admitted from a shared cross-session queue of pending
requests.  Every slot runs the explicit lifecycle in
:mod:`repro_torch.serve.lifecycle`::

    EMPTY -> ADMITTING -> ACTIVE -> DRAINED -> EMPTY

KV lives in one shared ``(n_pages, page_size, Hkv, D)`` pool per layer plus
a per-slot page table (:func:`repro_torch.models.kvcache.paged_cache`).
Pages are handed out by a host-side free list
(:class:`~repro_torch.models.kvcache.PageAllocator`) — mapped on first
write, freed on completion — so KV memory scales with live tokens, not
``n_slots * max_seq``.  Admission is **chunked**: the prompt is split into
``prefill_chunk``-sized pieces and one chunk runs per :meth:`step` (a B=1
forward against the shared pool, interleaved with the batch's decode step),
so a long prompt never stalls the other slots for more than one chunk.
Admission is reservation-gated: a request is admitted only when the pool's
uncommitted pages cover its worst case, so lazy mapping can never deadlock
mid-decode.

The batched decode step masks non-ACTIVE slots out of the token write, the
output ring, the length advance and (hybrid models) the recurrent rows
(:func:`kvcache.mask_slot_rows`): a freed or mid-admission slot's stale
state cannot advance, and its pool writes either land past its length in
pages it owns (overwritten by its next chunk before any read) or go to the
scratch page through an unmapped row.

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
recurrent rows (``ssm``, ``conv``) are masked, cleared and written back.

``kv_mode='ring'`` is the baseline the pool replaces: every slot owns a
ring sized ``cache_len(max_seq)`` (:func:`kvcache.batched_cache`), and
admission is one monolithic ``model.prefill(prompt, seq_len=max_seq)``
whose cache is copied whole into the slot's rows (EMPTY -> ACTIVE within
one call).  A from-scratch prefill of STREAM_KV_THRESHOLD tokens or more
attends its fresh k/v through the flash-attention kernel.  There is no
pool, so ``paged_kernel`` is refused, and ``reset``/``audit`` have no pool
to touch.

On a CUDA device the batched decode step and the ``prefill_chunk``-token
chunk step each run as a CUDA graph (:mod:`repro_torch.serve.graphs`),
captured at their first call and replayed after, the counterpart of the
reference's jitted steps.  The decode step is fixed-shape and mask-only:
every row is computed, and ``active`` decides per row what is kept.  Both
steps read their inputs from, and write their results into, tensors whose
storage never moves: the cache, ``last_tokens``, ``out_buf``, ``out_pos``,
the ``active`` mask and the chunk's token and slot buffers.  A chunk of
another length (a prompt's tail, or the whole prompt when
``prefill_chunk`` is None) and ring mode's monolithic prefill run eagerly
on the same kernels.  On the CPU every step runs eagerly.

Not ported yet, and refused rather than ignored: KV offload, prefix
sharing, session parking, speculative decoding and ``mesh=``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import kvcache
from . import sampling
from .engine import make_chunk_step
from .graphs import StepGraphs
from .lifecycle import Slot, SlotState

CONTINUOUS_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def supports_continuous(cfg) -> bool:
    return getattr(cfg, "family", None) in CONTINUOUS_FAMILIES


@dataclasses.dataclass
class _Request:
    session: str
    request_id: str
    prompt: Any                 # (P,) int tokens
    max_new: int
    submit_step: int = 0


@dataclasses.dataclass
class CompletedRequest:
    session: str
    request_id: str
    tokens: np.ndarray          # (max_new,) generated tokens
    admitted_step: int
    finished_step: int
    submitted_step: int = 0     # admission stall = admitted - submitted


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


class DecodeScheduler:
    """Continuous batching over a shared paged pool (or per-slot rings)."""

    def __init__(self, model, *, n_slots: int = 4, max_seq: int = 64,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 kv_mode: str = "paged", page_size: int = 16,
                 kv_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 attn_backend: str = "gather", device="cuda",
                 mesh=None, offload: bool = False, prefix_sharing: bool = False,
                 park_sessions: bool = False, draft_model=None, spec_k: int = 0):
        if not supports_continuous(model.cfg):
            raise ValueError(
                f"family {model.cfg.family!r} has no per-slot decode path here; "
                f"continuous batching supports {CONTINUOUS_FAMILIES}")
        if kv_mode not in ("paged", "ring"):
            raise ValueError(f"kv_mode must be 'paged' or 'ring', got {kv_mode!r}")
        for flag, what in ((mesh is not None, "mesh="), (offload, "KV offload"),
                           (prefix_sharing, "prefix sharing"),
                           (park_sessions, "session parking"),
                           (draft_model is not None or spec_k, "speculative decoding")):
            if flag:
                raise _not_ported(what)
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

        self.page_size = page_size
        self.max_pages = -(-max_seq // page_size)
        self.n_pages = kv_pages if kv_pages is not None else n_slots * self.max_pages
        if not (kv_mode == "paged" and self._has_kv):
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
        if kv_mode == "paged":
            self.cache = kvcache.paged_cache(model, n_slots, page_size=page_size,
                                             n_pages=self.n_pages,
                                             max_pages=self.max_pages)
            self._chunk = make_chunk_step(model)
        else:
            self.cache = kvcache.batched_cache(model, n_slots, max_seq)

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
                       if self.device.type == "cuda" else None)
        self.pending: List[_Request] = []
        self._active_sessions: set = set()
        self._chunk_rr = 0            # round-robin over admitting slots
        # -- occupancy / throughput accounting --------------------------------
        self.steps = 0
        self.slot_steps = 0           # sum over steps of active slots
        self.page_step_sum = 0        # sum over steps of pages in use
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.decode_tokens = 0
        self.admitted = 0
        self.completed = 0

    # -- admission ----------------------------------------------------------------

    def submit(self, session: str, request_id: str, prompt, max_new: int) -> None:
        """Enqueue a request; admitted into a free slot as soon as its
        session has no in-flight predecessor (per-session FIFO gate) and the
        pool's uncommitted pages cover its worst case.

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
        return any(s.working for s in self.slots) or bool(self.pending)

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s.empty)

    def active_slots(self) -> int:
        """Slots decoding+sampling this step (admitting excluded)."""
        return sum(1 for s in self.slots if s.decoding)

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
        held_sessions: set = set()    # a held request gates its whole session
        for req in self.pending:
            if req.session in self._active_sessions or req.session in held_sessions:
                held.append(req)      # FIFO gate: predecessor decoding or held
                held_sessions.add(req.session)
                continue
            slot = next((s for s in self.slots if s.empty), None)
            need = self._pages_needed(req)
            if slot is None or self._uncommitted() < need:
                held.append(req)
                held_sessions.add(req.session)
                continue
            self._admit(slot, req, need)
        self.pending = held

    def _admit(self, slot: Slot, req: _Request, need: int) -> None:
        if self.kv_mode == "paged":
            self._admit_paged(slot, req, need)
            return
        # ring: one monolithic prefill into a fresh B=1 ring, copied whole
        # into the slot's rows; the slot is ACTIVE when this returns
        self._begin(slot, req)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32).reshape(1, -1))
        logits, one = self.model.prefill(prompt.to(self.device), seq_len=self.max_seq)
        kvcache.cache_insert_slot(self.cache, one, slot.index)
        slot.len = prompt.shape[1]
        self.prefill_tokens += prompt.shape[1]
        self._activate(slot, logits)

    def _admit_paged(self, slot: Slot, req: _Request, need: int) -> None:
        """Begin a chunked admission: clear the slot's rows, reserve its
        worst case and stage the prompt in ``prefill_chunk`` pieces (a
        1-token final chunk is fine — the S=1 forward is the chunk path)."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        size = self.prefill_chunk or len(prompt)
        kvcache.cache_clear_slot(self.cache, slot.index)
        self._page_rows[slot.index, :] = -1
        self._reserved += need
        self._begin(slot, req)
        slot.chunks = [prompt[i:i + size] for i in range(0, len(prompt), size)]
        slot.chunk_i = 0
        slot.len = 0                  # host mirror of the slot's live length
        slot.pages = []
        slot.need = need

    def _begin(self, slot: Slot, req: _Request) -> None:
        """EMPTY -> ADMITTING: bind the request and close its session's FIFO gate."""
        slot.to(SlotState.ADMITTING)
        slot.req = req
        slot.n_out = 0
        slot.admitted_step = self.steps
        slot.submitted_step = req.submit_step
        self._active_sessions.add(req.session)

    def _activate(self, slot: Slot, logits: torch.Tensor) -> None:
        """ADMITTING -> ACTIVE: the prompt's last logits give the first token."""
        tok = self._sample(logits[:, -1])
        self.last_tokens[slot.index] = tok[0]
        self.out_buf[slot.index, 0] = tok[0]
        self.out_pos[slot.index] = 1
        slot.to(SlotState.ACTIVE)
        slot.active_since = self.steps
        slot.n_out = 1
        self.admitted += 1

    def _release_slot(self, slot: Slot) -> None:
        """Free a DRAINED slot's pages and unused reservation, and unmap its
        device page-table row so residual decode traffic is dropped."""
        slot.to(SlotState.EMPTY)
        if self.kv_mode == "paged":
            self._reserved -= slot.need - len(slot.pages)
            if slot.pages:
                self.allocator.release(slot.pages)
            self._page_rows[slot.index, :] = -1
            kvcache.set_page_row(self.cache, slot.index, self._page_rows[slot.index])
        self.slots[slot.index] = Slot(index=slot.index)

    def _prepare_write_span(self, slot: Slot, pos0: int, count: int) -> None:
        """Map the unmapped pages under ``[pos0, pos0 + count)`` for this
        slot (alloc-on-write, within its reservation) and push the row to
        the device once."""
        changed = False
        hi = min((pos0 + count - 1) // self.page_size, self.max_pages - 1)
        for pidx in range(pos0 // self.page_size, hi + 1):
            if self._page_rows[slot.index, pidx] < 0 and len(slot.pages) < slot.need:
                # past the reservation the final dangling write is dropped
                pid = self.allocator.alloc(1)[0]
                self._page_rows[slot.index, pidx] = pid
                slot.pages.append(pid)
                self._reserved -= 1
                changed = True
        if changed:
            kvcache.set_page_row(self.cache, slot.index, self._page_rows[slot.index])

    def _run_chunk(self, slot: Slot) -> None:
        """One prefill chunk for one admitting slot; the final chunk's
        logits seed the slot's first token."""
        chunk = slot.chunks[slot.chunk_i]
        C = len(chunk)
        self._prepare_write_span(slot, slot.len, C)
        logits = self._chunk_logits(chunk, slot.index)
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
        eagerly."""
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
        is computed, and ``active`` (n_slots,) bool keeps freed and
        mid-admission slots' tokens, output rings, lengths and recurrent
        rows as they were."""
        logits, new_cache = self.model.decode_step(cache, last_tokens[:, None])
        kvcache.mask_slot_rows(new_cache, cache, active)
        toks = torch.where(active, self._sample(logits[:, -1]), last_tokens)
        col = (out_pos % self.max_seq).long()[:, None]
        out_buf.scatter_(1, col, torch.where(active[:, None], toks[:, None],
                                             out_buf.gather(1, col)))
        out_pos.add_(active.to(torch.int32))
        last_tokens.copy_(toks)

    def _decode(self) -> None:
        """The batched decode step over ``self._active``: on the card the
        decode graph's replay (captured at the first call), on the CPU the
        eager step."""
        def step():
            self._step_impl(self.cache, self.last_tokens, self.out_buf, self.out_pos,
                            self._active)
        if self.graphs is None:
            step()
        else:
            self.graphs.run("decode", step)

    def step(self) -> List[CompletedRequest]:
        """One scheduler tick: at most one prefill chunk (round-robin over
        admitting slots), then one batched decode step over the active
        slots; returns the requests that completed this step (their slots
        are refilled from the pending list before returning)."""
        self._fill_slots()
        admitting = [s for s in self.slots if s.state is SlotState.ADMITTING]
        if admitting:
            pick = admitting[self._chunk_rr % len(admitting)]
            self._chunk_rr += 1
            self._run_chunk(pick)
        active = [s.index for s in self.slots if s.decoding]
        if not active:
            return []
        if self.kv_mode == "paged":
            for i in active:
                # alloc-on-write for decode growth: map the page this step's
                # token write lands in (within the reservation)
                st = self.slots[i]
                self._prepare_write_span(st, st.len, 1)
        mask = np.zeros((self.n_slots,), bool)
        mask[active] = True
        self._active.copy_(torch.from_numpy(mask))
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
                    submitted_step=st.submitted_step))
                self._release_slot(st)
                self._active_sessions.discard(req.session)
                self.completed += 1
        if finished:
            self._fill_slots()
        return finished

    def reset(self) -> None:
        """Abort all in-flight work (crash recovery: the queue layer
        redelivers; completed requests are deduped by the frontend).  The
        pool returns to fully free and every page-table row to unmapped; the
        schedule and the sampling generator restart, so a replay is a pure
        function of the submitted work.  Rings have no pool: each admission
        overwrites its slot's rows whole.  The CUDA graphs are kept: their
        static buffers are zeroed in place."""
        self.slots = [s.force_empty() for s in self.slots]
        self.pending = []
        self._active_sessions.clear()
        self._chunk_rr = 0
        self._gen.manual_seed(self._seed)
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
                kvcache.cache_clear_slot(self.cache, slot)

    # -- invariant audit -------------------------------------------------------------

    def audit(self) -> None:
        """Raise AssertionError if an allocator, page-table or reservation
        invariant is violated: ``free + in_use == n_pages``; every mapped
        page has refcount 1 and one owner; each slot's host row maps exactly
        the pages it holds and equals the device row; the reservation ledger
        equals the outstanding worst-case growth.  Rings have no pool to
        audit."""
        if self.kv_mode != "paged":
            return
        a = self.allocator
        a.check()
        owned: set = set()
        for s in self.slots:
            for p in s.pages:
                assert p not in owned, f"page {p} owned by two slots"
                owned.add(p)
        assert len(owned) == a.total_refs == a.in_use, (
            f"refcount drift: slots hold {len(owned)} pages, allocator has "
            f"{a.in_use} in use / {a.total_refs} refs")
        device_rows = self.cache["page_table"].cpu().numpy()
        for s in self.slots:
            row = self._page_rows[s.index]
            mapped = {int(p) for p in row if p >= 0}
            assert mapped == set(s.pages), (
                f"slot {s.index} ({s.state.value}): row maps {mapped}, "
                f"holds {set(s.pages)}")
            assert (device_rows[s.index] == row).all(), (
                f"slot {s.index}: device page-table row drifted from the host mirror")
        reserved = sum(s.need - len(s.pages) for s in self.slots
                       if s.state in (SlotState.ADMITTING, SlotState.ACTIVE))
        assert reserved == self._reserved, (
            f"reservation ledger drift: slots imply {reserved}, "
            f"ledger says {self._reserved}")
        assert self._uncommitted() >= 0, (
            f"over-committed pool: {self._reserved} reserved, {a.free_count} free")

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

    def stats(self) -> Dict[str, float]:
        return {
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
