"""Explicit slot lifecycle for the continuous-batching scheduler.

FaaSKeeper's lesson (PAPER.md §3-4) applied to the decode plane: compute is
ephemeral and reclaimable, durable state belongs in storage.  A decode slot
is the unit of reclaimable compute, and its lifecycle — previously implicit
in scattered ``admitting`` flags and completion-time frees — is an explicit
state machine::

    EMPTY ──▶ ADMITTING ──▶ ACTIVE ──▶ DRAINED ──▶ EMPTY
                 ▲            │  ▲        │
                 │   preempt  ▼  │        ▼ park (session retention)
                 │        PREEMPTED ──▶ RESTORING
                 │                        ▲
                 └──────── PARKED ────────┘-ish    (see below)

* **EMPTY** — no request; every per-slot cache row cleared / unmapped.
* **ADMITTING** — prompt chunks landing (one per step); masked out of
  sampling, token writes, and cache-row updates.
* **ACTIVE** — decoding one token per step.
* **PREEMPTED** — KV pages offloaded to the object store and freed back to
  the pool; the slot keeps its row (recurrent state, lengths, output ring
  stay frozen under the decode mask) but holds **zero pool pages and zero
  reservation** — the capacity a long-running session was pinning is
  reclaimed.
* **RESTORING** — page blobs re-allocated and injected chunk-by-chunk,
  interleaved with the batch's decode steps exactly like prefill chunks.
* **DRAINED** — request completed this step; transitions to EMPTY when the
  slot is released for reuse, or — with session parking on — to PARKED.
* **PARKED** — the FaaSKeeper session move: the request completed but its
  session's KV pages (and recurrent rows) stay resident, owned by the
  scheduler's parked-session record, so the session's *next* request maps
  them shared (copy-on-write) and prefills only its new tail tokens.  A
  parked slot is masked out of decode like EMPTY, pins **zero
  reservation**, and is reclaimable: a new admission may evict it (rows
  snapshotted to the parked record; under pool pressure the pages offload
  through the page-blob store).  PARKED -> ADMITTING is the in-place
  unpark; PARKED -> EMPTY is eviction or TTL expiry.

Transitions outside :data:`TRANSITIONS` raise — the scheduler cannot
silently re-grow the flag soup.  ``reset()`` (crash recovery) is the one
escape hatch: any state force-returns to EMPTY via :meth:`Slot.force_empty`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class SlotState(enum.Enum):
    EMPTY = "empty"
    ADMITTING = "admitting"
    ACTIVE = "active"
    PREEMPTED = "preempted"
    RESTORING = "restoring"
    DRAINED = "drained"
    PARKED = "parked"


# Legal transitions.  RESTORING -> PREEMPTED is deliberately absent: a
# restore, once funded by the reservation gate, always runs to completion
# (re-preempting a half-injected slot would interleave two blob generations).
# PARKED -> ACTIVE is likewise absent: an unpark always re-enters through
# ADMITTING (at least the last history token is re-fed to seed sampling).
TRANSITIONS: Dict[SlotState, tuple] = {
    SlotState.EMPTY: (SlotState.ADMITTING,),
    SlotState.ADMITTING: (SlotState.ACTIVE,),
    SlotState.ACTIVE: (SlotState.PREEMPTED, SlotState.DRAINED),
    SlotState.PREEMPTED: (SlotState.RESTORING,),
    SlotState.RESTORING: (SlotState.ACTIVE,),
    SlotState.DRAINED: (SlotState.EMPTY, SlotState.PARKED),
    SlotState.PARKED: (SlotState.ADMITTING, SlotState.EMPTY),
}


class IllegalTransition(RuntimeError):
    pass


@dataclasses.dataclass
class Slot:
    """One decode slot: state + the per-request bookkeeping that used to
    live in an ad-hoc dict.  The device never sees this object — it is the
    host-side mirror the scheduler plans against."""

    index: int
    state: SlotState = SlotState.EMPTY

    req: Any = None                    # the admitted _Request
    chunks: Optional[List] = None      # pending prompt chunks (ADMITTING)
    chunk_i: int = 0
    len: int = 0                       # host mirror of the slot's live length
    pages: List[int] = dataclasses.field(default_factory=list)   # owned (rc 1 at alloc)
    shared: List[int] = dataclasses.field(default_factory=list)  # share-mapped refs
    need: int = 0                      # worst-case page count (reservation)
    reused: int = 0                    # prompt tokens served from shared pages
    n_out: int = 0
    admitted_step: int = 0             # step the request entered the slot
    submitted_step: int = 0
    active_since: int = 0              # step the slot last became ACTIVE

    # -- offload bookkeeping (PREEMPTED / RESTORING) ------------------------
    blob_key: Optional[str] = None
    blob_pidx: List[int] = dataclasses.field(default_factory=list)
    blob: Any = None                   # host-side page blob during restore
    restore_i: int = 0                 # pages injected so far
    preempts: int = 0                  # times this request was preempted

    # -- parking bookkeeping (PARKED) ---------------------------------------
    session: Optional[str] = None      # session whose parked record owns this slot
    parked_step: int = 0               # step the slot entered PARKED (TTL clock)

    # -- speculative-decoding bookkeeping (draft-and-verify, ACTIVE) --------
    # The draft model keeps its own per-slot ring cache; these host mirrors
    # track how much of the *canonical* stream (prompt + accepted tokens) the
    # draft has consumed, and which canonical tokens it still has to catch up
    # on before proposing the next window.  Rejected proposals advance none
    # of this — the draft row's device length is rewound to ``draft_len``
    # after every verify round.
    draft_len: int = 0                 # canonical tokens the draft consumed
    spec_pending: List[int] = dataclasses.field(default_factory=list)
    # ^ canonical tokens the draft must consume next round (prompt + first
    #   sampled token at admission; 1-2 tokens per round thereafter)
    spec_last: int = 0                 # host mirror of last_tokens[index] (the
    # newest canonical token, not yet consumed by the target — the hybrid
    # rollback replay re-feeds it)

    def to(self, new_state: SlotState) -> "Slot":
        if new_state not in TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"slot {self.index}: {self.state.value} -> {new_state.value} "
                f"(legal: {[s.value for s in TRANSITIONS[self.state]]})")
        self.state = new_state
        return self

    def force_empty(self) -> "Slot":
        """Crash-recovery escape hatch: wipe the slot back to EMPTY from any
        state.  Only ``reset()`` may use this."""
        self.__init__(index=self.index)
        return self

    # -- predicates the scheduler plans with --------------------------------

    @property
    def empty(self) -> bool:
        return self.state is SlotState.EMPTY

    @property
    def occupied(self) -> bool:
        return self.state is not SlotState.EMPTY

    @property
    def parked(self) -> bool:
        return self.state is SlotState.PARKED

    @property
    def working(self) -> bool:
        """Carrying an in-flight request (PARKED retention is not work —
        ``busy()`` must not spin on it)."""
        return self.state not in (SlotState.EMPTY, SlotState.PARKED)

    @property
    def decoding(self) -> bool:
        """In the batched decode step's active mask this step."""
        return self.state is SlotState.ACTIVE

    def age(self, step: int) -> int:
        """Steps spent ACTIVE since last (re)activation — the idleness
        signal the preemption policy ranks victims by."""
        return step - self.active_since
