"""Elastic scale-to-zero fleet of disposable ``DecodeScheduler`` workers.

The FaaSKeeper thesis applied to LLM serving: a scheduler worker is a
*function*, not a server.  Everything a worker must not lose already lives
outside it — preempt spills and parked-session journals in the shared
:class:`~repro_torch.core.storage.PageBlobStore`, shared prefixes in the
content-addressed index journal (``index/<chain-hash>`` blobs), and the
cross-request session directory as ``park-meta/<session>`` records — so the
controller can spawn workers on queue bursts, drain-then-park them on
scale-down, kill them on crashes, and scale the whole fleet to zero, with a
cold start rebuilding a worker from storage alone.

On a mesh (every worker a ``DecodeScheduler(mesh=)`` on the same live
mesh, as the reference's launcher builds them) every rank runs the same
controller over the same submits, fault plan and events, and its workers
share that rank's blob store: a blob there is the rank's lanes or heads of
its pages, under the same key on every rank, and a ``park-meta`` record
names the mesh shape that wrote it (adopting it on another shape raises).

Coordination uses the repo's own primitives: each worker holds an ephemeral
znode via :class:`~repro_torch.coord.membership.MembershipService` (heartbeat
eviction is the crash detector — a wedged worker stops renewing and the
controller reaps it when its znode disappears), and crash points are driven
by :class:`~repro_torch.core.simcloud.FaultPlan` under the function names
``fleet:<worker-id>`` at the labels ``mid-decode``, ``mid-restore`` and
``mid-park``.

Durable-state protocol (what survives which failure):

- **Worker drain** offloads every parked journal's pages to the shared
  store (`park/<ns><session>/...` KV blob), then commits a
  ``park-meta/<session>`` record pointing at it.  The meta PUT is the
  commit point: a crash between the two leaves an orphaned KV blob that
  the controller garbage-collects — the session re-prefills (correct,
  just slower).
- **Worker crash** loses everything resident (pool pages, slots, its
  in-flight requests) but nothing committed: in-flight requests are
  requeued fleet-level in original submit order, metas keep their KV
  blobs alive across the GC of the dead worker's namespaced keys, and
  journaled index entries were already content-addressed blobs.
- **Cold start** re-adopts journaled index pages into the fresh pool and
  lazily re-attaches ``park-meta`` journals when their session's next
  request is routed — prefilling only tokens the journal does not cover.

On the card every worker holds its own page pool and its own CUDA graphs
(:class:`~repro_torch.serve.graphs.StepGraphs`, captured once per worker
and kept across incarnations: a recycled worker captures nothing new).  The
workers share one model's weights and some per-device kernel state (the
paged kernel's split scratch is keyed by stream, and each worker's graphs
have their own side stream; the MoE route kernel's last-block counters are
one tensor per device), so the controller steps its workers one after
another, as the reference does, and never concurrently.  Crash points are
consulted before a worker steps, so a simulated crash never interrupts a
capture or a replay.  A ``park-meta`` record is host data (numpy history
and page row, CPU row tensors): it outlives its worker, whose device rows
``reset()`` overwrites in place.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import kvcache
from .lifecycle import SlotState
from .scheduler import CompletedRequest, DecodeScheduler, ParkedSession

PARK_META_PREFIX = "park-meta/"
# nominal serialized overhead of a park-meta record beyond its arrays
# (key, lengths, blob pointer) — billed so the directory is not free
_META_OVERHEAD_BYTES = 256


@dataclasses.dataclass
class FleetRequest:
    """A request queued fleet-level (not yet owned by any worker)."""

    session: str
    request_id: str
    prompt: np.ndarray
    max_new: int
    seq: int = 0                # fleet-wide submit order (requeue key)


@dataclasses.dataclass
class WorkerEvent:
    """Lifecycle event feed the frontend drains for per-worker billing."""

    kind: str                   # spawn | retire | crash | evicted
    worker_id: str
    step: int
    busy_steps: int = 0
    from_zero: bool = False     # spawn while the fleet was at zero workers


class FleetWorker:
    """One live worker: a recycled ``DecodeScheduler`` incarnation plus its
    membership handle and scaling bookkeeping."""

    def __init__(self, worker_id: str, sched: DecodeScheduler,
                 incarnation: int, spawned_step: int):
        self.worker_id = worker_id
        self.sched = sched
        self.incarnation = incarnation
        self.spawned_step = spawned_step
        self.handle = None              # membership WorkerHandle
        self.state = "running"          # running | draining | wedged
        self.idle_steps = 0
        self.busy_steps = 0


class FleetController:
    """N disposable scheduler workers behind one dispatch queue.

    ``schedulers`` is the prebuilt worker pool (graphs captured once, reused
    across incarnations — a "spawn" is a FaaS container start, not a new
    program).
    All of them must share one blob store and have ``park_sessions`` and
    (for index survival) ``index_journal`` enabled.  ``max_workers`` is
    ``len(schedulers)``.
    """

    def __init__(self, schedulers: Sequence[DecodeScheduler], *,
                 min_workers: int = 0, scale_to_zero: bool = True,
                 drain_idle_steps: int = 4, membership=None, faults=None):
        if not schedulers:
            raise ValueError("a fleet needs at least one worker scheduler")
        store = schedulers[0].blob_store
        for s in schedulers:
            if s.blob_store is not store:
                raise ValueError("fleet workers must share one blob store "
                                 "(it is the durable substrate)")
        self.blob_store = store
        self._pool: List[DecodeScheduler] = list(schedulers)
        self.max_workers = len(self._pool)
        self.min_workers = min(min_workers, self.max_workers)
        self.scale_to_zero = bool(scale_to_zero)
        self.drain_idle_steps = drain_idle_steps
        self.membership = membership
        self.faults = faults

        self.workers: Dict[str, FleetWorker] = {}
        self.pending: List[FleetRequest] = []
        self._inflight: Dict[str, Tuple[str, FleetRequest]] = {}
        self._incarnations: Dict[str, int] = {}
        self._seq = 0
        self.steps = 0
        self.events: List[WorkerEvent] = []
        # every lifecycle event and park-meta adoption in order, never
        # drained (the ranks of a mesh fleet must agree on it)
        self.log: List[tuple] = []
        self.last_decoded_workers = 0   # workers that decoded in the last tick

        # gauges
        self.spawns = 0
        self.retires = 0
        self.crashes = 0
        self.evictions = 0
        self.cold_starts_from_zero = 0
        self.meta_puts = 0
        self.meta_adoptions = 0
        self.meta_dropped = 0
        self.gc_blobs = 0

    # -- submission ----------------------------------------------------------

    def submit(self, session: str, request_id: str, prompt,
               max_new: int) -> None:
        """Queue a request fleet-level; routing happens inside ``step()``
        (per-session stickiness to the worker holding the session's state,
        least-loaded otherwise, held when nothing can take it)."""
        self.pending.append(FleetRequest(
            session=session, request_id=request_id,
            prompt=np.asarray(prompt), max_new=max_new, seq=self._seq))
        self._seq += 1

    def busy(self) -> bool:
        return (bool(self.pending) or bool(self._inflight)
                or any(w.sched.busy() for w in self.workers.values()))

    def free_slots(self) -> int:
        """Admission capacity a queue claim can target: free slots on
        running workers plus whole-worker capacity still spawnable."""
        free = sum(w.sched.free_slots() for w in self.workers.values()
                   if w.state == "running")
        free += sum(s.n_slots for s in self._pool)
        return free

    def wants_more(self) -> bool:
        return self.free_slots() > 0

    def live_workers(self) -> int:
        return len(self.workers)

    def _all_scheds(self) -> List[DecodeScheduler]:
        return [w.sched for w in self.workers.values()] + self._pool

    def prefill_tokens(self) -> int:
        """Fleet-wide prefill tokens (counters survive worker recycling, so
        the sum over live workers + the warm pool is monotone)."""
        return sum(s.prefill_tokens for s in self._all_scheds())

    def slot_steps(self) -> int:
        """Fleet-wide slot-step count (decode work units), same monotone
        aggregation as :meth:`prefill_tokens`."""
        return sum(s.slot_steps for s in self._all_scheds())

    # -- fault injection -----------------------------------------------------

    def _crash(self, w: FleetWorker, point: str) -> bool:
        if self.faults is None:
            return False
        return self.faults.should_crash(f"fleet:{w.worker_id}", point)

    def fail_worker(self, worker_id: str) -> None:
        """Wedge a worker (frozen process): it stops heartbeating and stops
        making progress, but its znode lingers until the membership sweep
        evicts it — only then does the controller reap and requeue.  This is
        the crash-*detection* path, vs the fail-stop `FaultPlan` crashes
        the controller observes synchronously."""
        w = self.workers[worker_id]
        w.state = "wedged"
        if self.membership is not None and w.handle is not None:
            self.membership.fail(w.handle)

    def crash_worker(self, worker_id: str) -> None:
        """Fail-stop crash, observed immediately (the dispatch layer sees
        the connection drop): requeue its work, GC its keys, free its id."""
        self._kill(self.workers[worker_id], "crash")

    # -- scaling -------------------------------------------------------------

    def scale_up(self) -> Optional[FleetWorker]:
        """Force one spawn (burst hint); returns None at max_workers."""
        if not self._pool:
            return None
        return self._spawn()

    def scale_down(self, worker_id: Optional[str] = None) -> Optional[str]:
        """Begin drain-then-park on one running worker (forced scale-down).
        The worker finishes its in-flight requests, externalizes every
        parked journal to the shared store, then leaves membership and
        returns its scheduler to the warm pool."""
        if worker_id is None:
            running = [w for w in self.workers.values()
                       if w.state == "running"]
            if not running:
                return None
            worker_id = min(running, key=lambda w: self._load(w)).worker_id
        self.workers[worker_id].state = "draining"
        return worker_id

    def _load(self, w: FleetWorker) -> int:
        return sum(1 for wid, _ in self._inflight.values()
                   if wid == w.worker_id)

    def _spawn(self) -> FleetWorker:
        sched = self._pool.pop()
        k = 0
        while f"w{k}" in self.workers:
            k += 1
        wid = f"w{k}"
        inc = self._incarnations.get(wid, 0) + 1
        self._incarnations[wid] = inc
        sched.blob_ns = f"{wid}.{inc}/"
        from_zero = not self.workers
        w = FleetWorker(wid, sched, inc, self.steps)
        if self.membership is not None:
            # re-using the lowest free id means a restart-after-crash joins
            # before the heartbeat evicted its predecessor's ephemeral —
            # the stale-znode takeover branch of MembershipService.join
            w.handle = self.membership.join(wid)
        self.workers[wid] = w
        # cold start: rebuild the prefix index from the journal blobs
        sched.adopt_index_journal()
        self.spawns += 1
        if from_zero:
            self.cold_starts_from_zero += 1
        self._event(WorkerEvent("spawn", wid, self.steps, from_zero=from_zero))
        return w

    def _autoscale(self) -> None:
        floor = self.min_workers
        if not self.scale_to_zero:
            floor = max(floor, 1)
        # hold the floor (an always-warm reserve when scale-to-zero is off)
        while (sum(1 for w in self.workers.values()
                   if w.state == "running") < floor and self._pool):
            self._spawn()
        # up: queued work the running workers cannot absorb
        free = sum(w.sched.free_slots() for w in self.workers.values()
                   if w.state == "running")
        while len(self.pending) > free and self._pool:
            free += self._spawn().sched.n_slots
        # down: workers idle past the threshold, beyond the floor
        for w in list(self.workers.values()):
            if w.state != "running":
                continue
            if w.sched.busy() or self._load(w) or self.pending:
                w.idle_steps = 0
                continue
            w.idle_steps += 1
            running = sum(1 for x in self.workers.values()
                          if x.state == "running")
            if w.idle_steps > self.drain_idle_steps and running > floor:
                w.state = "draining"

    # -- durable session directory (park-meta records) -----------------------

    def _put_meta(self, rec: ParkedSession) -> None:
        """Commit an externalized journal to the directory.  The record is
        pure host data + a blob pointer after ``externalize_session``; this
        PUT is what makes the session survive the worker."""
        meta = {"session": rec.session, "history": rec.history,
                "consumed": rec.consumed, "page_row": rec.page_row,
                "state": rec.state, "blob_key": rec.blob_key,
                "blob_pidx": list(rec.blob_pidx), "mesh_shape": rec.mesh_shape}
        nbytes = _META_OVERHEAD_BYTES + rec.history.nbytes
        if rec.state is not None:
            nbytes += kvcache.blob_nbytes(rec.state)
        self.blob_store.put(PARK_META_PREFIX + rec.session, meta, nbytes)
        self.meta_puts += 1

    def _try_adopt_meta(self, w: FleetWorker, session: str) -> bool:
        """Route a directory journal to the worker about to serve its
        session.  A dangling pointer (crash-during-drain GC'd the KV blob,
        or a live worker superseded it) drops the meta — the session falls
        back to a full re-prefill."""
        key = PARK_META_PREFIX + session
        if key not in self.blob_store.blobs:
            return False
        meta = self.blob_store.get(key)
        if meta["blob_key"] not in self.blob_store.blobs:
            self.blob_store.delete(key)
            self.meta_dropped += 1
            return False
        rec = ParkedSession(
            session=session, history=np.asarray(meta["history"]),
            consumed=int(meta["consumed"]),
            page_row=np.asarray(meta["page_row"]), pages=[], slot=None,
            state=meta["state"], blob_key=meta["blob_key"],
            blob_pidx=list(meta["blob_pidx"]), mesh_shape=meta["mesh_shape"])
        w.sched.adopt_parked(rec)
        self.meta_adoptions += 1
        self.log.append(("adopt", w.worker_id, self.steps, session))
        # the meta stays until this session next completes: if the adopter
        # crashes mid-restore, the journal must still be re-adoptable
        return True

    def _iter_metas(self) -> Dict[str, dict]:
        # direct (unbilled) view — controller bookkeeping, not data-path IO
        return {k: self.blob_store.blobs[k] for k in self.blob_store.blobs
                if k.startswith(PARK_META_PREFIX)}

    # -- worker death --------------------------------------------------------

    def _kill(self, w: FleetWorker, reason: str) -> None:
        """Remove a worker (crash / eviction / completed drain): requeue its
        in-flight requests in original submit order, garbage-collect its
        namespaced transient blobs (everything except KV blobs a committed
        ``park-meta`` record still points at), settle membership, and recycle
        the scheduler — without touching shared durable state."""
        back = sorted((req for wid, req in self._inflight.values()
                       if wid == w.worker_id), key=lambda r: r.seq)
        for req in back:
            del self._inflight[req.request_id]
        self.pending = sorted(self.pending + back, key=lambda r: r.seq)
        ns = w.sched.blob_ns
        protected = {m["blob_key"] for m in self._iter_metas().values()}
        for key in list(self.blob_store.blobs):
            if (key.startswith((f"park/{ns}", f"kv/{ns}"))
                    and key not in protected):
                self.blob_store.delete(key)
                self.gc_blobs += 1
        if self.membership is not None and w.handle is not None:
            if reason == "retire":
                self.membership.leave(w.handle)
            elif reason == "crash":
                # fail-stop: the znode lingers until the heartbeat sweep
                # (or a restart-takeover) clears it
                self.membership.fail(w.handle)
        w.sched.reset(clear_blob_store=False)
        w.sched.blob_ns = ""
        self._pool.append(w.sched)
        del self.workers[w.worker_id]
        if reason == "crash":
            self.crashes += 1
        elif reason == "evicted":
            self.evictions += 1
        elif reason == "retire":
            self.retires += 1
        self._event(WorkerEvent(reason, w.worker_id, self.steps, busy_steps=w.busy_steps))

    def _reap_evicted(self) -> None:
        """Heartbeat-eviction crash detection: any worker whose ephemeral
        znode vanished (the membership sweep removed a failed session) is
        dead to the fleet, whatever its host object thinks."""
        if self.membership is None or not self.workers:
            return
        alive = set(self.membership.members())
        for w in list(self.workers.values()):
            if w.handle is not None and w.worker_id not in alive:
                self._kill(w, "evicted")

    def _finish_drain(self, w: FleetWorker) -> None:
        """Drain complete (no in-flight work): externalize every parked
        journal — KV blob first, then the park-meta commit — and retire.
        The ``mid-park`` crash point sits between the two PUTs: a crash
        there orphans the KV blob (GC'd in the kill path) and the session
        re-prefills on its next request."""
        sched = w.sched
        for session in list(sched._parked):
            rec = sched.externalize_session(session)
            if self._crash(w, "mid-park"):
                self._kill(w, "crash")
                return
            self._put_meta(rec)
        self._kill(w, "retire")

    # -- routing -------------------------------------------------------------

    def _home_worker(self, session: str) -> Optional[FleetWorker]:
        for wid, req in self._inflight.values():
            if req.session == session:
                return self.workers[wid]
        for w in self.workers.values():
            if (session in w.sched._active_sessions
                    or session in w.sched._parked):
                return w
        return None

    def _pick_worker(self) -> Optional[FleetWorker]:
        ready = [w for w in self.workers.values()
                 if w.state == "running" and w.sched.free_slots() > 0]
        if not ready:
            return None
        return min(ready, key=lambda w: (self._load(w), w.worker_id))

    def _dispatch(self) -> None:
        held: set = set()
        still: List[FleetRequest] = []
        for req in self.pending:
            if req.session in held:       # per-session FIFO across the fleet
                still.append(req)
                continue
            w = self._home_worker(req.session)
            if w is None:
                w = self._pick_worker()
                if w is not None:
                    self._try_adopt_meta(w, req.session)
            if w is None or w.state != "running":
                held.add(req.session)
                still.append(req)
                continue
            w.sched.submit(req.session, req.request_id, req.prompt,
                           req.max_new)
            self._inflight[req.request_id] = (w.worker_id, req)
        self.pending = still

    # -- the fleet tick ------------------------------------------------------

    def step(self) -> List[CompletedRequest]:
        """One controller tick: reap evictions, autoscale, route queued
        work, step every live worker (fault points consulted first), finish
        drains.  Wedged workers do not step — a frozen process makes no
        progress; its work comes back only through heartbeat eviction."""
        self._reap_evicted()
        self._autoscale()
        self._dispatch()
        fins: List[CompletedRequest] = []
        self.last_decoded_workers = 0
        for w in list(self.workers.values()):
            if w.state == "wedged" or not w.sched.busy():
                continue
            slots = w.sched.slots
            restoring = any(
                s.state is SlotState.RESTORING
                or (s.state is SlotState.ADMITTING and s.reused)
                for s in slots)
            if restoring and self._crash(w, "mid-restore"):
                self._kill(w, "crash")
                continue
            if any(s.decoding for s in slots) and self._crash(w, "mid-decode"):
                self._kill(w, "crash")
                continue
            w.busy_steps += 1
            s0 = w.sched.slot_steps
            fins_w = w.sched.step()
            if w.sched.slot_steps > s0:
                self.last_decoded_workers += 1
            for fin in fins_w:
                self._inflight.pop(fin.request_id, None)
                # the live worker's fresh park supersedes any directory
                # journal for this session (no-op when absent)
                self.blob_store.delete(PARK_META_PREFIX + fin.session)
                fins.append(fin)
        for w in list(self.workers.values()):
            if (w.state == "draining" and not w.sched.busy()
                    and not self._load(w)):
                self._finish_drain(w)
        self.steps += 1
        return fins

    def abort(self) -> None:
        """Controller crash (the serving invocation died): every live worker
        is gone with it — fail-stop kill each one (requeue + GC + membership
        fail), then drop the fleet-level queue; the dispatch queue redelivers
        the originating messages and dedup keeps completions exactly-once.
        Committed durable state (park-metas, index journal blobs) survives."""
        for w in list(self.workers.values()):
            self._kill(w, "crash")
        self.pending = []
        self._inflight.clear()

    def _event(self, ev: WorkerEvent) -> None:
        self.events.append(ev)
        self.log.append(dataclasses.astuple(ev))

    def drain_events(self) -> List[WorkerEvent]:
        ev, self.events = self.events, []
        return ev

    def drain_offload_ops(self) -> list:
        return self.blob_store.drain_ops()

    def reset(self, faults=None) -> None:
        """Back to an empty fleet over an empty store (test-sequence reuse;
        NOT a crash path — crashes go through ``_kill``)."""
        for w in list(self.workers.values()):
            if self.membership is not None and w.handle is not None:
                self.membership.leave(w.handle)
            w.sched.reset(clear_blob_store=False)
            w.sched.blob_ns = ""
            self._pool.append(w.sched)
        self.workers.clear()
        for s in self._pool:
            s.index_journal_puts = 0
            s.index_adopted = 0
        self.blob_store.clear()
        self.blob_store.drain_ops()
        self.pending = []
        self._inflight.clear()
        self._incarnations.clear()
        self.events = []
        self.log = []
        self._seq = 0
        self.steps = 0
        self.faults = faults
        for name in ("spawns", "retires", "crashes", "evictions",
                     "cold_starts_from_zero", "meta_puts", "meta_adoptions",
                     "meta_dropped", "gc_blobs"):
            setattr(self, name, 0)

    # -- cross-worker ledger audit ------------------------------------------

    def audit(self) -> None:
        """Fleet-wide invariants on top of each worker's own ``audit()``:

        - no session is live (active or parked) on two workers at once;
        - every live blob pointer (preempt spill, parked journal) resolves
          in the shared store;
        - every transient ``kv/``/``park/`` blob in the store is owned by
          exactly one live referent — plus, for an adopted journal, its
          not-yet-superseded ``park-meta`` record (orphans are GC'd at kill
          time, so nothing accretes);
        - every in-flight request maps to a live worker.
        """
        store = self.blob_store
        owner: Dict[str, str] = {}
        for wid, w in self.workers.items():
            w.sched.audit()
            for sess in (set(w.sched._active_sessions)
                         | set(w.sched._parked)):
                prev = owner.setdefault(sess, wid)
                assert prev == wid, (
                    f"session {sess!r} live on workers {prev} and {wid}")
        referenced: Counter = Counter()
        for w in self.workers.values():
            for sl in w.sched.slots:
                if sl.blob_key:
                    assert sl.blob_key in store.blobs, (
                        f"slot spill {sl.blob_key!r} missing from store")
                    referenced[sl.blob_key] += 1
            for rec in w.sched._parked.values():
                if rec.blob_key:
                    assert rec.blob_key in store.blobs, (
                        f"parked journal {rec.blob_key!r} missing from store")
                    referenced[rec.blob_key] += 1
        meta_refs = Counter(m["blob_key"]
                            for m in self._iter_metas().values())
        for key in store.blobs:
            if key.startswith("kv/"):
                assert referenced[key] == 1, (
                    f"preempt spill {key!r} has {referenced[key]} owners")
            elif key.startswith("park/"):
                n = referenced[key] + meta_refs[key]
                assert 1 <= n <= 2, (
                    f"park journal {key!r} has {n} owners "
                    f"(records {referenced[key]}, metas {meta_refs[key]})")
        for rid, (wid, _req) in self._inflight.items():
            assert wid in self.workers, (
                f"in-flight request {rid!r} maps to dead worker {wid}")

    # -- reporting -----------------------------------------------------------

    def fleet_stats(self) -> Dict[str, float]:
        return {
            "fleet_steps": self.steps,
            "workers_live": len(self.workers),
            "workers_max": self.max_workers,
            "spawns": self.spawns,
            "retires": self.retires,
            "crashes": self.crashes,
            "evictions": self.evictions,
            "cold_starts_from_zero": self.cold_starts_from_zero,
            "meta_puts": self.meta_puts,
            "meta_adoptions": self.meta_adoptions,
            "meta_dropped": self.meta_dropped,
            "gc_blobs": self.gc_blobs,
            "index_journal_puts": sum(
                s.index_journal_puts for s in self._all_scheds()),
            "index_adopted": sum(
                s.index_adopted for s in self._all_scheds()),
            "fleet_prefill_tokens": self.prefill_tokens(),
            "fleet_slot_steps": self.slot_steps(),
        }
