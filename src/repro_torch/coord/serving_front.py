"""Serving frontend: per-session FIFO queues feeding one shared batcher.

Inference requests take the paper's write-request path — per-client session
FIFO queues with batched event-function invocation — but the decode slot is
*cross-session*: every session queue routes into one shared dispatch queue,
so a model batch mixes arrivals from different sessions and the
per-invocation cost is amortized across clients (FaaSKeeper §4.2/§6).

Three batcher flavours behind the same queue plumbing:

* **whole-batch** (``model_fn``): one event-function invocation generates the
  full response for every request in its dispatch batch.
* **continuous** (``scheduler``): a
  :class:`repro_torch.serve.DecodeScheduler` holds a fixed-width decode
  batch; the invocation admits its dispatch batch into free slots and,
  between decode steps, long-polls the dispatch queue
  (``FifoQueue.claim_pending``) to refill slots that free up.
* **fleet** (``fleet``): a :class:`repro_torch.serve.FleetController` runs N
  disposable scheduler workers behind the same dispatch queue; the
  invocation ticks the controller (spawn on bursts, drain-and-park on idle,
  scale to zero) and bills each worker spawn as its own pay-per-invocation
  function start plus the parallel GB-seconds extra workers burn — the
  FaaSKeeper cost model applied to decode capacity.

Per-session FIFO survives every flavour: the dispatch queue is FIFO over arrival
order, whole-batch completes a batch atomically, and the scheduler admits a
session's next request only after its predecessor completes.  Delivery is
at-least-once: completions are deduped by request id, so a crashed handler
redelivers its batch without duplicating completions, and
claimed-but-unfinished messages are requeued.  ``mode='per-session'`` keeps
the one-queue-per-session batcher as the cost baseline.  A scheduler that
offloads, shares or parks KV pages journals its page-blob traffic; the
frontend bills each op under the object-store latency models and Table-4
rates, and the bytes it keeps stored as S3 retention over simulated time;
in fleet mode the journal is the fleet's shared store.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Generator, List, Optional

from ..core import (LAMBDA_GBS_PRICE, LAMBDA_INVOKE_PRICE, FifoQueue, FunctionRuntime,
                    SimCloud, Sleep)
from ..core.cost import page_blob_op_cost, page_blob_retention_cost

# per-worker billing identity in fleet mode: each spawn is a function start
# of its own (FaaSKeeper pay-per-invocation), kept separate from the "serve"
# controller invocation the dispatch queue triggers
WORKER_FN = "serve:worker"


@dataclass
class InferenceRequest:
    session: str
    request_id: str
    prompt: Any
    max_tokens: int = 8


def _ntokens(prompt: Any) -> int:
    return len(prompt) if hasattr(prompt, "__len__") else 1


class ServingFrontend:
    """Queue-fed batched inference over SimCloud.

    ``model_fn(prompts: list) -> list`` is the generate entry for the
    whole-batch flavour; ``scheduler`` (a ``DecodeScheduler``) selects the
    continuous flavour and ``fleet`` (a ``FleetController``) the elastic
    one.  Compute is billed under the calibrated ``prefill``
    / ``decode_step`` latency models, so GB-second billing is deterministic
    and identical across flavours for the same token work.
    """

    def __init__(self, cloud: SimCloud,
                 model_fn: Optional[Callable[[List[Any]], List[Any]]] = None,
                 *, scheduler=None, fleet=None, batch_size: int = 4,
                 function_memory_mb: int = 2048, mode: str = "shared"):
        if model_fn is None and scheduler is None and fleet is None:
            raise ValueError("need model_fn (whole-batch), scheduler "
                             "(continuous) or fleet (elastic)")
        if fleet is not None and scheduler is not None:
            raise ValueError("fleet and scheduler flavours are exclusive "
                             "(the fleet owns its worker schedulers)")
        if mode not in ("shared", "per-session"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "per-session" and (scheduler is not None or fleet is not None):
            raise ValueError("the per-session baseline has no shared scheduler")
        self.cloud = cloud
        self.model_fn = model_fn
        self.scheduler = scheduler
        self.fleet = fleet
        self.mode = mode
        self.runtime = FunctionRuntime(cloud, memory_mb=function_memory_mb)
        if fleet is not None:
            body = self._body_fleet
        elif scheduler is not None:
            body = self._body_continuous
        else:
            body = self._body_batch
        self._fn = self.runtime.wrap("serve", body)
        self.batch_size = batch_size
        self.queues: Dict[str, FifoQueue] = {}
        self.dispatch: Optional[FifoQueue] = None
        if mode == "shared":
            self.dispatch = FifoQueue(cloud, "serve:dispatch", handler=self._fn,
                                      batch_size=batch_size)
        self.results: Dict[str, List[Any]] = {}
        self.completions: Dict[str, List[str]] = {}
        self._done_ids: set = set()
        # page-blob storage accounting (continuous and fleet flavours): ops
        # drained from the scheduler's (or the fleet's shared) blob store and billed here, and the S3 GB-time of
        # the bytes it keeps stored between requests
        self.offload_storage_usd = 0.0
        self.offload_storage_ops = 0
        self.park_storage_usd = 0.0
        self._retention_billed_at = cloud.now

    def queue_for(self, session: str) -> FifoQueue:
        q = self.queues.get(session)
        if q is None:
            handler = self._pipe if self.mode == "shared" else self._fn
            q = FifoQueue(self.cloud, f"serve:{session}", handler=handler,
                          batch_size=self.batch_size)
            self.queues[session] = q
        return q

    # -- client side ---------------------------------------------------------------

    def submit(self, req: InferenceRequest) -> Generator:
        yield from self.queue_for(req.session).push(
            {"session": req.session, "request_id": req.request_id,
             "prompt": req.prompt, "max_tokens": req.max_tokens},
            size_kb=0.5,
        )
        return req.request_id

    # -- routing (session queue -> shared dispatch) ----------------------------------

    def _pipe(self, batch) -> Generator:
        """Queue pipe, not a billed function: the forward is an in-cloud
        push, so 'function invocations' stays the count of model
        invocations.  Zero wire latency, but the KB still count."""
        for m in batch:
            self.dispatch.push_immediate(m.body, size_kb=m.size_kb)
        if False:
            yield
        return None

    # -- completion bookkeeping ------------------------------------------------------

    def _complete(self, session: str, request_id: str, out: Any) -> bool:
        """Record a completion exactly once (idempotent under redelivery)."""
        if request_id in self._done_ids:
            return False
        self._done_ids.add(request_id)
        self.results.setdefault(session, []).append(out)
        self.completions.setdefault(session, []).append(request_id)
        return True

    def dead_letter_ids(self) -> List[str]:
        """Requests lost to poison-batch drops (a dead-lettered message whose
        request already completed is not a lost request)."""
        qs = list(self.queues.values()) + ([self.dispatch] if self.dispatch else [])
        return [m.body.get("request_id", "?") for q in qs for m in q.dead_letters
                if m.body.get("request_id") not in self._done_ids]

    def dropped_requests(self) -> int:
        return len(self.dead_letter_ids())

    def serving_stats(self) -> Dict[str, Any]:
        """Invocation counts and cost from the runtime, plus the scheduler's
        occupancy/token counters and KV pool gauges in continuous mode, or
        the fleet's gauges and its worker and storage bills in fleet mode."""
        st = self.runtime.stats.get("serve")
        if self.fleet is not None:
            mode = "fleet"
        elif self.scheduler is not None:
            mode = "continuous"
        else:
            mode = self.mode
        out: Dict[str, Any] = {
            "mode": mode,
            "invocations": st.invocations if st else 0,
            "cost_usd": self.runtime.cost_usd(),
            "dropped": self.dropped_requests(),
        }
        if self.fleet is not None:
            out.update(self.fleet.fleet_stats())
            wst = self.runtime.stats.get(WORKER_FN)
            out["worker_invocations"] = wst.invocations if wst else 0
            out["worker_cost_usd"] = (
                (wst.billed_seconds * LAMBDA_GBS_PRICE
                 + wst.invocations * LAMBDA_INVOKE_PRICE) if wst else 0.0)
            # the fleet always parks + journals: both storage meters apply
            out["offload_storage_usd"] = self.offload_storage_usd
            out["offload_storage_ops"] = self.offload_storage_ops
            out["park_storage_usd"] = self.park_storage_usd
        if self.scheduler is not None:
            out.update(self.scheduler.stats())
            out.update(self.scheduler.kv_memory_stats())
            sharing = (getattr(self.scheduler, "prefix_sharing", False)
                       or getattr(self.scheduler, "park_sessions", False))
            if getattr(self.scheduler, "offload", False) or sharing:
                # blob op spend covers preemption *and* parking traffic:
                # they share the store and the billing path
                out["offload_storage_usd"] = self.offload_storage_usd
                out["offload_storage_ops"] = self.offload_storage_ops
            if sharing:
                # the other side of the retention trade: the S3 GB-time of
                # keeping parked state durable sits next to
                # shared_prefix_tokens (the prefill it avoided)
                out["park_storage_usd"] = self.park_storage_usd
        return out

    def _bill_offload_ops(self) -> Generator:
        """Replay the scheduler's page-blob journal against the calibrated
        object-store latency models and Table-4 S3 op rates.  The blob data
        itself applied synchronously inside ``step()`` (a blocking S3
        client); what the cloud sees is the op's wire time and its bill.
        Stored blob bytes additionally accrue S3 retention over simulated
        time — the storage side of the parking-vs-re-prefill trade.  In
        fleet mode the journal is the fleet's shared store — the same
        billing path covers every worker."""
        src = self.fleet if self.fleet is not None else self.scheduler
        now = self.cloud.now
        stored = src.blob_store.bytes_stored
        if stored and now > self._retention_billed_at:
            self.park_storage_usd += page_blob_retention_cost(
                stored * (now - self._retention_billed_at))
        self._retention_billed_at = now
        for op, _key, kb in src.drain_offload_ops():
            kind = "obj_read" if op == "get" else "obj_write"
            yield Sleep(self.cloud.sample(kind, kb))
            self.offload_storage_usd += page_blob_op_cost(op)
            self.offload_storage_ops += 1

    def _bill_worker_events(self) -> Generator:
        """Drain the fleet's lifecycle feed: every spawn is a pay-per-
        invocation function start (cold — a fleet spawn is a fresh
        container), so the fleet's elasticity shows up as invocation count
        and cold-start latency, not free capacity."""
        for ev in self.fleet.drain_events():
            if ev.kind == "spawn":
                st = self.runtime._stats(WORKER_FN)
                st.invocations += 1
                st.cold_starts += 1
                yield Sleep(self.cloud.sample("cold_start"))

    # -- event function: whole-batch flavour ------------------------------------------

    def _body_batch(self, ctx, batch) -> Generator:
        fresh = [m for m in batch if m.body["request_id"] not in self._done_ids]
        if not fresh:
            return None
        prompts = [m.body["prompt"] for m in fresh]
        outputs = self.model_fn(prompts)
        # billed compute: one prefill over the batch's prompt tokens, then one
        # decode step per generated token
        yield Sleep(self.cloud.sample(
            "prefill", size_kb=sum(_ntokens(p) for p in prompts)))
        out_lens = [len(o) for o in outputs if hasattr(o, "__len__")]
        gen_steps = (max(out_lens) if out_lens
                     else max(m.body.get("max_tokens", 8) for m in fresh)) - 1
        for _ in range(gen_steps):
            yield Sleep(self.cloud.sample("decode_step", size_kb=len(fresh)))
        ctx.crash_point("post-model")
        # one storage-write-equivalent latency per batch (result persistence)
        yield Sleep(self.cloud.sample("kv_write", size_kb=1.0))
        for msg, out in zip(fresh, outputs, strict=True):
            body = msg.body
            self._complete(body["session"], body["request_id"], out)
            yield Sleep(self.cloud.sample("tcp_rtt"))
        return None

    # -- event function: continuous-batching flavour ----------------------------------

    def _body_continuous(self, ctx, batch) -> Generator:
        sched = self.scheduler
        claimed: List[Any] = []

        def feed(msgs):
            for m in msgs:
                b = m.body
                if b["request_id"] in self._done_ids:
                    continue
                sched.submit(b["session"], b["request_id"], b["prompt"],
                             b.get("max_tokens", 8))

        billed_prefill = sched.prefill_tokens
        try:
            feed(batch)
            while sched.busy():
                prev_slot_steps = sched.slot_steps
                finished = sched.step()
                # bill what actually decoded inside this step
                active = sched.slot_steps - prev_slot_steps
                if sched.prefill_tokens > billed_prefill:
                    yield Sleep(self.cloud.sample(
                        "prefill", size_kb=sched.prefill_tokens - billed_prefill))
                    billed_prefill = sched.prefill_tokens
                if active:
                    yield Sleep(self.cloud.sample("decode_step", size_kb=active))
                yield from self._bill_offload_ops()
                for fin in finished:
                    self._complete(fin.session, fin.request_id, fin.tokens)
                    yield Sleep(self.cloud.sample("kv_write", size_kb=0.5))
                    yield Sleep(self.cloud.sample("tcp_rtt"))
                if finished:
                    ctx.crash_point("post-complete")
                # continuous batching: refill freed slots from arrivals that
                # queued up while this invocation was decoding; keep claiming
                # past head-of-line requests whose session is still active
                while sched.wants_more():
                    extra = self.dispatch.claim_pending(sched.free_slots())
                    if not extra:
                        break
                    claimed.extend(extra)
                    feed(extra)
            yield from self._bill_offload_ops()
        except BaseException:
            # crash: the queue redelivers the original batch; hand back the
            # claimed messages and abort in-flight slots — completions
            # already recorded stay recorded (dedup makes redelivery safe)
            sched.reset()
            self.dispatch.requeue(
                [m for m in claimed if m.body["request_id"] not in self._done_ids])
            raise
        return None

    # -- event function: elastic-fleet flavour -----------------------------------------

    def _body_fleet(self, ctx, batch) -> Generator:
        """Continuous batching over the elastic fleet: the invocation ticks
        the controller until the queue is drained, then keeps ticking an
        idle cooldown so the autoscaler can drain-and-park down to its floor
        (scale-to-zero happens *inside* the serving path, between bursts).

        Billing: prefill/decode token work is billed once off the fleet's
        monotone aggregates (the same token work as the solo flavour),
        while each extra worker decoding in the same tick accrues its *own*
        GB-seconds (N workers each stream their own weights; wall time is
        one step, the bill is N) plus a per-spawn invocation and cold start
        via ``_bill_worker_events``."""
        fleet = self.fleet
        claimed: List[Any] = []

        def feed(msgs):
            for m in msgs:
                b = m.body
                if b["request_id"] in self._done_ids:
                    continue
                fleet.submit(b["session"], b["request_id"], b["prompt"],
                             b.get("max_tokens", 8))

        billed_prefill = fleet.prefill_tokens()
        try:
            feed(batch)
            while fleet.busy():
                prev_steps = fleet.slot_steps()
                finished = fleet.step()
                yield from self._bill_worker_events()
                pf = fleet.prefill_tokens()
                if pf > billed_prefill:
                    yield Sleep(self.cloud.sample("prefill", size_kb=pf - billed_prefill))
                    billed_prefill = pf
                active = fleet.slot_steps() - prev_steps
                if active:
                    dt = self.cloud.sample("decode_step", size_kb=active)
                    yield Sleep(dt)
                    extra = max(0, fleet.last_decoded_workers - 1)
                    if extra:
                        st = self.runtime._stats(WORKER_FN)
                        st.billed_seconds += dt * extra * (self.runtime.memory_mb / 1024.0)
                yield from self._bill_offload_ops()
                for fin in finished:
                    self._complete(fin.session, fin.request_id, fin.tokens)
                    yield Sleep(self.cloud.sample("kv_write", size_kb=0.5))
                    yield Sleep(self.cloud.sample("tcp_rtt"))
                if finished:
                    ctx.crash_point("post-complete")
                while fleet.wants_more():
                    extra_msgs = self.dispatch.claim_pending(fleet.free_slots())
                    if not extra_msgs:
                        break
                    claimed.extend(extra_msgs)
                    feed(extra_msgs)
            # idle cooldown: tick until the autoscaler has drained to its
            # floor (bounded — a wedged worker waits for heartbeat eviction,
            # which happens outside this invocation)
            floor = (fleet.min_workers if fleet.scale_to_zero
                     else max(fleet.min_workers, 1))
            budget = fleet.drain_idle_steps + 2 * fleet.max_workers + 4
            while budget and fleet.live_workers() > floor and not fleet.busy():
                fleet.step()
                budget -= 1
                yield from self._bill_worker_events()
                yield from self._bill_offload_ops()
            yield from self._bill_worker_events()
            yield from self._bill_offload_ops()   # tail ops of the last step
        except BaseException:
            # controller crash: the workers die with the invocation —
            # fail-stop each one (requeue + GC, durable metas survive) and
            # hand claimed messages back for redelivery
            fleet.abort()
            self.dispatch.requeue(
                [m for m in claimed if m.body["request_id"] not in self._done_ids])
            raise
        return None
