"""Serving frontend: per-session FIFO queues feeding one shared batcher.

Inference requests take the paper's write-request path — per-client session
FIFO queues with batched event-function invocation — but the decode slot is
*cross-session*: every session queue routes into one shared dispatch queue,
so a model batch mixes arrivals from different sessions and the
per-invocation cost is amortized across clients (FaaSKeeper §4.2/§6).

Two batcher flavours behind the same queue plumbing:

* **whole-batch** (``model_fn``): one event-function invocation generates the
  full response for every request in its dispatch batch.
* **continuous** (``scheduler``): a
  :class:`repro_torch.serve.DecodeScheduler` holds a fixed-width decode
  batch; the invocation admits its dispatch batch into free slots and,
  between decode steps, long-polls the dispatch queue
  (``FifoQueue.claim_pending``) to refill slots that free up.

Per-session FIFO survives both: the dispatch queue is FIFO over arrival
order, whole-batch completes a batch atomically, and the scheduler admits a
session's next request only after its predecessor completes.  Delivery is
at-least-once: completions are deduped by request id, so a crashed handler
redelivers its batch without duplicating completions, and
claimed-but-unfinished messages are requeued.  ``mode='per-session'`` keeps
the one-queue-per-session batcher as the cost baseline.  The elastic fleet
flavour is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Generator, List, Optional

from ..core import FifoQueue, FunctionRuntime, SimCloud, Sleep


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
    continuous flavour.  Compute is billed under the calibrated ``prefill``
    / ``decode_step`` latency models, so GB-second billing is deterministic
    and identical across flavours for the same token work.
    """

    def __init__(self, cloud: SimCloud,
                 model_fn: Optional[Callable[[List[Any]], List[Any]]] = None,
                 *, scheduler=None, fleet=None, batch_size: int = 4,
                 function_memory_mb: int = 2048, mode: str = "shared"):
        if fleet is not None:
            raise NotImplementedError("the fleet flavour is not ported yet")
        if model_fn is None and scheduler is None:
            raise ValueError("need model_fn (whole-batch) or scheduler (continuous)")
        if mode not in ("shared", "per-session"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "per-session" and scheduler is not None:
            raise ValueError("the per-session baseline has no shared scheduler")
        self.cloud = cloud
        self.model_fn = model_fn
        self.scheduler = scheduler
        self.mode = mode
        self.runtime = FunctionRuntime(cloud, memory_mb=function_memory_mb)
        body = self._body_continuous if scheduler is not None else self._body_batch
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
        occupancy/token counters and KV pool gauges in continuous mode."""
        st = self.runtime.stats.get("serve")
        out: Dict[str, Any] = {
            "mode": "continuous" if self.scheduler is not None else self.mode,
            "invocations": st.invocations if st else 0,
            "cost_usd": self.runtime.cost_usd(),
            "dropped": self.dropped_requests(),
        }
        if self.scheduler is not None:
            out.update(self.scheduler.stats())
            out.update(self.scheduler.kv_memory_stats())
        return out

    def _bill_offload_ops(self) -> Generator:
        """Billing hook for the scheduler's page-blob traffic: KV offload is
        not ported yet, so there is nothing to bill."""
        return
        yield

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
