"""FIFO queues with event-function triggers (paper §4.2 requirements a–e).

The writer/distributor pipeline requires a queue that
  (a) invokes functions on messages,
  (b) upholds FIFO order,
  (c) limits function concurrency to a single instance,
  (d) batches items (SQS FIFO caps batches at 10),
  (e) assigns monotonically increasing sequence numbers (txids).

Delivery is at-least-once: if the consumer function crashes, the *same batch*
is redelivered in order (visibility timeout), up to ``max_retries`` — this is
the failure model FaaSKeeper's idempotent distributor relies on (§4.3).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Generator, List, Optional

from .simcloud import SimCloud, Sleep, Wait


@dataclass
class Message:
    seq: int
    body: Any
    size_kb: float = 0.064


class FifoQueue:
    """SQS-FIFO-semantics queue bound to one event function."""

    def __init__(
        self,
        cloud: SimCloud,
        name: str,
        handler: Optional[Callable[[List[Message]], Generator]] = None,
        batch_size: int = 10,
        max_retries: int = 5,
        trigger_kind: str = "fifo_trigger",
        retry_backoff: float = 0.05,
    ):
        self.cloud = cloud
        self.name = name
        self.handler = handler
        self.batch_size = batch_size
        self.max_retries = max_retries
        self.trigger_kind = trigger_kind
        self.retry_backoff = retry_backoff
        self._seq = itertools.count(1)
        self._pending: List[Message] = []
        self._consumer_active = False
        self._inflight = 0  # leading _pending entries delivered to the consumer
        self.pushes = 0
        self.push_kb = 0.0
        self.deliveries = 0
        self.redeliveries = 0
        self.claims = 0
        self.requeues = 0
        self.dropped = 0
        self.dead_letters: List[Message] = []

    # -- producer side ----------------------------------------------------------

    def push(self, body: Any, size_kb: float = 0.064) -> Generator:
        """Append a message; returns its monotone sequence number (txid)."""
        yield Sleep(self.cloud.sample("queue_push", size_kb))
        msg = Message(next(self._seq), body, size_kb)
        self._pending.append(msg)
        self.pushes += 1
        self.push_kb += max(size_kb, 0.064)
        self._maybe_trigger()
        return msg.seq

    def push_immediate(self, body: Any, size_kb: float = 0.064) -> int:
        """Zero-latency push (used by in-cloud services, e.g. heartbeat)."""
        msg = Message(next(self._seq), body, size_kb)
        self._pending.append(msg)
        self.pushes += 1
        self.push_kb += max(size_kb, 0.064)
        self._maybe_trigger()
        return msg.seq

    def claim_pending(self, max_n: int) -> List[Message]:
        """Hand up to ``max_n`` not-yet-delivered messages to the running
        consumer (long-poll receive inside an active invocation — the hook
        continuous batching uses to refill free decode slots).

        Claimed messages leave the queue, so a crash-redelivery of the
        current batch does not include them; the claimer must :meth:`requeue`
        any it did not finish.
        """
        if max_n <= 0:
            return []
        take = self._pending[self._inflight : self._inflight + max_n]
        del self._pending[self._inflight : self._inflight + max_n]
        self.claims += len(take)
        return take

    def requeue(self, msgs: List[Message]) -> None:
        """Return claimed-but-unfinished messages to the head of the queue
        (behind the in-flight batch), preserving FIFO order."""
        if not msgs:
            return
        self._pending[self._inflight : self._inflight] = list(msgs)
        self.requeues += len(msgs)

    # -- consumer side ------------------------------------------------------------

    def _maybe_trigger(self) -> None:
        if self.handler is None or self._consumer_active or not self._pending:
            return
        self._consumer_active = True
        delay = self.cloud.sample(self.trigger_kind)
        self.cloud.spawn(self._consume(), name=f"queue:{self.name}", delay=delay)

    def _consume(self) -> Generator:
        while self._pending:
            batch = self._pending[: self.batch_size]
            self._inflight = len(batch)
            attempts = 0
            while True:
                self.deliveries += 1
                task = self.cloud.spawn(
                    self.handler(list(batch)), name=f"{self.name}:handler"
                )
                yield Wait((task,))
                if task.error is None:
                    break
                attempts += 1
                if attempts > self.max_retries:
                    # poison batch: route to the dead-letter list after max
                    # retries so DLQ semantics are observable, not silent
                    self.dropped += len(batch)
                    self.dead_letters.extend(batch)
                    break
                self.redeliveries += 1
                yield Sleep(self.retry_backoff * attempts)
            del self._pending[: len(batch)]
            self._inflight = 0
            if self._pending:
                yield Sleep(self.cloud.sample(self.trigger_kind) * 0.25)
        self._consumer_active = False
        # messages may have raced in while we flipped the flag
        if self._pending:
            self._maybe_trigger()
        return None
