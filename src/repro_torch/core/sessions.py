"""Client-side session machinery (paper §4.1).

The paper's client runs three background threads (send requests, manage
responses, order results).  Here the same roles are: the session's FIFO queue
(send), the :class:`Inbox` push channel (responses/notifications), and the
MRD + epoch stall rule in ``client.py`` (ordering).

The client stores the **MRD** — "the timestamp for the most recent data seen
for all reads, writes, and notifications" — and a set of delivered
``(watch_id, txid)`` pairs used by the Ordered Notifications stall rule
(Appendix B Ⓝ).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generator, List, Optional, Set, Tuple

from .simcloud import Future, SimCloud, Wait


class Inbox:
    """Push channel from the service to one client (replaces TCP push)."""

    def __init__(self, cloud: SimCloud, session_id: str):
        self.cloud = cloud
        self.session_id = session_id
        self.events: List[Dict[str, Any]] = []
        self._futures: List[Tuple[Callable[[Dict[str, Any]], bool], Future]] = []
        self.on_event: Optional[Callable[[Dict[str, Any]], None]] = None

    def deliver(self, payload: Dict[str, Any]) -> None:
        self.events.append(payload)
        if self.on_event is not None:
            self.on_event(payload)
        still = []
        for pred, fut in self._futures:
            if not fut.done and pred(payload):
                fut.resolve(payload)
            elif not fut.done:
                still.append((pred, fut))
        self._futures = still

    def wait_for(self, pred: Callable[[Dict[str, Any]], bool], timeout: float = 120.0) -> Generator:
        """Wait (virtual time) until an event matching ``pred`` arrives."""
        for ev in self.events:
            if pred(ev):
                return ev
        fut = Future(f"inbox:{self.session_id}")
        self._futures.append((pred, fut))
        token = self.cloud.schedule_cancellable(
            timeout, lambda: fut.resolve({"kind": "timeout"}))
        yield Wait((fut,))
        token["cancelled"] = True
        if fut.result is not None and fut.result.get("kind") == "timeout":
            raise TimeoutError(f"session {self.session_id}: inbox wait timed out")
        return fut.result


class SessionState:
    """Consistency bookkeeping for one session."""

    def __init__(self, session_id: str):
        self.session_id = session_id
        self.mrd: int = 0  # most-recent-data txid
        self.active_watches: Dict[int, Tuple[str, str]] = {}  # wid -> (type, path)
        self.delivered_pairs: Set[Tuple[int, int]] = set()  # (wid, txid)
        self.request_counter = 0
        self.observed_txids: List[int] = []  # for single-system-image checks

    def next_request_id(self) -> str:
        self.request_counter += 1
        return f"{self.session_id}:{self.request_counter}"

    def observe(self, txid: int) -> None:
        if txid > 0:
            self.mrd = max(self.mrd, txid)
            self.observed_txids.append(txid)

    def note_watch_delivery(self, wid: int, txid: int) -> None:
        self.delivered_pairs.add((wid, txid))
        self.active_watches.pop(wid, None)  # one-shot
        self.observe(txid)

    def pending_epoch_pairs(self, epoch: List[List[int]]) -> List[Tuple[int, int]]:
        """Epoch pairs that block a read: my active watch, not yet delivered."""
        out = []
        for wid, txid in epoch:
            if wid in self.active_watches and (wid, txid) not in self.delivered_pairs:
                out.append((wid, txid))
        return out
