"""FaaSKeeper client — kazoo-modelled API (paper §4.1, §4.6).

Write operations travel through the session's FIFO queue to the writer
function; results arrive on the push channel after the distributor replicated
the change (so SUCCESS implies read-your-write on the regional store).
Read operations go *directly* to the regional user data store — eliminating
the ZooKeeper server from the read path is the paper's core cost win — and
enforce consistency client-side via the MRD / epoch stall rule (Appendix B).

All methods are SimCloud coroutines; ``SyncClient`` wraps them for
synchronous use (examples, coord/ layer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Generator, List, Optional

from .sessions import Inbox, SessionState
from .znode import (
    BadVersionError,
    FKError,
    NodeExistsError,
    NoNodeError,
    NotEmptyError,
    validate_path,
)

_ERRORS = {
    "no_node": NoNodeError,
    "node_exists": NodeExistsError,
    "bad_version": BadVersionError,
    "not_empty": NotEmptyError,
}


@dataclass
class Stat:
    version: int
    cversion: int
    created_txid: int
    modified_txid: int
    ephemeral_owner: Optional[str]
    num_children: int


class FaaSKeeperClient:
    def __init__(self, service, session_id: str, region: str = "region-0"):
        self.service = service
        self.cloud = service.cloud
        self.session_id = session_id
        self.region = region
        self.state = SessionState(session_id)
        self.inbox = Inbox(self.cloud, session_id)
        self.inbox.on_event = self._on_event
        self.failed = False  # heartbeat responsiveness (tests flip this)
        self.read_latencies: List[float] = []
        self.write_latencies: List[float] = []

    # -- push-channel bookkeeping ------------------------------------------------

    def _on_event(self, payload: Dict[str, Any]) -> None:
        kind = payload.get("kind")
        if kind == "watch":
            self.state.note_watch_delivery(payload["watch_id"], payload["txid"])
        elif kind == "result" and payload.get("ok"):
            self.state.observe(payload.get("txid", 0))

    # -- session lifecycle ----------------------------------------------------------

    def connect(self) -> Generator:
        yield from self.service.kv.put(
            "sessions",
            self.session_id,
            {"alive": True, "ephemerals": [], "connected_at": self.cloud.now},
        )
        # a (re)connect is a new session incarnation: its request-id space
        # restarts, so the previous incarnation's exactly-once markers must
        # not swallow this one's requests (matters after restoring durable
        # storage in a new process — launch/train.py --resume).
        yield from self.service.kv.delete("dedup", self.session_id)
        self.service.register_client(self)
        return self

    def close(self) -> Generator:
        yield from self.service.enqueue_deregistration(self.session_id)
        return None

    # -- write path -------------------------------------------------------------------

    def _submit(self, op: str, args: Dict[str, Any], size_kb: float) -> Generator:
        request_id = self.state.next_request_id()
        req = {"op": op, "args": args, "session": self.session_id, "request_id": request_id}
        queue = self.service.session_queue(self.session_id)
        yield from queue.push(req, size_kb=size_kb)
        return request_id

    def _await_result(self, request_id: str) -> Generator:
        # 'commit_failed' is NOT final: it means the distributor found a
        # half-done request whose lease had moved on — the session queue's
        # at-least-once redelivery will produce the authoritative outcome.
        result = yield from self.inbox.wait_for(
            lambda ev: ev.get("kind") == "result"
            and ev.get("request_id") == request_id
            and ev.get("code") != "commit_failed"
        )
        if not result.get("ok"):
            exc = _ERRORS.get(result.get("code"), FKError)
            raise exc(f"{result.get('code')} (request {request_id})")
        self.state.observe(result.get("txid", 0))
        return result

    def create(
        self,
        path: str,
        data: bytes = b"",
        ephemeral: bool = False,
        sequence: bool = False,
    ) -> Generator:
        """Returns the created path (sequential suffix resolved)."""
        validate_path(path)
        t0 = self.cloud.now
        rid = yield from self._submit(
            "create",
            {"path": path, "data": data, "ephemeral": ephemeral,
             "sequence": sequence, "session": self.session_id},
            size_kb=len(data) / 1024.0 + 0.1,
        )
        result = yield from self._await_result(rid)
        self.write_latencies.append(self.cloud.now - t0)
        return result["path"]

    def set_data(self, path: str, data: bytes, version: int = -1) -> Generator:
        validate_path(path)
        t0 = self.cloud.now
        rid = yield from self._submit(
            "set_data", {"path": path, "data": data, "version": version},
            size_kb=len(data) / 1024.0 + 0.1,
        )
        result = yield from self._await_result(rid)
        self.write_latencies.append(self.cloud.now - t0)
        return result["version"]

    def delete(self, path: str, version: int = -1) -> Generator:
        validate_path(path)
        t0 = self.cloud.now
        rid = yield from self._submit(
            "delete", {"path": path, "version": version}, size_kb=0.1
        )
        result = yield from self._await_result(rid)
        self.write_latencies.append(self.cloud.now - t0)
        return result["txid"]

    # pipelined (async) variants — the paper pipelines requests over the
    # session channel; FIFO order is preserved by the queue.
    def submit_set_data(self, path: str, data: bytes, version: int = -1) -> Generator:
        rid = yield from self._submit(
            "set_data", {"path": path, "data": data, "version": version},
            size_kb=len(data) / 1024.0 + 0.1,
        )
        return rid

    def wait_result(self, request_id: str) -> Generator:
        result = yield from self._await_result(request_id)
        return result

    # -- read path --------------------------------------------------------------------

    def _store(self):
        return self.service.data_stores[self.region]

    def _register_watch(self, wtype: str, path: str) -> Generator:
        wid = yield from self.service.watches.register(wtype, path, self.session_id)
        self.state.active_watches[wid] = (wtype, path)
        return wid

    def _stall_on_epoch(self, obj: Dict[str, Any]) -> Generator:
        """Appendix B Ⓝ: reads newer than MRD must wait for any of *my*
        pending watch notifications recorded in the object's epoch set."""
        v = obj.get("modified_txid", 0)
        if v <= self.state.mrd:
            return None
        for wid, txid in self.state.pending_epoch_pairs(obj.get("epoch", [])):
            yield from self.inbox.wait_for(
                lambda ev, w=wid, t=txid: ev.get("kind") == "watch"
                and ev.get("watch_id") == w and ev.get("txid") == t
            )
        return None

    def get_data(self, path: str, watch: bool = False) -> Generator:
        validate_path(path)
        t0 = self.cloud.now
        if watch:
            yield from self._register_watch("data", path)
        obj = yield from self._store().get(path)
        if obj is None:
            raise NoNodeError(path)
        yield from self._stall_on_epoch(obj)
        self.state.observe(obj.get("modified_txid", 0))
        self.read_latencies.append(self.cloud.now - t0)
        return obj["data"], _stat(obj)

    def get_children(self, path: str, watch: bool = False) -> Generator:
        validate_path(path)
        if watch:
            yield from self._register_watch("children", path)
        obj = yield from self._store().get(path)
        if obj is None:
            raise NoNodeError(path)
        yield from self._stall_on_epoch(obj)
        self.state.observe(obj.get("modified_txid", 0))
        return sorted(obj.get("children", [])), _stat(obj)

    def exists(self, path: str, watch: bool = False) -> Generator:
        validate_path(path)
        if watch:
            yield from self._register_watch("data", path)
        obj = yield from self._store().get(path)
        if obj is None:
            return None
        yield from self._stall_on_epoch(obj)
        self.state.observe(obj.get("modified_txid", 0))
        return _stat(obj)

    # -- notifications ------------------------------------------------------------------

    def wait_watch(self, path: str, timeout: float = 120.0) -> Generator:
        ev = yield from self.inbox.wait_for(
            lambda ev: ev.get("kind") == "watch" and ev.get("path") == path,
            timeout=timeout,
        )
        return ev


def _stat(obj: Dict[str, Any]) -> Stat:
    return Stat(
        version=obj.get("version", 0),
        cversion=obj.get("cversion", 0),
        created_txid=obj.get("created_txid", 0),
        modified_txid=obj.get("modified_txid", 0),
        ephemeral_owner=obj.get("ephemeral_owner"),
        num_children=len(obj.get("children", [])),
    )


class SyncClient:
    """Blocking facade: runs the event loop until each op completes."""

    def __init__(self, client: FaaSKeeperClient):
        self.client = client
        self.cloud = client.cloud

    def __getattr__(self, name: str):
        target = getattr(self.client, name)
        if not callable(target):
            return target

        def call(*args: Any, **kwargs: Any):
            return self.cloud.run_task(target(*args, **kwargs), name=f"sync:{name}")

        return call
