"""The writer event function — paper Algorithm 1.

FaaSKeeper replaces ZooKeeper's single elected leader with *concurrent* writer
functions, one per session queue (concurrency limit 1 per queue keeps session
FIFO order; different sessions proceed in parallel).  Per request:

  1. LOCK       — timed-lock the target node (and the parent for create/
                  delete: multi-node transaction, §4.2),
  2. ISVALID    — validate against the locked snapshot; on failure NOTIFY
                  the client and continue,
  3. DISTRIBUTORPUSH — push the outcome to the distributor queue; the queue's
                  monotone sequence number *is* the transaction id (txid),
  4. COMMITUNLOCK — apply the mutation to system storage and release the
                  lock in one conditional update (fenced on the lease
                  timestamp: "no changes are made if the lock expires").

Crash points between every step model Lambda failures; the distributor's
TryCommit (Alg. 2 step 2) completes or rejects half-done requests.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional

from . import znode
from .primitives import Lock, Primitives
from .queues import FifoQueue, Message
from .simcloud import Sleep
from .storage import KVStore

STATE = "state"
LOCK_RETRIES = 40
LOCK_BACKOFF = 0.02


class WriterCore:
    """Shared by the per-session event writer functions."""

    def __init__(self, kv: KVStore, prim: Primitives, distributor_queue: FifoQueue, notify):
        self.kv = kv
        self.prim = prim
        self.distq = distributor_queue
        self.notify = notify  # (session, payload) -> Generator

    # -- helpers ---------------------------------------------------------------

    def _acquire(self, path: str, cloud) -> Generator:
        """Timed-lock with bounded retry (lease expiry bounds the wait).

        ``cloud.now`` is re-read per attempt: a crashed holder's lease ages
        out against *current* time, so a redelivered batch can reclaim the
        lock once MAX_LOCK_TIME passes."""
        for attempt in range(LOCK_RETRIES):
            lock, item = yield from self.prim.lock_acquire(
                znode.node_key(path), cloud.now)
            if lock is not None:
                return lock, item
            yield Sleep(LOCK_BACKOFF * (1 + attempt))
        raise RuntimeError(f"lock starvation on {path}")

    # -- Algorithm 1 --------------------------------------------------------------

    def handle_batch(self, ctx, batch: List[Message]) -> Generator:
        for msg in batch:
            req = msg.body
            yield from self.handle_request(ctx, req)
        return None

    def handle_request(self, ctx, req: Dict[str, Any]) -> Generator:
        op: str = req["op"]
        args: Dict[str, Any] = dict(req["args"])
        session: str = req["session"]
        request_id = req["request_id"]

        if op == "deregister_session":
            yield from self._deregister(ctx, req)
            return None

        path: str = args["path"]
        parent = znode.parent_path(path)
        needs_parent = op in ("create", "delete") and path != "/"

        # (1) LOCK — parent first (stable order prevents deadlock), then node.
        t_start = ctx.cloud.now
        locks: Dict[str, Lock] = {}
        parent_item: Optional[Dict[str, Any]] = None
        if needs_parent:
            plock, parent_item = yield from self._acquire(parent, ctx.cloud)
            locks[parent] = plock
        ctx.crash_point("after_parent_lock")

        if op == "create" and args.get("sequence"):
            # resolve sequential suffix under the parent lock (cseq is stable)
            cseq = (parent_item or {}).get("cseq", 0)
            path = znode.sequential_name(path, cseq)
            args["path"] = path

        nlock, node_item = yield from self._acquire(path, ctx.cloud)
        locks[path] = nlock
        ctx.cloud.record("writer_lock", ctx.cloud.now - t_start)
        ctx.crash_point("after_lock")

        # Exactly-once guard: the commit transaction records request_id ->
        # txid (atomically).  On an at-least-once redelivery after a crash,
        # an already-committed request is skipped here — without this, a
        # writer crash between DISTRIBUTORPUSH and batch completion would
        # re-apply the op under a fresh txid.
        dedup = yield from self.kv.get("dedup", session)
        if dedup is not None and request_id in dedup.get("done", {}):
            yield from self._release_all(locks)
            return None

        # (2) ISVALID — against the locked snapshot.
        err = znode.validate_op(op, args, node_item, parent_item)
        if err is not None:
            yield from self._release_all(locks)
            yield from self.notify(
                session,
                {"kind": "result", "request_id": request_id, "ok": False, "code": err},
            )
            return None
        ctx.crash_point("after_validate")

        # (3) DISTRIBUTORPUSH — sequence number is the global txid.  The
        # update carries the *pre-state* snapshots taken under the locks;
        # materialization is deterministic, so writer-commit, TryCommit and
        # every regional DATAUPDATE apply identical transitions.
        update = {
            "session": session,
            "request_id": request_id,
            "op": op,
            "args": args,
            "path": path,
            "parent": parent if needs_parent else None,
            "node_pre": node_item,
            "parent_pre": parent_item,
            "locks": {p: l.timestamp for p, l in locks.items()},
        }
        t_push = ctx.cloud.now
        txid = yield from self.distq.push(update, size_kb=0.25 + _data_kb(args))
        ctx.cloud.record("writer_push", ctx.cloud.now - t_push)
        ctx.crash_point("after_push")

        # (4) COMMITUNLOCK — fenced multi-item transaction (includes the
        # dedup marker and ephemeral-ownership bookkeeping atomically).
        t_commit = ctx.cloud.now
        committed = yield from commit_unlock(self.kv, update, txid)
        ctx.cloud.record("writer_commit", ctx.cloud.now - t_commit)
        ctx.cloud.record("writer_total", ctx.cloud.now - t_start)
        ctx.crash_point("after_commit")
        if not committed:
            # Either the distributor's TryCommit beat us (routine race — it
            # will notify SUCCESS), or the lease truly expired and nobody
            # committed.  Distinguish via the dedup marker, which commits
            # atomically with the transaction.
            dedup2 = yield from self.kv.get("dedup", session)
            if dedup2 is None or request_id not in dedup2.get("done", {}):
                yield from self.notify(
                    session,
                    {"kind": "result", "request_id": request_id, "ok": False,
                     "code": "lost_lease", "txid": txid},
                )
        return None

    def _release_all(self, locks: Dict[str, Lock]) -> Generator:
        for path, lock in locks.items():
            yield from self.prim.lock_release(znode.node_key(path), lock)
        return None

    # -- session eviction (heartbeat path) ---------------------------------------

    def _deregister(self, ctx, req: Dict[str, Any]) -> Generator:
        """Evict a session: delete its ephemerals (full write path), mark dead."""
        target = req["args"]["target_session"]
        sess = yield from self.kv.get("sessions", target)
        if sess is None or not sess.get("alive", False):
            return None
        ephemerals = sorted(sess.get("ephemerals", []))
        for path in ephemerals:
            sub = {
                "op": "delete",
                "args": {"path": path, "version": -1},
                "session": req["session"],
                "request_id": f"{req['request_id']}:evict:{path}",
            }
            yield from self.handle_request(ctx, sub)
        ctx.crash_point("after_evict_deletes")

        def update(item: Dict[str, Any]) -> None:
            item["alive"] = False
            item["ephemerals"] = []

        yield from self.kv.update("sessions", target, update)
        return None


def _data_kb(args: Dict[str, Any]) -> float:
    data = args.get("data", b"")
    return (len(data) if isinstance(data, (bytes, str)) else 0) / 1024.0


def _system_view(node_post: Dict[str, Any]) -> Dict[str, Any]:
    """System-store node items hold METADATA ONLY (paper Table 3: writer lock
    and commit stay ~8 ms even for 250 kB writes — the payload travels
    client -> queue -> distributor -> user store, never through DynamoDB).
    The conditional-update latency growth with item size (Table 6a) is
    exactly why the paper disaggregates this."""
    view = dict(node_post)
    data = view.pop("data", b"")
    view["data_len"] = len(data) if isinstance(data, (bytes, str)) else 0
    return view


# --------------------------------------------------------------------------
# Commit application — shared verbatim by writer (step 4) and the
# distributor's TryCommit so both produce identical state transitions.
# --------------------------------------------------------------------------


def commit_unlock(kv: KVStore, update: Dict[str, Any], txid: int) -> Generator:
    """Apply ``update`` to system storage + release locks, all-or-nothing.

    Conditional on every lease timestamp still being ours (fencing).  Appends
    ``txid`` to the node's pending ``transactions`` — that is the commit
    marker the distributor checks.  Returns True iff committed.
    """
    op = update["op"]
    args = update["args"]
    path = update["path"]
    parent = update["parent"]
    locks: Dict[str, float] = update["locks"]
    node_post, parent_post = znode.materialize(
        op, args, update.get("node_pre"), update.get("parent_pre"), txid
    )

    def node_cond(item: Dict[str, Any]) -> bool:
        return item.get("lock_ts") == locks[path]

    def node_update(item: Dict[str, Any]) -> None:
        txs = item.get("transactions", [])
        item.clear()
        item.update(_system_view(node_post))
        item["transactions"] = txs + [txid]
        item["lock_ts"] = None

    items = [(STATE, znode.node_key(path), node_update, node_cond)]

    if parent is not None:

        def parent_cond(item: Dict[str, Any]) -> bool:
            return item.get("lock_ts") == locks[parent]

        def parent_update(item: Dict[str, Any]) -> None:
            txs = item.get("transactions", [])
            item.clear()
            item.update(_system_view(parent_post))
            item["transactions"] = txs
            item["lock_ts"] = None

        items.append((STATE, znode.node_key(parent), parent_update, parent_cond))

    # exactly-once marker (see WriterCore.handle_request)
    session = update["session"]
    request_id = update["request_id"]

    def dedup_update(item: Dict[str, Any]) -> None:
        done = item.setdefault("done", {})
        order = item.setdefault("order", [])
        done[request_id] = txid
        order.append(request_id)
        while len(order) > 128:
            done.pop(order.pop(0), None)

    items.append(("dedup", session, dedup_update, None))

    # ephemeral-ownership bookkeeping, atomic with the commit
    if op == "create" and args.get("ephemeral"):

        def eph_add(item: Dict[str, Any]) -> None:
            eph = item.setdefault("ephemerals", [])
            if path not in eph:
                eph.append(path)

        items.append(("sessions", session, eph_add, None))
    elif op == "delete":
        owner = (update.get("node_pre") or {}).get("ephemeral_owner")
        if owner:

            def eph_rm(item: Dict[str, Any]) -> None:
                eph = item.setdefault("ephemerals", [])
                if path in eph:
                    eph.remove(path)

            items.append(("sessions", owner, eph_rm, None))

    from .simcloud import ConditionFailed

    try:
        yield from kv.transact(items)
        return True
    except ConditionFailed:
        return False
