"""The distributor event function — paper Algorithm 2.

A single FIFO-serialized distributor (concurrency 1 on the distributor queue)
replays committed transactions, in txid order, onto every regional user data
store, fans out watch notifications, and maintains the *epoch* counter that
keeps the disjoint read path consistent with the notification path:

  per update (client, lock, node, data, txid):
    1. GETNODE; if txid is not the node's next pending transaction,
       TryCommit on the writer's behalf (writer may have crashed between
       DISTRIBUTORPUSH and COMMITUNLOCK); reject -> NOTIFY(FAILURE),
    2. DATAUPDATE(region, data, txid, epoch) for every region, in parallel
       across regions, serialized within one,
    3. consume triggered watch instances; append (watch_id, txid) pairs to
       each region's epoch list *before* any later transaction's DATAUPDATE
       can be written (the distributor is serialized, so order holds),
    4. INVOKEWATCH — free functions deliver notifications in parallel,
    5. NOTIFY(client, SUCCESS),
    6. POPTRANSACTION — removes txid from the node's pending list; from here
       on the queue retry no longer redoes this update,
    WAITALL(watch callbacks) — each callback removes its epoch pair.

Every step is idempotent (epoch pairs, guarded pops, whole-object PUTs), so
at-least-once queue retries preserve exactly-once *effects*.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional, Tuple

from . import znode
from .primitives import Primitives
from .queues import Message
from .simcloud import Task, Wait
from .storage import KVStore, ObjectStore
from .watches import WatchRegistry, triggered_watches
from .writer import STATE, commit_unlock


def epoch_key(region: str) -> str:
    return f"epoch:{region}"


class DistributorCore:
    def __init__(
        self,
        kv: KVStore,
        prim: Primitives,
        watches: WatchRegistry,
        data_stores: Dict[str, ObjectStore],
        notify,  # (session, payload) -> Generator
        invoke_watch_fn,  # (region, watch_id, clients, event) -> Task
    ):
        self.kv = kv
        self.prim = prim
        self.watches = watches
        self.data_stores = data_stores
        self.notify = notify
        self.invoke_watch_fn = invoke_watch_fn

    # -- Algorithm 2 -----------------------------------------------------------

    def handle_batch(self, ctx, batch: List[Message]) -> Generator:
        # Function-instance state: epoch cache read once per invocation.
        epochs: Dict[str, List[List[int]]] = {}
        for region in self.data_stores:
            epochs[region] = yield from self.prim.list_get(epoch_key(region))
        watch_tasks: List[Task] = []

        for msg in batch:
            update = msg.body
            txid = msg.seq
            yield from self.handle_update(ctx, update, txid, epochs, watch_tasks)

        # WAITALL(WATCHCALLBACK)
        yield Wait(tuple(watch_tasks))
        return None

    def handle_update(
        self,
        ctx,
        update: Dict[str, Any],
        txid: int,
        epochs: Dict[str, List[List[int]]],
        watch_tasks: List[Task],
    ) -> Generator:
        session = update["session"]
        request_id = update["request_id"]
        op = update["op"]
        path = update["path"]
        parent = update["parent"]

        # (1) verify the writer committed this txid.
        t_start = ctx.cloud.now
        node = yield from self.kv.get(STATE, znode.node_key(path))
        ctx.cloud.record("dist_get_node", ctx.cloud.now - t_start)
        ctx.crash_point("after_getnode")
        pending = [] if node is None else node.get("transactions", [])
        if txid not in pending:
            already = node is not None and node.get("modified_txid", 0) >= txid
            if already:
                # Retried batch, pop already happened — effects are complete.
                return None
            # Writer crashed before COMMITUNLOCK: try to commit on its behalf.
            committed = yield from commit_unlock(self.kv, update, txid)
            ctx.crash_point("after_trycommit")
            if not committed:
                # The fence can fail because the *writer's own* commit landed
                # between our GETNODE and the TryCommit (writer pushes before
                # committing, so this race is routine).  Re-read: if the txid
                # is in fact committed, continue distributing; only a provably
                # uncommitted update is rejected.  (The writer's commit is
                # fenced on the same lease timestamp, so once the fence moved
                # on, no late writer commit can slip in after this re-read.)
                node2 = yield from self.kv.get(STATE, znode.node_key(path))
                pending2 = [] if node2 is None else node2.get("transactions", [])
                done2 = node2 is not None and node2.get("modified_txid", 0) >= txid
                if txid not in pending2 and not done2:
                    yield from self.notify(
                        session,
                        {"kind": "result", "request_id": request_id, "ok": False,
                         "code": "commit_failed", "txid": txid},
                    )
                    return None

        # (2) DATAUPDATE — replicate the *pushed* update (never a fresh read
        # of the system store, which may already contain later pending
        # transactions) to each region's user store.
        node_post, parent_post = znode.materialize(
            op, update["args"], update.get("node_pre"), update.get("parent_pre"), txid
        )
        t_upd = ctx.cloud.now
        for region, store in self.data_stores.items():
            yield from self._data_update(store, node_post, parent_post, op, path, txid, epochs[region])
        ctx.cloud.record("dist_update_node", ctx.cloud.now - t_upd)
        ctx.crash_point("after_dataupdate")

        # (3) consume triggered watches; extend epoch lists.
        t_watch = ctx.cloud.now
        notifications: List[Tuple[str, int, List[str], Dict[str, Any]]] = []
        for wtype, wpath, event in triggered_watches(op, path, parent or znode.parent_path(path)):
            wid, clients = yield from self.watches.fetch_and_consume(wtype, wpath)
            if wid is not None and clients:
                notifications.append(
                    (wtype, wid, clients,
                     {"kind": "watch", "watch_id": wid, "path": wpath,
                      "event": event, "txid": txid})
                )
        for region in self.data_stores:
            pairs = [[wid, txid] for _, wid, _, _ in notifications]
            new_pairs = [p for p in pairs if p not in epochs[region]]
            if new_pairs:
                epochs[region] = yield from self.prim.list_append(epoch_key(region), new_pairs)
        ctx.cloud.record("dist_watch_query", ctx.cloud.now - t_watch)
        ctx.crash_point("after_epoch_add")

        # (4) INVOKEWATCH — parallel free functions; the callback removes the
        # epoch pair once every client got the notification (WATCHCALLBACK).
        for region in self.data_stores:
            for _, wid, clients, payload in notifications:
                task = self.invoke_watch_fn(region, wid, clients, payload, txid)
                watch_tasks.append(task)
        ctx.crash_point("after_invoke")

        # (5) NOTIFY(client, SUCCESS)
        yield from self.notify(
            session,
            {"kind": "result", "request_id": request_id, "ok": True,
             "txid": txid, "path": path,
             "version": node_post.get("version", 0)},
        )
        ctx.crash_point("after_notify")

        # (6) POPTRANSACTION — idempotent removal.
        def pop(item: Dict[str, Any]) -> None:
            txs = item.setdefault("transactions", [])
            if txid in txs:
                txs.remove(txid)

        yield from self.kv.update(STATE, znode.node_key(path), pop, size_kb=0.05)
        ctx.cloud.record("dist_total", ctx.cloud.now - t_start)
        ctx.crash_point("after_pop")
        return None

    # -- user-store replication ---------------------------------------------------

    def _data_update(
        self,
        store: ObjectStore,
        node_post: Dict[str, Any],
        parent_post: Optional[Dict[str, Any]],
        op: str,
        path: str,
        txid: int,
        epoch: List[List[int]],
    ) -> Generator:
        """Whole-object PUTs (S3 semantics — no partial updates, §4.3).

        For create/delete the parent object is rewritten too; S3's lack of
        partial updates forces the full-object rewrite the paper calls out
        ("the distributor function needs to download user node data to
        conduct the update operation" — here the pre-state travelled in the
        queue message, trading queue bytes for the S3 GET).
        """
        if op == "delete":
            yield from store.delete(path)
        else:
            yield from store.put(path, _user_object(node_post, epoch))
        if parent_post is not None and parent_post.get("exists"):
            # S3 cannot update children in place: download the parent object,
            # merge the child-list change, re-upload whole ("even if a change
            # involves only the node's children, the distributor function
            # needs to download user node data", §4.3).  The system store
            # holds metadata only, so the payload must come from this GET.
            existing = yield from store.get(parent_post["path"])
            merged = _user_object(parent_post, epoch)
            if existing is not None:
                merged["data"] = existing.get("data", b"")
            yield from store.put(parent_post["path"], merged)
        return None


def _user_object(node: Dict[str, Any], epoch: List[List[int]]) -> Dict[str, Any]:
    return {
        "path": node["path"],
        "data": node.get("data", b""),
        "version": node.get("version", 0),
        "cversion": node.get("cversion", 0),
        "created_txid": node.get("created_txid", 0),
        "modified_txid": node.get("modified_txid", 0),
        "children": list(node.get("children", [])),
        "ephemeral_owner": node.get("ephemeral_owner"),
        "epoch": [list(p) for p in epoch],
    }
