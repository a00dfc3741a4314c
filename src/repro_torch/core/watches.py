"""Watch registry (paper §4.3 *Notifications*).

Watches live in the system store: one item per ``(type, path)``; "each watch
is assigned a unique identifier, and multiple clients can be assigned to a
single watch instance".  Registration is an atomic list-append; triggering
consumes the instance (ZooKeeper watches are one-shot) — a later registration
creates a fresh instance with a fresh id.

Epoch entries are ``[watch_id, txid]`` pairs, which makes the distributor's
append/remove idempotent under at-least-once retries.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Tuple

from .primitives import Primitives
from .storage import KVStore

WATCH_TABLE = "watch"
DATA = "data"
CHILDREN = "children"


def watch_key(wtype: str, path: str) -> str:
    return f"{wtype}:{path}"


class WatchRegistry:
    def __init__(self, kv: KVStore, prim: Primitives):
        self.kv = kv
        self.prim = prim

    def register(self, wtype: str, path: str, session: str) -> Generator:
        """Register ``session`` on the watch instance; returns its watch_id."""
        wid = yield from self.prim.counter_add("watch_counter")

        state = {}

        def update(item: Dict[str, Any]) -> None:
            if not item.get("watch_id"):
                item["watch_id"] = wid
            if session not in item.setdefault("clients", []):
                item["clients"].append(session)
            state["watch_id"] = item["watch_id"]

        yield from self.kv.update(
            WATCH_TABLE, watch_key(wtype, path), update, kind="kv_list_append", size_kb=0.05
        )
        return state["watch_id"]

    def fetch_and_consume(self, wtype: str, path: str) -> Generator:
        """Read + atomically consume the watch instance for a trigger.

        Returns ``(watch_id, clients)`` or ``(None, [])``.
        """
        result = {}

        def update(item: Dict[str, Any]) -> None:
            result["watch_id"] = item.get("watch_id")
            result["clients"] = list(item.get("clients", []))
            item["watch_id"] = None
            item["clients"] = []

        yield from self.kv.update(
            WATCH_TABLE, watch_key(wtype, path), update, kind="kv_cond_update", size_kb=0.05
        )
        return result.get("watch_id"), result.get("clients", [])


def triggered_watches(op: str, path: str, parent: str) -> List[Tuple[str, str, str]]:
    """Which watch instances does a committed op trigger?

    Returns ``(wtype, watch_path, event)`` triples, matching ZooKeeper:
      * set_data  -> data watch on the node (``changed``)
      * create    -> data/exists watch on the node (``created``) +
                     children watch on the parent
      * delete    -> data watch on the node (``deleted``) +
                     children watch on the parent
    """
    if op == "set_data":
        return [(DATA, path, "changed")]
    if op == "create":
        return [(DATA, path, "created"), (CHILDREN, parent, "child")]
    if op == "delete":
        return [(DATA, path, "deleted"), (CHILDREN, parent, "child")]
    return []
