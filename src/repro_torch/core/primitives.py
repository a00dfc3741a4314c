"""Serverless synchronization primitives (paper §2.2, §4.4, Table 6a).

All three primitives are single conditional-update expressions against the
key-value system store — one round trip each, atomicity guaranteed by the
store's per-item atomic updates.

* **Timed lock** — a lease [Gray & Cheriton '89]: acquired if no timestamp is
  present or the holder's lease aged out; every later mutation of the locked
  item *fences* on the stored timestamp so an expired holder cannot commit
  ("to prevent accidental overwriting after losing the lock, each update to a
  locked resource compares the stored timestamp with the user value").
* **Atomic counter** — single-step add, returns the new value.
* **Atomic list** — safe append / truncation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Generator, List

from .simcloud import ConditionFailed
from .storage import KVStore

# Maximum lease duration in virtual seconds; the paper leaves the constant a
# deployment parameter — we default to 5 s (several writer p99 latencies).
MAX_LOCK_TIME = 5.0


@dataclass(frozen=True)
class Lock:
    """A held timed lock: ``timestamp`` is the fencing token."""

    key: str
    timestamp: float


class Primitives:
    def __init__(self, kv: KVStore, table: str = "state", max_lock_time: float = MAX_LOCK_TIME):
        self.kv = kv
        self.table = table
        self.max_lock_time = max_lock_time

    # -- timed lock -----------------------------------------------------------

    def lock_acquire(self, key: str, now: float) -> Generator:
        """Try to acquire; returns ``(lock | None, item_snapshot)``."""

        def cond(item: Dict[str, Any]) -> bool:
            ts = item.get("lock_ts")
            return ts is None or (now - ts) > self.max_lock_time

        def update(item: Dict[str, Any]) -> None:
            item["lock_ts"] = now

        try:
            # size_kb=None: the conditional update touches the whole stored
            # item, so latency grows with item size even though only 8 bytes
            # change — the Table 6a effect that motivates disaggregating
            # system from user data.
            item = yield from self.kv.update(
                self.table, key, update, cond, kind="kv_cond_update", size_kb=None
            )
            return Lock(key, now), item
        except ConditionFailed:
            snapshot = yield from self.kv.get(self.table, key)
            return None, snapshot

    def lock_release(self, key: str, lock: Lock) -> Generator:
        """Release without mutating the protected item (fenced)."""

        def cond(item: Dict[str, Any]) -> bool:
            return item.get("lock_ts") == lock.timestamp

        def update(item: Dict[str, Any]) -> None:
            item["lock_ts"] = None

        try:
            yield from self.kv.update(
                self.table, key, update, cond, kind="kv_cond_update", size_kb=None
            )
            return True
        except ConditionFailed:
            return False

    def fenced_update(self, key: str, lock: Lock, mutate, size_kb: float = 0.1) -> Generator:
        """Mutate the locked item and release the lock in one atomic update.

        This is the paper's commit-with-unlock (Alg. 1 step 4): applied
        conditionally on the fencing timestamp; "no changes are made if the
        lock expires".  Returns the new item, or ``None`` if fencing failed.
        """

        def cond(item: Dict[str, Any]) -> bool:
            return item.get("lock_ts") == lock.timestamp

        def update(item: Dict[str, Any]) -> None:
            mutate(item)
            item["lock_ts"] = None

        try:
            item = yield from self.kv.update(
                self.table, key, update, cond, kind="kv_cond_update", size_kb=size_kb
            )
            return item
        except ConditionFailed:
            return None

    # -- atomic counter ---------------------------------------------------------

    def counter_add(self, key: str, delta: int = 1, field: str = "value") -> Generator:
        def update(item: Dict[str, Any]) -> None:
            item[field] = item.get(field, 0) + delta

        item = yield from self.kv.update(
            self.table, key, update, kind="kv_counter", size_kb=0.008
        )
        return item[field]

    def counter_get(self, key: str, field: str = "value") -> Generator:
        item = yield from self.kv.get(self.table, key)
        return 0 if item is None else item.get(field, 0)

    # -- atomic list -------------------------------------------------------------

    def list_append(self, key: str, values: List[Any], field: str = "items") -> Generator:
        def update(item: Dict[str, Any]) -> None:
            item.setdefault(field, []).extend(values)

        kb = 0.008 + 1.0 * len(values) / 1024.0 * 1024.0 * 0.001
        item = yield from self.kv.update(
            self.table, key, update, kind="kv_list_append", size_kb=kb
        )
        return list(item[field])

    def list_remove(self, key: str, values: List[Any], field: str = "items") -> Generator:
        def update(item: Dict[str, Any]) -> None:
            existing = item.setdefault(field, [])
            for v in values:
                if v in existing:
                    existing.remove(v)

        item = yield from self.kv.update(
            self.table, key, update, kind="kv_list_append", size_kb=0.05
        )
        return list(item[field])

    def list_get(self, key: str, field: str = "items") -> Generator:
        item = yield from self.kv.get(self.table, key)
        return [] if item is None else list(item.get(field, []))
