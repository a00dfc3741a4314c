"""Cloud storage services with DynamoDB / S3 semantics.

The paper's *map* step (§3.2) assigns frequently-modified control data to a
key-value store with conditional update expressions (DynamoDB) and large
read-mostly user data to an object store (S3).  Both are strongly consistent
(§4.4 — eventual consistency would break Linearized Writes and Single System
Image).

All mutating operations apply atomically at a single virtual-time instant;
between two operations of one function any concurrent function may run, which
is the faithful concurrency model of Lambdas against DynamoDB.

:class:`PageBlobStore` is the bucket the decode scheduler offloads KV page
blobs to.  A blob is a dict of CPU tensors: the scheduler copies a victim's
pages off the card before it puts them here, so an offload frees device
memory, not just pool accounting.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Generator, Optional

from .simcloud import ConditionFailed, SimCloud, Sleep


def _size_kb(value: Any) -> float:
    """Rough serialized size in kB (drives latency + cost models)."""
    if value is None:
        return 0.0
    if isinstance(value, (bytes, bytearray, str)):
        return len(value) / 1024.0
    if isinstance(value, (int, float, bool)):
        return 8 / 1024.0
    if isinstance(value, (list, tuple, set)):
        return sum(_size_kb(v) for v in value) + len(value) / 1024.0
    if isinstance(value, dict):
        return sum(_size_kb(k) + _size_kb(v) for k, v in value.items())
    return 0.064


class KVStore:
    """DynamoDB-semantics table store.

    * per-item atomic updates,
    * conditional *update expressions* (the substrate for the paper's
      synchronization primitives, §2.2 / §4.4),
    * strongly consistent reads,
    * pay-per-operation metering in 1 kB write / 4 kB read units (Table 4).
    """

    def __init__(self, cloud: SimCloud, name: str = "system"):
        self.cloud = cloud
        self.name = name
        self.tables: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.write_units = 0
        self.read_units = 0

    # -- immediate (atomic) appliers -----------------------------------------

    def _table(self, table: str) -> Dict[str, Dict[str, Any]]:
        return self.tables.setdefault(table, {})

    def _apply_get(self, table: str, key: str) -> Optional[Dict[str, Any]]:
        item = self._table(table).get(key)
        return copy.deepcopy(item) if item is not None else None

    def _apply_put(self, table: str, key: str, item: Dict[str, Any]) -> None:
        self._table(table)[key] = copy.deepcopy(item)

    def _apply_delete(self, table: str, key: str) -> None:
        self._table(table).pop(key, None)

    def _apply_update(
        self,
        table: str,
        key: str,
        update: Callable[[Dict[str, Any]], None],
        condition: Optional[Callable[[Dict[str, Any]], bool]] = None,
        create_if_missing: bool = True,
    ) -> Dict[str, Any]:
        tbl = self._table(table)
        if key not in tbl:
            if not create_if_missing:
                raise ConditionFailed(f"{table}/{key} missing")
            tbl[key] = {}
        item = tbl[key]
        if condition is not None and not condition(item):
            raise ConditionFailed(f"condition failed on {table}/{key}")
        update(item)
        return copy.deepcopy(item)

    # -- coroutine API ---------------------------------------------------------

    def get(self, table: str, key: str, consistent: bool = True) -> Generator:
        kb = _size_kb(self._table(table).get(key))
        # eventually consistent reads are ~2x cheaper/faster but FaaSKeeper
        # never uses them (they break Linearized Writes, §4.4)
        yield Sleep(self.cloud.sample("kv_read", kb) * (1.0 if consistent else 0.5))
        item = self._apply_get(table, key)
        self.read_units += max(1, int(kb / 4) + 1)
        return item

    def put(self, table: str, key: str, item: Dict[str, Any]) -> Generator:
        kb = _size_kb(item)
        yield Sleep(self.cloud.sample("kv_write", kb))
        self._apply_put(table, key, item)
        self.write_units += max(1, int(kb) + 1)
        return None

    def delete(self, table: str, key: str) -> Generator:
        yield Sleep(self.cloud.sample("kv_write", 0.1))
        self._apply_delete(table, key)
        self.write_units += 1
        return None

    def update(
        self,
        table: str,
        key: str,
        update: Callable[[Dict[str, Any]], None],
        condition: Optional[Callable[[Dict[str, Any]], bool]] = None,
        kind: str = "kv_cond_update",
        size_kb: Optional[float] = None,
        create_if_missing: bool = True,
    ) -> Generator:
        """Atomic conditional update expression.

        Raises :class:`ConditionFailed` *after* the round trip — a failed
        conditional update still costs a round trip and a write unit, exactly
        like DynamoDB.
        """
        existing = self._table(table).get(key)
        kb = size_kb if size_kb is not None else _size_kb(existing)
        yield Sleep(self.cloud.sample(kind, kb))
        self.write_units += max(1, int(kb) + 1)
        return self._apply_update(table, key, update, condition, create_if_missing)

    def transact(
        self,
        items: "list[tuple[str, str, Callable[[Dict[str, Any]], None], Optional[Callable[[Dict[str, Any]], bool]]]]",
        kind: str = "kv_cond_update",
    ) -> Generator:
        """Multi-item conditional transaction (DynamoDB TransactWriteItems).

        The paper uses this for ops that lock more than one node ("the commit
        creates a transaction from multiple atomic operations that will fail
        or succeed simultaneously", §4.2).  Items are ``(table, key, update,
        condition)``.  All conditions are checked first; only if every one
        holds are all updates applied — atomically, at one virtual-time
        instant.
        """
        total_kb = sum(_size_kb(self._table(t).get(k)) for t, k, _, _ in items)
        yield Sleep(self.cloud.sample(kind, total_kb) * (1.0 + 0.15 * (len(items) - 1)))
        self.write_units += max(1, int(total_kb) + 1) * 2  # txn writes cost 2x
        for t, k, _, cond in items:
            item = self._table(t).get(k, {})
            if cond is not None and not cond(item):
                raise ConditionFailed(f"txn condition failed on {t}/{k}")
        results = []
        for t, k, update, _ in items:
            tbl = self._table(t)
            if k not in tbl:
                tbl[k] = {}
            update(tbl[k])
            results.append(copy.deepcopy(tbl[k]))
        return results

    def scan(self, table: str) -> Generator:
        tbl = self._table(table)
        kb = _size_kb(tbl)
        yield Sleep(self.cloud.sample("kv_scan", kb))
        self.read_units += max(1, int(kb / 4) + 1)
        return copy.deepcopy(tbl)


class ObjectStore:
    """S3-semantics bucket store: whole-object PUT/GET, strong consistency.

    §4.3 *Implementation*: "the update operation of S3 requires the complete
    replacement of data" — partial updates are impossible, so the distributor
    must rewrite full objects (this is Requirement #6 in §7.1).
    """

    def __init__(self, cloud: SimCloud, name: str = "data", region: str = "region-0"):
        self.cloud = cloud
        self.name = name
        self.region = region
        self.objects: Dict[str, Dict[str, Any]] = {}
        self.reads = 0
        self.writes = 0
        self.bytes_stored = 0.0

    def get(self, key: str) -> Generator:
        kb = _size_kb(self.objects.get(key))
        yield Sleep(self.cloud.sample("obj_read", kb))
        self.reads += 1
        obj = self.objects.get(key)
        return copy.deepcopy(obj) if obj is not None else None

    def put(self, key: str, obj: Dict[str, Any]) -> Generator:
        kb = _size_kb(obj)
        yield Sleep(self.cloud.sample("obj_write", kb))
        self.writes += 1
        self.objects[key] = copy.deepcopy(obj)
        self.bytes_stored = sum(_size_kb(o) for o in self.objects.values()) * 1024.0
        return None

    def delete(self, key: str) -> Generator:
        yield Sleep(self.cloud.sample("obj_write", 0.05))
        self.writes += 1
        self.objects.pop(key, None)
        return None

    def list(self, prefix: str = "") -> Generator:
        yield Sleep(self.cloud.sample("obj_read", 1.0))
        self.reads += 1
        return sorted(k for k in self.objects if k.startswith(prefix))


class PageBlobStore:
    """Object-store bucket for offloaded KV page blobs (S3 semantics:
    whole-blob PUT/GET, strong consistency, pay-per-operation).

    The decode scheduler is synchronous — it cannot yield into the SimCloud
    event loop mid-``step()`` — so blob data applies immediately (the put is
    durable the moment it returns, as a blocking S3 client would behave)
    while every operation is journaled with its payload size.  The serving
    frontend drains the journal between decode steps and replays it against
    the calibrated ``obj_write``/``obj_read`` latency and Table-4 cost
    models, so offload traffic is billed like any other storage op.

    Metering: ``puts/gets/deletes`` op counts, ``bytes_out`` (offloaded to
    storage), ``bytes_in`` (restored from storage), ``bytes_stored`` /
    ``high_water_bytes`` (retention gauges).
    """

    def __init__(self, name: str = "kv-offload"):
        self.name = name
        self.blobs: Dict[str, Any] = {}
        self._nbytes: Dict[str, int] = {}
        self.puts = 0
        self.gets = 0
        self.deletes = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.high_water_bytes = 0
        self.ops: list = []          # journal of (op, key, kb) for billing

    @property
    def bytes_stored(self) -> int:
        return sum(self._nbytes.values())

    def put(self, key: str, blob: Any, nbytes: int) -> None:
        self.blobs[key] = blob
        self._nbytes[key] = int(nbytes)
        self.puts += 1
        self.bytes_out += int(nbytes)
        self.high_water_bytes = max(self.high_water_bytes, self.bytes_stored)
        self.ops.append(("put", key, nbytes / 1024.0))

    def get(self, key: str) -> Any:
        if key not in self.blobs:
            raise KeyError(f"page blob {key!r} not in store {self.name!r}")
        self.gets += 1
        nbytes = self._nbytes[key]
        self.bytes_in += nbytes
        self.ops.append(("get", key, nbytes / 1024.0))
        return self.blobs[key]

    def delete(self, key: str) -> None:
        if self.blobs.pop(key, None) is not None:
            self._nbytes.pop(key, None)
            self.deletes += 1
            self.ops.append(("delete", key, 0.05))

    def drain_ops(self) -> list:
        """Hand the billing journal to the driver (frontend) and clear it."""
        ops, self.ops = self.ops, []
        return ops

    def clear(self) -> None:
        """Crash recovery: orphaned blobs are garbage — a reset scheduler
        replays every admission from its prompt, never from a blob."""
        self.blobs.clear()
        self._nbytes.clear()
        self.ops = []
