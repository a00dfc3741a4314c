"""The object-store bucket the decode scheduler offloads KV page blobs to.

This is the serving path's copy of the JAX package's ``PageBlobStore``; the
rest of that module (FaaSKeeper's DynamoDB/S3 data stores) is not on the
serving path and is not copied.  A blob is a dict of CPU tensors: the
scheduler copies a victim's pages off the card before it puts them here, so
an offload frees device memory, not just pool accounting.
"""

from __future__ import annotations

from typing import Any, Dict


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
