"""Storage prices of the KV page-blob path (paper §6, Table 4).

The serving path's copy of the page-blob part of the JAX package's cost
model: S3 per-operation rates and GB-month retention.  The rest of that
model (DynamoDB, queues, the ZooKeeper comparison) is not on this path.
"""

from __future__ import annotations

R_S3 = 4e-7           # USD per object read (billed per access)
W_S3 = 5e-6           # USD per object write
S3_GB_MONTH = 0.023   # USD per GB-month of retention


def page_blob_op_cost(op: str) -> float:
    """Per-op cost of a KV page-blob storage operation (Table 4 S3 rates:
    billed per access regardless of size; deletes are free, as on S3)."""
    return {"put": W_S3, "get": R_S3, "delete": 0.0}[op]


def page_blob_cost(puts: int, gets: int, stored_gb_days: float = 0.0) -> float:
    """Total storage-side cost of an offload trajectory: op charges plus
    S3 retention for blob-days actually stored (the pay-as-you-go half of
    the preemption tradeoff — compute freed now, transfer+storage paid)."""
    return (puts * W_S3 + gets * R_S3
            + stored_gb_days * S3_GB_MONTH / 30.0)


def page_blob_retention_cost(byte_seconds: float) -> float:
    """S3 retention for a byte-seconds integral (Table 4 GB-month rate).

    This is the parked-session trade: retaining an offloaded session's KV
    blob costs ``bytes * seconds`` of storage; dropping it costs the next
    request a full re-prefill.  At Table-4 rates retention is ~1e-13
    USD/KB-s, so parking wins whenever the session returns within hours."""
    return page_blob_cost(0, 0, stored_gb_days=byte_seconds / 1e9 / 86400.0)
