"""Storage and queue prices of the port's paths (paper §6, Table 4).

The port's copy of the parts of the JAX package's cost model that its
paths read: S3 per-operation rates and GB-month retention (the KV
page-blob path), and the DynamoDB and queue unit prices behind
:func:`service_cost_summary` (``FaaSKeeperService.cost_summary``, the
training driver's ``coord_cost_usd``).  The ZooKeeper comparison is not on
these paths.
"""

from __future__ import annotations

from typing import Dict

R_S3 = 4e-7           # USD per object read (billed per access)
W_S3 = 5e-6           # USD per object write
R_DD_UNIT = 0.25e-6   # USD per 4 kB DynamoDB read unit
W_DD_UNIT = 1.25e-6   # USD per 1 kB DynamoDB write unit
Q_UNIT = 0.5e-6       # USD per 64 kB queue message unit
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


def service_cost_summary(service) -> Dict[str, float]:
    """USD totals from the SimCloud meters (ops actually performed)."""
    kv = service.kv
    queue_cost = 0.0
    for queues in [service.session_queues.values(), [service.distq]]:
        for qu in queues:
            queue_cost += qu.pushes * Q_UNIT  # messages < 64 kB in tests
    s3_cost = sum(st.reads * R_S3 + st.writes * W_S3 for st in service.data_stores.values())
    dd_cost = kv.read_units * R_DD_UNIT + kv.write_units * W_DD_UNIT
    fn_cost = service.runtime.cost_usd()
    total = queue_cost + s3_cost + dd_cost + fn_cost
    return {
        "queue_usd": queue_cost,
        "s3_usd": s3_cost,
        "dynamodb_usd": dd_cost,
        "functions_usd": fn_cost,
        "total_usd": total,
    }
