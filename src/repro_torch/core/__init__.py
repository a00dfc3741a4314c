"""FaaSKeeper core, the port's own copy (host code, no JAX).

Public surface:
  * :class:`SimCloud` — deterministic simulated cloud substrate,
  * :class:`FaaSKeeperService` — the wired service (Fig. 4/5),
  * :class:`FaaSKeeperClient` / :class:`SyncClient` — kazoo-like API,
  * :class:`Lock` / :class:`Primitives` — the synchronization primitives,
  * :class:`KVStore` / :class:`ObjectStore` / :class:`PageBlobStore` — the
    system, user-data and KV page-blob stores,
  * :class:`FifoQueue` and :class:`FunctionRuntime` — queues and functions.
"""

from .client import FaaSKeeperClient, Stat, SyncClient
from .functions import LAMBDA_GBS_PRICE, LAMBDA_INVOKE_PRICE, FunctionRuntime
from .primitives import Lock, Primitives
from .queues import FifoQueue
from .service import FaaSKeeperService
from .simcloud import FaultPlan, SimCloud, SimulatedCrash, Sleep, Wait, percentiles
from .storage import KVStore, ObjectStore, PageBlobStore
from .znode import (
    BadVersionError,
    FKError,
    NodeExistsError,
    NoNodeError,
    NotEmptyError,
)

__all__ = [
    "FaaSKeeperClient",
    "FaaSKeeperService",
    "FaultPlan",
    "FifoQueue",
    "FunctionRuntime",
    "KVStore",
    "LAMBDA_GBS_PRICE",
    "LAMBDA_INVOKE_PRICE",
    "Lock",
    "ObjectStore",
    "PageBlobStore",
    "Primitives",
    "SimCloud",
    "SimulatedCrash",
    "Sleep",
    "Stat",
    "SyncClient",
    "Wait",
    "percentiles",
    "FKError",
    "NoNodeError",
    "NodeExistsError",
    "BadVersionError",
    "NotEmptyError",
]
