"""FaaSKeeper service wiring (paper Fig. 4/5, Table 2 mapping).

Components:
  * system store        — KVStore  ("DynamoDB tables": state, sessions, watch)
  * user data stores    — ObjectStore per region ("S3 buckets")
  * session queues      — one FIFO queue per session -> writer event function
  * distributor queue   — single FIFO queue -> distributor event function
                          (its sequence numbers are the global txids)
  * watch function      — free function fanning out notifications
  * heartbeat function  — scheduled
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional

from .client import FaaSKeeperClient, SyncClient
from .distributor import DistributorCore, epoch_key
from .functions import FunctionRuntime
from .heartbeat import HeartbeatCore
from .primitives import Primitives
from .queues import FifoQueue
from .simcloud import SimCloud, Sleep, Task
from .storage import KVStore, ObjectStore
from .watches import WatchRegistry
from .writer import WriterCore

SYSTEM_SESSION = "system"


class FaaSKeeperService:
    def __init__(
        self,
        cloud: SimCloud,
        regions: tuple = ("region-0",),
        function_memory_mb: int = 2048,
        heartbeat_period: float = 60.0,
        heartbeat_timeout: float = 1.0,
        queue_batch_size: int = 10,
        max_lock_time: float = 5.0,
    ):
        self.cloud = cloud
        self.kv = KVStore(cloud, "system")
        self.data_stores: Dict[str, ObjectStore] = {
            r: ObjectStore(cloud, name=f"data-{r}", region=r) for r in regions
        }
        self.prim = Primitives(self.kv, max_lock_time=max_lock_time)
        self.watches = WatchRegistry(self.kv, self.prim)
        self.runtime = FunctionRuntime(cloud, memory_mb=function_memory_mb)
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_period = heartbeat_period
        self.queue_batch_size = queue_batch_size

        self.clients: Dict[str, FaaSKeeperClient] = {}
        self.session_queues: Dict[str, FifoQueue] = {}

        # distributor pipeline
        self.distq = FifoQueue(
            cloud, "distributor", batch_size=queue_batch_size, trigger_kind="fifo_trigger"
        )
        self.writer_core = WriterCore(self.kv, self.prim, self.distq, self._notify)
        self.dist_core = DistributorCore(
            self.kv, self.prim, self.watches, self.data_stores,
            self._notify, self._invoke_watch,
        )
        self._writer_fn = self.runtime.wrap("writer", self.writer_core.handle_batch)
        self._dist_fn = self.runtime.wrap("distributor", self.dist_core.handle_batch)
        self._watch_fn = self.runtime.wrap("watch", self._watch_body)
        self.heartbeat_core = HeartbeatCore(self)
        self._heartbeat_fn = self.runtime.wrap("heartbeat", self.heartbeat_core.body)
        self.distq.set_handler(self._dist_fn)

        # bootstrap: root node + epoch counters + system session
        root = _root_node()
        self.kv._apply_put("state", "node:/", root)
        for r in regions:
            self.kv._apply_put("state", epoch_key(r), {"items": []})
            self.data_stores[r].objects["/"] = {
                "path": "/", "data": b"", "version": 0, "cversion": 0,
                "created_txid": 0, "modified_txid": 0, "children": [],
                "ephemeral_owner": None, "epoch": [],
            }
        self.kv._apply_put("sessions", SYSTEM_SESSION, {"alive": True, "ephemerals": []})

    # -- sessions -------------------------------------------------------------------

    def session_queue(self, session_id: str) -> FifoQueue:
        q = self.session_queues.get(session_id)
        if q is None:
            q = FifoQueue(
                self.cloud, f"writer:{session_id}",
                handler=self._writer_fn, batch_size=self.queue_batch_size,
            )
            self.session_queues[session_id] = q
        return q

    def register_client(self, client: FaaSKeeperClient) -> None:
        self.clients[client.session_id] = client
        self.session_queue(client.session_id)

    def make_client(self, session_id: str, region: Optional[str] = None) -> FaaSKeeperClient:
        region = region or next(iter(self.data_stores))
        return FaaSKeeperClient(self, session_id, region)

    def connect_sync(self, session_id: str, region: Optional[str] = None) -> SyncClient:
        client = self.make_client(session_id, region)
        self.cloud.run_task(client.connect(), name=f"connect:{session_id}")
        return SyncClient(client)

    def enqueue_deregistration(self, session_id: str) -> Generator:
        req = {
            "op": "deregister_session",
            "args": {"target_session": session_id},
            "session": SYSTEM_SESSION,
            "request_id": f"evict:{session_id}:{self.cloud.now:.6f}",
        }
        yield from self.session_queue(SYSTEM_SESSION).push(req, size_kb=0.1)
        return None

    # -- channels ----------------------------------------------------------------------

    def _notify(self, session: str, payload: Dict[str, Any]) -> Generator:
        """Push a result to a client (warm TCP channel, §5.2)."""
        yield Sleep(self.cloud.sample("tcp_rtt"))
        client = self.clients.get(session)
        if client is not None:
            client.inbox.deliver(dict(payload))
        return None

    def _watch_body(self, ctx, region: str, wid: int, clients: List[str],
                    payload: Dict[str, Any], txid: int) -> Generator:
        """Free watch function: fan out one watch instance's notifications,
        then remove the epoch pair (Alg. 2 WATCHCALLBACK)."""
        tasks = []
        for sid in clients:
            tasks.append(self.cloud.spawn(self._notify(sid, payload), name=f"watch->{sid}"))
        from .simcloud import Wait

        yield Wait(tuple(tasks))
        ctx.crash_point("after_deliveries")
        yield from self.prim.list_remove(epoch_key(region), [[wid, txid]])
        return None

    def _invoke_watch(self, region: str, wid: int, clients: List[str],
                      payload: Dict[str, Any], txid: int) -> Task:
        delay = self.cloud.sample("direct_invoke")
        return self.cloud.spawn(
            self._watch_fn(region, wid, clients, payload, txid),
            name=f"watch:{wid}", delay=delay,
        )

    # -- heartbeat ---------------------------------------------------------------------

    def start_heartbeat(self, period: Optional[float] = None, max_runs: Optional[int] = None) -> None:
        self.runtime.schedule_every(
            period or self.heartbeat_period,
            lambda: self._heartbeat_fn(),
            max_runs=max_runs,
        )

    # -- storage durability ------------------------------------------------------------
    #
    # The *services* are durable even though functions are ephemeral (that is
    # the paper's shutdown story: "we can shut down the processing components
    # while not losing any data", §6).  Snapshot/load serialize exactly the
    # storage layer — a process restart with a fresh FaaSKeeperService plus
    # ``load_storage`` is the simulation of new Lambdas attaching to the same
    # DynamoDB tables and S3 buckets.

    def snapshot_storage(self) -> bytes:
        import pickle

        return pickle.dumps({
            "kv_tables": self.kv.tables,
            "objects": {r: s.objects for r, s in self.data_stores.items()},
        })

    def load_storage(self, blob: bytes) -> None:
        import pickle

        state = pickle.loads(blob)
        self.kv.tables = state["kv_tables"]
        for region, objs in state["objects"].items():
            if region in self.data_stores:
                self.data_stores[region].objects = objs

    # -- accounting ---------------------------------------------------------------------

    def cost_summary(self) -> Dict[str, float]:
        from .cost import service_cost_summary

        return service_cost_summary(self)


def _root_node() -> Dict[str, Any]:
    return {
        "path": "/", "exists": True, "data": b"", "version": 0, "cversion": 0,
        "cseq": 0, "children": [], "ephemeral_owner": None,
        "created_txid": 0, "modified_txid": 0, "lock_ts": None, "transactions": [],
    }
