"""Worker membership via ephemeral znodes + watch-driven elastic re-meshing.

Every training worker holds a FaaSKeeper session and an *ephemeral* znode
under ``/cluster/members``; the paper's scheduled heartbeat function evicts
dead workers (their ephemeral disappears), and watches on the membership
directory push the change to every survivor, which triggers a re-mesh
(recompile with a smaller/larger device mesh) — elastic scaling with
ZooKeeper-grade consistency, from serverless parts only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List

from ..core import FaaSKeeperService, NoNodeError, NodeExistsError

MEMBERS_DIR = "/cluster/members"
CONFIG_NODE = "/cluster/config"


@dataclass
class WorkerHandle:
    worker_id: str
    client: "SyncClient"  # noqa: F821
    path: str


class MembershipService:
    """One instance per process in the simulation; in production one per host."""

    def __init__(self, service: FaaSKeeperService):
        self.service = service
        self._joins: Dict[str, int] = {}   # per worker-id incarnation count
        self._bootstrap()

    def _bootstrap(self) -> None:
        admin = self.service.connect_sync("membership-admin")
        for path in ("/cluster", MEMBERS_DIR):
            try:
                admin.create(path, b"")
            except NodeExistsError:
                pass
        try:
            admin.create(CONFIG_NODE, json.dumps({"generation": 0}).encode())
        except NodeExistsError:
            pass
        self.admin = admin

    # -- worker lifecycle ---------------------------------------------------------

    def join(self, worker_id: str, capacity: Dict = None) -> WorkerHandle:
        # each join is a fresh FaaSKeeper session: a restart (or a takeover
        # while the predecessor is still live) must not collide with the old
        # incarnation's session id — only the *znode* name is stable
        n = self._joins.get(worker_id, 0) + 1
        self._joins[worker_id] = n
        sid = f"worker:{worker_id}" if n == 1 else f"worker:{worker_id}#{n}"
        client = self.service.connect_sync(sid)
        payload = json.dumps({"id": worker_id, **(capacity or {})}).encode()
        try:
            path = client.create(f"{MEMBERS_DIR}/{worker_id}", payload, ephemeral=True)
        except NodeExistsError:
            # stale ephemeral from a previous incarnation of this worker
            # (e.g. restart after crash, before the heartbeat evicted it):
            # take it over — delete + recreate under the new session.
            client.delete(f"{MEMBERS_DIR}/{worker_id}")
            path = client.create(f"{MEMBERS_DIR}/{worker_id}", payload, ephemeral=True)
        return WorkerHandle(worker_id, client, path)

    def leave(self, handle: WorkerHandle) -> None:
        try:
            handle.client.delete(handle.path)
        except NoNodeError:
            pass
        handle.client.close()

    def fail(self, handle: WorkerHandle) -> None:
        """Simulate a crash: stop answering heartbeats; the scheduled
        heartbeat function will evict the session and its ephemerals."""
        handle.client.client.failed = True

    # -- views ---------------------------------------------------------------------

    def members(self, watch: bool = False) -> List[str]:
        children, _ = self.admin.get_children(MEMBERS_DIR, watch=watch)
        return children

    def await_change(self, timeout: float = 600.0) -> List[str]:
        """Block (in virtual time) until the membership watch fires."""
        self.admin.wait_watch(MEMBERS_DIR, timeout=timeout)
        return self.members()

    # -- elastic re-mesh ------------------------------------------------------------

    def propose_mesh(self, n_workers: int, model_parallel: int) -> Dict:
        """Publish a new mesh generation; workers watch CONFIG_NODE."""
        data, stat = self.admin.get_data(CONFIG_NODE)
        gen = json.loads(data or b"{}").get("generation", 0) + 1
        dp = max(1, n_workers // model_parallel)
        cfgd = {"generation": gen, "mesh": [dp, model_parallel], "workers": n_workers}
        self.admin.set_data(CONFIG_NODE, json.dumps(cfgd).encode(), version=stat.version)
        return cfgd

    def current_mesh(self, watch: bool = False) -> Dict:
        data, _ = self.admin.get_data(CONFIG_NODE, watch=watch)
        return json.loads(data or b"{}")


def elastic_remesh_loop(membership: MembershipService, model_parallel: int,
                        on_remesh: Callable[[Dict], None], rounds: int = 1) -> List[Dict]:
    """Demo/integration driver: watch membership, republish mesh on change."""
    generations = []
    for _ in range(rounds):
        members = membership.await_change()
        cfgd = membership.propose_mesh(len(members), model_parallel)
        on_remesh(cfgd)
        generations.append(cfgd)
    return generations
