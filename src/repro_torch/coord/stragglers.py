"""Straggler detection via per-step progress znodes + the heartbeat function
(the JAX package's ``coord/stragglers.py``, on the port's FaaSKeeper core).

Each worker writes its step counter to ``/progress/<id>`` after every
training step (cheap: one conditional KV update, the paper's atomic-counter
primitive).  The scheduled heartbeat function — the same component the paper
uses to prune dead sessions — doubles as the straggler scanner: a worker
whose progress lags the median by more than ``lag_threshold`` steps is
flagged, and policy decides (re-dispatch its shard / drop-slowest / ignore).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

from ..core import FaaSKeeperService, NodeExistsError, NoNodeError

PROGRESS_DIR = "/progress"


@dataclass
class StragglerReport:
    median_step: float
    lagging: List[str]
    progress: Dict[str, int]


class StragglerDetector:
    def __init__(self, service: FaaSKeeperService, lag_threshold: int = 3):
        self.service = service
        self.lag_threshold = lag_threshold
        self.admin = service.connect_sync("straggler-admin")
        try:
            self.admin.create(PROGRESS_DIR, b"")
        except NodeExistsError:
            pass
        self._clients = {}

    def _client(self, worker_id: str):
        c = self._clients.get(worker_id)
        if c is None:
            c = self.service.connect_sync(f"progress:{worker_id}")
            self._clients[worker_id] = c
        return c

    # -- worker side -------------------------------------------------------------

    def report(self, worker_id: str, step: int) -> None:
        client = self._client(worker_id)
        path = f"{PROGRESS_DIR}/{worker_id}"
        payload = json.dumps({"step": step}).encode()
        try:
            client.set_data(path, payload)
        except NoNodeError:
            client.create(path, payload, ephemeral=True)

    # -- scanner (runs inside the scheduled heartbeat in production) ---------------

    def scan(self) -> StragglerReport:
        workers, _ = self.admin.get_children(PROGRESS_DIR)
        progress = {}
        for w in workers:
            try:
                data, _ = self.admin.get_data(f"{PROGRESS_DIR}/{w}")
                progress[w] = json.loads(data).get("step", 0)
            except NoNodeError:
                continue
        if not progress:
            return StragglerReport(0.0, [], {})
        steps = sorted(progress.values())
        median = steps[len(steps) // 2]
        lagging = [w for w, s in progress.items() if median - s > self.lag_threshold]
        return StragglerReport(float(median), lagging, progress)
