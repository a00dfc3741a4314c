"""Transactional checkpoint manifests through FaaSKeeper (the JAX
package's ``coord/ckpt_coord.py``, on the port's own FaaSKeeper core).

The bulk tensor shards go to the object store (checkpoint/store.py); the
*manifest* is committed as a FaaSKeeper write, which makes the checkpoint
atomic and totally ordered (txid): a restart issues one strongly consistent
read of ``/ckpt/latest`` and never observes a half-written checkpoint —
exactly the paper's atomicity guarantee (Appendix B-A) applied to training
state.  This is the "most representative of the paper's technique" coupling:
writer lock -> validate -> distributor replicate -> commit, with the
manifest as the znode payload.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from ..core import FaaSKeeperService, NodeExistsError

CKPT_DIR = "/ckpt"
LATEST = "/ckpt/latest"


class CoordinatedManifest:
    """Drop-in (committer, latest_resolver) pair for CheckpointStore."""

    def __init__(self, service: FaaSKeeperService, job: str = "job0"):
        self.client = service.connect_sync(f"ckpt:{job}")
        for path in (CKPT_DIR,):
            try:
                self.client.create(path, b"")
            except NodeExistsError:
                pass
        try:
            self.client.create(LATEST, json.dumps({"step": None}).encode())
        except NodeExistsError:
            pass

    # CheckpointStore committer hook: atomic manifest publish.
    def commit(self, step: int, manifest: Dict) -> None:
        payload = json.dumps({"step": step, "n_leaves": len(manifest["leaves"])}).encode()
        # per-step manifest node (historical record, totally ordered by txid)
        self.client.create(f"{CKPT_DIR}/step_{step:08d}",
                           json.dumps(manifest).encode())
        # move the 'latest' pointer — single atomic znode update
        self.client.set_data(LATEST, payload)

    # CheckpointStore latest_resolver hook: strongly consistent read.
    def latest(self) -> Optional[int]:
        data, _ = self.client.get_data(LATEST)
        return json.loads(data or b"{}").get("step")

    def manifest_for(self, step: int) -> Dict:
        data, _ = self.client.get_data(f"{CKPT_DIR}/step_{step:08d}")
        return json.loads(data)

    def history(self):
        children, _ = self.client.get_children(CKPT_DIR)
        return sorted(c for c in children if c.startswith("step_"))
