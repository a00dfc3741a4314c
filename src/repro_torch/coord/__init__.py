"""Control-plane <-> data-plane coupling on the port's FaaSKeeper service:
the serving frontend, worker membership through ephemeral znodes,
transactional checkpoint manifests and straggler detection."""

from .ckpt_coord import CoordinatedManifest
from .membership import (CONFIG_NODE, MEMBERS_DIR, MembershipService, WorkerHandle,
                         elastic_remesh_loop)
from .serving_front import InferenceRequest, ServingFrontend
from .stragglers import StragglerDetector, StragglerReport

__all__ = ["CONFIG_NODE", "CoordinatedManifest", "InferenceRequest", "MEMBERS_DIR",
           "MembershipService", "ServingFrontend", "StragglerDetector", "StragglerReport",
           "WorkerHandle", "elastic_remesh_loop"]
