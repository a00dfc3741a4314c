"""Control-plane <-> data-plane coupling: the serving frontend, and worker
membership through ephemeral znodes on the port's FaaSKeeper service."""

from .membership import (CONFIG_NODE, MEMBERS_DIR, MembershipService, WorkerHandle,
                         elastic_remesh_loop)
from .serving_front import InferenceRequest, ServingFrontend

__all__ = ["CONFIG_NODE", "InferenceRequest", "MEMBERS_DIR", "MembershipService",
           "ServingFrontend", "WorkerHandle", "elastic_remesh_loop"]
