"""Distributed state placement: the sharding rules and policies
(:mod:`.sharding`), and one import point for ``DeviceMesh`` and the DTensor
pieces (:mod:`.compat`)."""

from . import compat, sharding

__all__ = ["compat", "sharding"]
