"""One import point for the distributed pieces the sharding layer uses.

The JAX package's shims (``AbstractMesh``'s modern constructor,
``jax.shard_map``) have no meaning in torch.  What the rules need is a mesh
without devices, which the reference gets from ``jax.sharding.AbstractMesh``:
:class:`AbstractMesh` is that mesh here, names and sizes and nothing else.
A live mesh is a ``torch.distributed`` ``DeviceMesh`` over the process
group; :func:`mesh_axes` reads the ``name -> size`` map of either kind.

``DeviceMesh``, ``init_device_mesh`` and the DTensor pieces (``DTensor``,
``Shard``, ``Replicate``, ``distribute_tensor``) moved from private modules
to ``torch.distributed.device_mesh`` / ``torch.distributed.tensor``; both
locations are tried, so one source serves the torch on the card and the
one in the CPU test container.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

try:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
except ImportError:     # older torch
    from torch.distributed._tensor.device_mesh import DeviceMesh, init_device_mesh  # noqa: F401

try:
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
except ImportError:     # older torch
    from torch.distributed._tensor import (DTensor, Replicate, Shard,  # noqa: F401
                                           distribute_tensor)

__all__ = ["AbstractMesh", "DTensor", "DeviceMesh", "Replicate", "Shard",
           "distribute_tensor", "init_device_mesh", "mesh_axes"]


class AbstractMesh:
    """A mesh of named axes with sizes and no devices: what sharding rules
    resolve against (``AbstractMesh((16, 16), ("data", "model"))``).
    ``shape`` maps each axis name to its size, in axis order."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} axis names")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.axis_sizes: Tuple[int, ...] = tuple(int(s) for s in axis_sizes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.axis_sizes}, {self.axis_names})"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in axis order, for an :class:`AbstractMesh` or a
    named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh used for sharding needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.shape)))
