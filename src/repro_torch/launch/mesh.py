"""Meshes: the production meshes the sharding rules are written for, and
a live mesh over the running process group.

``make_production_mesh`` is a function and touches no device: single-pod
is the abstract (16, 16) ``("data", "model")`` mesh, multi-pod the
(2, 16, 16) mesh whose leading ``pod`` axis is hierarchical data
parallelism.  Rules resolve against them with no process group at all.

``make_smoke_mesh(dp, mp, device=...)`` builds a named ``DeviceMesh`` over
the live process group (``torch.distributed.init_process_group`` first;
world size ``dp * mp``).  On one card several ranks share the device, so
the group is gloo (NCCL refuses two ranks on one device), whose
``all_reduce`` and ``broadcast`` take CUDA tensors.
"""

from __future__ import annotations

from ..dist.compat import AbstractMesh, init_device_mesh
from ..dist.sharding import MESH_AXES


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MESH_AXES if multi_pod else MESH_AXES[1:]
    return AbstractMesh(shape, axes)


def make_smoke_mesh(dp: int = 1, mp: int = 1, *, device: str = "cuda"):
    """A ``(dp, mp)`` ``("data", "model")`` DeviceMesh over the live process
    group, whose world size must be ``dp * mp``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_smoke_mesh needs a live process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != dp * mp:
        raise ValueError(f"mesh ({dp}, {mp}) needs {dp * mp} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device, (dp, mp), mesh_dim_names=MESH_AXES[1:])


# Roofline denominators of one NVIDIA H100 80GB HBM3 at its 700 W power limit
# (the name and limit nvidia-smi gives; NVIDIA's data sheet, SXM part, dense)
PEAK_FLOPS_BF16 = 989e12       # per card
HBM_BW = 3.35e12               # bytes/s per card
HBM_PER_CHIP = 80 * 1024**3    # 80 GiB
