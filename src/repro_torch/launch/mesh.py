"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no process
group.  The axes are the reference's:

  single-pod : (16, 16)      -> ("data", "model")
  multi-pod  : (2, 16, 16)   -> ("pod", "data", "model")

"data" is the FSDP axis (parameters sharded, all-gathered where used; the
batch split), "model" the tensor/expert axis, "pod" a second data axis or
the pipeline axis (``distributed/pipeline.py``).  Each is a
``DeviceMesh`` over the ranks of the process group, which the caller
starts (``torchrun`` sets its address, or ``init_process_group`` with
``tcp://localhost:<port>``): without one these functions raise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import require_process_group


def _device_type() -> str:
    """The mesh's device: the card under NCCL, the CPU under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") over a process group of exactly 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    require_process_group()
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} needs "
                           f"{n} ranks; the process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A ("data", "model") mesh over the first data * model ranks of the
    process group, clipped as the reference clips it to the devices that
    exist: data at most the world size, model at most what is left.  A
    rank outside the mesh gets it too, with no coordinate
    (``mesh.get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh
    require_process_group()
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    ranks = torch.arange(data * model).view(data, model)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: every axis but "model"."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out
