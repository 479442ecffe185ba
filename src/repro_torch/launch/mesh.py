"""Production mesh construction (src/repro/launch/mesh.py).

Functions, not module-level constants: importing this module touches no
process group. A mesh is built over the process group the caller started
(``parallel/transport.py: init_ranks``, or ``torchrun`` and
``init_process_group``), on that group's device type, and it needs exactly
as many ranks as it has devices — the reference's ``jax.make_mesh`` fails
the same way when the device count is wrong.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel.sharding import Mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """A ``Mesh`` of ``shape`` over the running process group;
    ``device_type`` defaults to the group's transport (``cpu`` for gloo
    alone, ``cuda`` once the ranks hold a card)."""
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {need} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        from repro_torch.parallel.transport import group_device_type
        device_type = group_device_type()
    return Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0,
                   device_type: Optional[str] = None) -> Mesh:
    """Small mesh for tests (needs that many ranks)."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def tp_degree(mesh) -> int:
    return mesh.shape["model"]


def dp_degree(mesh) -> int:
    d = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        d *= mesh.shape["pod"]
    return d
