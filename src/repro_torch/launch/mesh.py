"""The production mesh, and device meshes over a process group.

:func:`make_production_mesh` is the reference's mesh as an
:class:`~repro_torch.distributed.sharding.AbstractMesh`: single pod =
16x16 (``data``, ``model``), multi-pod adds a leading ``pod`` axis
(2x16x16).  The ``pod`` axis carries only data (and expert) parallelism.
It needs no devices: the dry run (:mod:`repro_torch.launch.dryrun`)
plans every cell on it.

:func:`make_device_mesh` builds a ``DeviceMesh`` over the process group
the caller has initialised (``torch.distributed.init_process_group``
with its own address, world size and rank: nothing here reads the
environment).  It raises when the world does not hold the mesh, and
never shrinks a mesh to fit.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.distributed.sharding import AbstractMesh, mesh_shape


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh_shape(mesh).values())


def make_device_mesh(shape: Sequence[int], names: Sequence[str],
                     device_type: str):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the world's
    ranks in order, on ``device_type`` (``"cuda"`` or ``"cpu"``).  Raises
    without an initialised process group or when the world size is not
    the product of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"{len(names)} axis names for a {len(shape)}-d mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)
