"""Meshes for the dry run and for a local run (the port's copy of the JAX
package's ``launch/mesh.py``).

``make_production_mesh`` describes the 16 x 16 (256-chip) and 2 x 16 x 16
(512-chip) meshes by their axis names and sizes only: ``distributed/
sharding.logical_to_spec`` needs nothing more, and a ``DeviceMesh`` of 256
or 512 ranks cannot be built on one card.  ``make_local_mesh`` builds a
real ``DeviceMesh`` over the ranks of the process group that is up.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


class MeshShape(NamedTuple):
    """A mesh by its axes: what the sharding rules read of a mesh."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Axes: data (DP/ZeRO-1/SP), model (TP/EP); pod (DP across pods)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1):
    """A ("data", "model") ``DeviceMesh`` over the ranks of the default
    process group, which must be up: data x model clamped to the world
    size as JAX clamps it to the devices there are; on the cards where
    there are cards, else on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
