"""Meshes for the dry run and for a local run (the port's copy of the JAX
package's ``launch/mesh.py``).

``make_production_mesh`` describes the 16 x 16 (256-chip) and 2 x 16 x 16
(512-chip) meshes by their axis names and sizes only: ``distributed/
sharding.logical_to_spec`` needs nothing more.  ``production_device_mesh``
(``fake_device_mesh``) brings the same mesh up as a CPU ``DeviceMesh``
whose process group is PyTorch's fake one, with this process as rank 0
of 256 or 512: DTensor lays out and redistributes rank 0's shards on
it, and a collective moves nothing (the dry run's SPMD half).
``make_local_mesh`` builds a real ``DeviceMesh`` over the ranks of the
process group that is up.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_device_mesh(shape: MeshShape):
    """``shape`` as a ``DeviceMesh`` on the CPU, over a fake process group
    of ``shape.size`` ranks in which this process is rank 0, the axes
    named as ``shape``'s; the group is destroyed when the block ends.
    Raises if a process group is up already."""
    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh brings up a process group of "
                           "its own, and one is up already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape.size)
    try:
        yield init_device_mesh("cpu", tuple(shape.axis_sizes),
                               mesh_dim_names=tuple(shape.axis_names))
    finally:
        dist.destroy_process_group()


def production_device_mesh(*, multi_pod: bool = False):
    """``make_production_mesh``'s mesh as a ``fake_device_mesh``: a
    context whose value is the ``DeviceMesh``."""
    return fake_device_mesh(make_production_mesh(multi_pod=multi_pod))


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
