"""Production meshes of the port: :class:`~torch.distributed.device_mesh.
DeviceMesh` in place of the reference's ``jax.sharding.Mesh``.

Single pod: 16×16 = 256 cards, dims ``("data", "model")``.
Multi-pod:  2×16×16 = 512 cards, dims ``("pod", "data", "model")``; the
``pod`` dim crosses the slow inter-node links and carries only data
parallelism (and, optionally, the int8 gradient reduction of
:mod:`repro_torch.optim.compress`).

A mesh is laid over the default process group, which the caller initialises
(``torch.distributed.init_process_group``): a real one on a cluster, or the
fake backend of the dry-run (:mod:`repro_torch.launch.dryrun`).  Importing
this module touches no device and no process group.  A mesh whose size
differs from the group's world size raises.

:class:`MeshAxes` is a mesh's shape without devices (the reference's
``jax.sharding.AbstractMesh``): the sharding rules of
:mod:`repro_torch.parallel.sharding` read only axis names and sizes, so
they take either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class MeshAxes:
    """Axis names and sizes of a mesh, with no device behind them."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim=None) -> int:
        if mesh_dim is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[mesh_dim]


def axis_size(mesh, name: str) -> int:
    """Size of mesh dim ``name`` of a DeviceMesh or a :class:`MeshAxes`."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def production_axes(*, multi_pod: bool = False) -> MeshAxes:
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return MeshAxes(shape, names)


def make_mesh(axes: MeshAxes, device: DeviceLike = None):
    """A DeviceMesh of ``axes``' shape and names over the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = axes.shape, axes.mesh_dim_names
    n = axes.size()
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"world size {n}: call torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs world size {n}, the "
            f"process group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The 16×16 (or 2×16×16) production mesh over the default group."""
    return make_mesh(production_axes(multi_pod=multi_pod), device)


def make_local_mesh(model: int = 1, device: DeviceLike = None):
    """A ``(world // model) × model`` mesh over the default group (tests, one
    card: world size 1 gives a 1×1 mesh)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} does not divide into model={model}")
    return make_mesh(MeshAxes((n // model, model), ("data", "model")), device)


def batch_axes(mesh) -> tuple:
    """Mesh dims that carry the batch (data-parallel) dimension."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    n = axis_size(mesh, "data")
    if "pod" in mesh.mesh_dim_names:
        n *= axis_size(mesh, "pod")
    return n
