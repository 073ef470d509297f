"""Meshes of the port, the stand-in for ``repro.launch.mesh`` and
``jax.sharding.Mesh``.

A mesh names its axes major to minor and gives their sizes:
``axis_names`` and ``shape`` (name -> size), as JAX's does. A rank is a
point of the mesh; its linear index runs over the axes in that order.
The expert-parallel dispatch exchanges tensors between the ranks through
``repro_torch.shuffle.exchange``, by one of two back ends:

* ``StackedMesh``: every rank in this process. A tensor carries a leading
  axis of all the ranks, rank-major over the mesh's axes, so one card
  runs the whole mesh and an all-to-all is a transpose.
* ``ProcessGroupMesh``: one rank per process of the default
  ``torch.distributed`` process group (gloo on the CPU, NCCL on the
  cards); the leading rank axis has size 1.

``pod_submesh`` gives the stacked mesh of one pod, the mesh without its
pod axis: the ranks a pod-local region (``ShuffleConfig.pod_local``)
runs its expert-parallel dispatch over.

``make_test_mesh`` stacks the JAX package's test mesh;
``process_group_test_mesh`` lays the same axes over the processes of the
default process group (the train launcher's mesh over several
processes).

``make_production_mesh`` describes the JAX package's production mesh
(data 16 x model 16, or pod 2 x data 16 x model 16) as a plain ``Mesh``:
the dry run's twin (``launch.dryrun``) reads its axes and sizes and runs
nothing over it.

Building a mesh touches no device and starts no process; a
``ProcessGroupMesh`` needs the default process group initialised.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, major to minor, and their sizes."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if (len(self.axis_names) != len(self.sizes)
                or len(set(self.axis_names)) != len(self.axis_names)
                or any(not isinstance(s, int) or s < 1 for s in self.sizes)):
            raise ValueError(f"a mesh needs distinct axis names and sizes >= 1, "
                             f"got {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


@dataclasses.dataclass(frozen=True)
class StackedMesh(Mesh):
    """Every rank of the mesh in this process (see the module docstring)."""


@dataclasses.dataclass(frozen=True)
class ProcessGroupMesh(Mesh):
    """One rank per process: the default process group's rank ``r`` is the
    mesh's rank of linear index ``r``. ``groups`` caches the process
    groups that the exchange makes, one set per tuple of axes."""
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def coords(self) -> dict:
        """This process's coordinate along each axis."""
        import torch.distributed as dist

        rank, out = dist.get_rank(), {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            rank, out[name] = divmod(rank, size)
        return out


def stacked_mesh(**sizes: int) -> StackedMesh:
    """A stacked mesh from named sizes, major to minor:
    ``stacked_mesh(pod=2, data=1, model=16)``."""
    return StackedMesh(tuple(sizes), tuple(sizes.values()))


def process_group_mesh(**sizes: int) -> ProcessGroupMesh:
    """A mesh over the default process group, which must be initialised
    with as many processes as the mesh has ranks."""
    import torch.distributed as dist

    mesh = ProcessGroupMesh(tuple(sizes), tuple(sizes.values()))
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        world = dist.get_world_size() if dist.is_initialized() else None
        raise ValueError(f"a process-group mesh of {mesh.size} ranks needs a "
                         f"default process group of that size, got {world}")
    return mesh


def pod_submesh(mesh: StackedMesh, pod_axis: str = "pod") -> StackedMesh:
    """The mesh of one pod: ``mesh`` without ``pod_axis``, holding one
    pod's ranks (the caller runs the pods in turn). A pod of a
    ``ProcessGroupMesh`` is not built: its groups would have to be made
    over the whole mesh's ranks, and no step runs one."""
    if not isinstance(mesh, StackedMesh):
        raise ValueError(f"a pod's mesh is built from a StackedMesh, not a "
                         f"{type(mesh).__name__}")
    if pod_axis not in mesh.axis_names:
        raise ValueError(f"the mesh {mesh.axis_names} has no {pod_axis!r} axis")
    keep = [i for i, a in enumerate(mesh.axis_names) if a != pod_axis]
    return StackedMesh(tuple(mesh.axis_names[i] for i in keep),
                       tuple(mesh.sizes[i] for i in keep))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh: one pod of 256 chips as (data
    16, model 16); ``multi_pod`` adds a leading pod axis of 2."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


# the JAX package's test mesh: its axes, major to minor, for a count of
# ranks; any other count is (data n)
TEST_MESH_AXES = {8: {"pod": 2, "data": 2, "model": 2}, 4: {"data": 2, "model": 2}}


def axes_of_test_mesh(devices: int) -> dict:
    """The test mesh's axes and sizes for ``devices`` ranks (a fresh dict)."""
    return dict(TEST_MESH_AXES.get(devices, {"data": devices}))


def make_test_mesh(*, devices: int = 8) -> StackedMesh:
    """The JAX package's test mesh, stacked: 8 ranks -> (pod 2, data 2,
    model 2), every axis non-trivial; 4 -> (data 2, model 2); else
    (data devices)."""
    return stacked_mesh(**axes_of_test_mesh(devices))


def process_group_test_mesh() -> ProcessGroupMesh:
    """The test mesh's axes (``axes_of_test_mesh``) over the processes of the
    default process group, one rank a process, as the JAX launcher builds
    ``make_test_mesh(devices=n)`` over its n devices. The group must be
    initialised (``torch.distributed.init_process_group``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError("process_group_test_mesh needs the default process group "
                         "initialised (torch.distributed.init_process_group)")
    return process_group_mesh(**axes_of_test_mesh(dist.get_world_size()))
