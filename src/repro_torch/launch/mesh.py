"""Production mesh construction: a port of ``repro.launch.mesh``.

Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod:  2x16x16 = 512 devices, axes (pod, data, model); the pod axis is
pure data parallelism across pods (the gradient all-reduce crosses the
slower links between pods; everything bandwidth-hungry stays inside one).

A mesh here is either an `AbstractMesh` (axis names and sizes, no devices
and no process group: what the dry run counts on, the counterpart of the
reference's 512 fake host devices) or a ``torch.distributed`` `DeviceMesh`.
Every rule of `launch.sharding` reads only a mesh's axis names and sizes
(`axis_names`, `axis_size`), so it takes either kind.  Importing this
module touches no device and no process group.

The dry run counts the port's sharded program on a `DeviceMesh` of the
production shape with no cluster behind it (`fake_mesh`): a cuda-typed mesh
over torch's fake process group of the mesh's size, in which this process
is rank 0.  The fake group moves no data, and its collectives on meta
tensors compute nothing; DTensor picks the collectives it would issue on
NCCL (a cuda-typed mesh), and the card is never touched.  As the
reference's dry run must own its device count before jax starts, the
process that counts owns that group: the dry run's CLI, or a child
process of whoever calls it.
"""

from __future__ import annotations

import contextlib
import math

#: every axis name the meshes of this module are built with
MESH_AXES = ("pod", "data", "expert", "model")


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices: ``shape`` and
    ``mesh_dim_names`` as a `DeviceMesh` has them."""

    def __init__(self, shape, mesh_dim_names):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(mesh_dim_names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and names "
                             f"{self.mesh_dim_names} differ in length")

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.mesh_dim_names,
                                                     self.shape))
        return f"AbstractMesh({axes})"


def production_shape(*, multi_pod: bool = False,
                     expert_axis: int = 0) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh.  ``expert_axis > 0``
    factorizes the in-pod model dimension as (expert_axis x
    16 // expert_axis), the few-expert MoE variant; the device count is
    unchanged."""
    if expert_axis:
        tp = 16 // expert_axis
        if multi_pod:
            return (2, 16, expert_axis, tp), ("pod", "data", "expert", "model")
        return (16, expert_axis, tp), ("data", "expert", "model")
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, expert_axis: int = 0,
                         device_type: str | None = None):
    """The production mesh: an `AbstractMesh`, or, when ``device_type`` is
    named, a `DeviceMesh` over the process group already open, which must
    hold exactly the mesh's device count."""
    shape, names = production_shape(multi_pod=multi_pod,
                                    expert_axis=expert_axis)
    if device_type is None:
        return AbstractMesh(shape, names)
    return _device_mesh(device_type, shape, names)


@contextlib.contextmanager
def fake_group(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for the block: opened here if none is open (and closed after), kept if
    one of ``n`` is open already; a default group of another size raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"a mesh of {n} devices needs a fake process group of {n} "
                f"ranks; this process has a default group of "
                f"{dist.get_world_size()} ({dist.get_backend()}): count in "
                "a process of its own")
        yield
        return
    # registers torch's fake backend ("fake") on import
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, names, device_type: str = "cuda"):
    """A `DeviceMesh` of ``shape`` named ``names`` over the fake default
    group open now (`fake_group` of the mesh's size), typed ``device_type``
    and touching no device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("fake_mesh needs the fake group open: "
                           "`with fake_group(n):`")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the fake group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cuda"):
    """A small (data, model) `DeviceMesh` over the open process group (one
    rank a device), for tests and the smoke; on one card, world size 1."""
    return _device_mesh(device_type, (n_data, n_model), ("data", "model"))


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an open process group: call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device_type == "cuda":
        import torch
        # one rank a card: bind this rank's before NCCL opens communicators
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def n_devices(mesh) -> int:
    return math.prod(mesh.shape)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, name) -> int:
    """The size of a mesh axis, or the product over a tuple of axes; 1 for
    an axis the mesh does not have."""
    if isinstance(name, (tuple, list)):
        s = 1
        for n in name:
            s *= axis_size(mesh, n)
        return s
    names = axis_names(mesh)
    return mesh.shape[names.index(name)] if name in names else 1
