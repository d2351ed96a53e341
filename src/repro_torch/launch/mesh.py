"""Production and test meshes over the ranks of ``torch.distributed``.

The JAX package's ``launch/mesh.py`` lays TPU v5e pods out as ``(16, 16)``
``("data", "model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")`` device
meshes.  Here a mesh is a ``DeviceMesh`` over the first ``prod(shape)`` ranks
of the default process group, one process a device, on ``"cuda"`` unless
the caller asks for ``"cpu"``.  Functions, so importing this module touches
no process group and no device.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple, axes: tuple, device: str) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {tuple(shape)}, have {have}; "
            "initialise torch.distributed with a world of at least that size "
            "(one process a device)")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The reference's pod mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` for ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device: str = "cuda") -> DeviceMesh:
    """A small mesh of ``shape`` over ``axes``."""
    return _mesh(tuple(shape), tuple(axes), device)


def launcher_mesh(preset: str, multi_pod: bool = False,
                  device: str = "cuda") -> DeviceMesh | None:
    """The mesh ``launch.train`` and ``launch.serve`` run on, by the
    reference's rule: the reduced preset a ``(1, 1)`` test mesh; the full
    preset the ``(16, 16)`` production mesh, or with ``multi_pod`` the
    ``(2, 16, 16)`` one, each raising without the ranks it needs.  One
    difference: with no process group initialised, the reduced preset and
    the full one without ``multi_pod`` run on this process's one device,
    the reference's ``(1, 1)`` mesh, and get ``None``: every placement over
    a ``(1, 1)`` mesh is the whole tensor, so nothing is placed and no
    group is started."""
    if preset == "reduced":
        return (make_test_mesh((1, 1), device=device)
                if dist.is_initialized() else None)
    if multi_pod or dist.is_initialized():
        return make_production_mesh(multi_pod=multi_pod, device=device)
    return None


def describe(mesh: DeviceMesh | None, device) -> str:
    """One line naming the mesh a launcher runs on."""
    if mesh is None:
        return (f"mesh (1, 1) ('data', 'model') on {device}: no process "
                "group, a world of one, nothing placed")
    return (f"mesh {tuple(mesh.shape)} {tuple(mesh.mesh_dim_names)} on "
            f"{mesh.device_type}, {dist.get_world_size()} ranks")


__all__ = ["make_production_mesh", "make_test_mesh", "launcher_mesh",
           "describe"]
