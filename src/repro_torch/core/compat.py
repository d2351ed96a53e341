"""The process-group plumbing of the distributed paths.

The JAX package's ``core/compat.py`` wraps ``shard_map``: one controller
traces a body that every device of a mesh runs, and ``psum`` /
``all_gather`` name a mesh axis.  In PyTorch every process runs the whole
program (SPMD), one process a rank, so the process group *is* what the
shard_map was: the port has no counterpart of ``shard_map`` or
``shard_map_no_check``, and a mesh axis becomes the process group of that
axis.  What the distributed paths need instead:

* :func:`axis_size` -- the number of ranks of a mesh axis or a group;
* :func:`client_group` -- the process group of a ``(mesh, client_axis)``
  pair, ``mesh.get_group(client_axis)``;
* :func:`client_slices` / :func:`local_slice` -- the contiguous slice of a
  cohort each rank reduces (as even as ``n`` allows; a rank may hold none);
* :func:`all_reduce_sum` / :func:`all_gather_slices` -- the two collectives,
  each counted in ``runtime.COLLECTIVES`` after it returned.  With no group
  (a world of this process alone) they call nothing and count nothing.

A collective runs on the tensor where it lies: a CUDA tensor goes to the
backend as a CUDA tensor, and a failure propagates.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import runtime


def axis_size(mesh_or_group=None, axis: str | None = None) -> int:
    """Ranks along ``axis`` of a ``DeviceMesh`` (all of them for ``axis=None``),
    or of a process group; ``None`` is the default group, or this process
    alone when no group is initialised."""
    if mesh_or_group is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return dist.get_world_size(mesh_or_group)
    if axis is None:
        return mesh_or_group.size()
    return mesh_or_group.size(mesh_or_group.mesh_dim_names.index(axis))


def client_group(mesh, client_axis: str):
    """The process group of ``client_axis`` of ``mesh``; ``None`` (no
    collective) for ``mesh=None``."""
    return None if mesh is None else mesh.get_group(client_axis)


def client_slices(n: int, world: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` of each rank's clients: contiguous, in rank order, the
    first ``n % world`` ranks one client more."""
    base, extra = divmod(n, world)
    bounds = [k * base + min(k, extra) for k in range(world + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def local_slice(n: int, group) -> slice:
    """This rank's slice of ``n`` clients (all of them without a group)."""
    if group is None:
        return slice(0, n)
    lo, hi = client_slices(n, dist.get_world_size(group))[
        dist.get_rank(group)]
    return slice(lo, hi)


def all_reduce_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """Sum ``buf`` over the ranks of ``group``, in place; returns it."""
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        runtime.COLLECTIVES["all_reduce"] += 1
    return buf


def all_gather_slices(local: torch.Tensor, n: int, group) -> torch.Tensor:
    """Every rank's slice of an ``n``-client cohort, gathered in rank order:
    ``local`` is this rank's ``(hi - lo, ...)`` rows (:func:`local_slice`).
    Slices are padded to the largest, gathered, and the padding dropped,
    so the result is ``(n, ...)`` whatever the world size."""
    if group is None:
        return local
    sizes = [hi - lo for lo, hi in client_slices(n, dist.get_world_size(group))]
    pad = local.new_zeros((max(sizes),) + tuple(local.shape[1:]))
    pad[:local.shape[0]] = local
    outs = [torch.empty_like(pad) for _ in sizes]
    dist.all_gather(outs, pad, group=group)
    runtime.COLLECTIVES["all_gather"] += 1
    return torch.cat([o[:s] for o, s in zip(outs, sizes)])


__all__ = ["axis_size", "client_group", "client_slices", "local_slice",
           "all_reduce_sum", "all_gather_slices"]
