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
* :func:`default_mesh` -- the cached 1-D mesh over the default process
  group that a path takes when its caller names no mesh;
* :func:`all_reduce_sum` / :func:`all_gather_slices` -- the aggregation
  paths' two collectives; :func:`all_to_all` / :func:`all_gather_equal` /
  :func:`replicated` -- the expert-parallel MoE dispatch's, differentiable
  (an equal-chunk all-to-all's gradient is the same all-to-all back; a
  gathered result is replicated on every rank, so its gradient is this
  rank's own slice; a tensor every rank holds whole, of which each rank
  uses its own share, has as gradient the sum of every rank's).  Each is
  counted in ``runtime.COLLECTIVES`` after it returned, in the forward
  and the backward pass alike.  With no group (a world of this process
  alone) they call nothing and count nothing.

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


#: the default mesh of each axis name, with the world group it spans
_DEFAULT_MESHES: dict = {}


def default_mesh(axis: str):
    """The 1-D mesh named ``axis`` over every rank of the default process
    group, or ``None`` when no group is initialised: a world of this
    process alone, in which no collective is called (the reference's
    one-device mesh).  Built once per world group and axis: a mesh may
    create a group."""
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    got = _DEFAULT_MESHES.get(axis)
    if got is None or got[0] is not world:
        from torch.distributed.device_mesh import init_device_mesh
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        got = _DEFAULT_MESHES[axis] = (world, init_device_mesh(
            device, (dist.get_world_size(),), mesh_dim_names=(axis,)))
    return got[1]


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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        runtime.COLLECTIVES["all_to_all"] += 1
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.rank = dist.get_rank(group)
        outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(outs, t.contiguous(), group=group)
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        # one all_reduce a dtype, over the gradients flattened end to end
        for dtype in sorted({g.dtype for g in grads}, key=str):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            buf = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.group)
            runtime.COLLECTIVES["all_reduce"] += 1
            for i, part in zip(idx, buf.split([grads[i].numel()
                                               for i in idx])):
                out[i] = part.view_as(grads[i])
        return (None, *out)


def replicated(ts: list[torch.Tensor], group) -> list[torch.Tensor]:
    """``ts`` unchanged, as tensors that every rank of ``group`` holds whole
    and uses a share of: the backward sums each one's gradient over the
    group (one ``all_reduce`` a dtype), so that every rank gets the whole
    gradient of a loss every rank computes alike.  Only the tensors that
    need a gradient pass through it; none, or no group, or autograd off:
    ``ts`` as they are, and no collective."""
    need = [i for i, t in enumerate(ts) if t.requires_grad]
    if group is None or not need or not torch.is_grad_enabled():
        return list(ts)
    out = list(ts)
    for i, t in zip(need, _Replicated.apply(group, *(ts[i] for i in need))):
        out[i] = t
    return out


def all_to_all(buf: torch.Tensor, group) -> torch.Tensor:
    """Split ``buf``'s first axis into one equal chunk a rank of ``group``,
    send chunk ``j`` to rank ``j``, and return what each rank sent this one,
    in rank order (``buf``'s shape)."""
    if group is None:
        return buf
    out = _AllToAll.apply(buf, group)
    runtime.COLLECTIVES["all_to_all"] += 1
    return out


def all_gather_equal(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), stacked in rank
    order: ``(world, *t.shape)``."""
    if group is None:
        return t[None]
    out = _AllGather.apply(t, group)
    runtime.COLLECTIVES["all_gather"] += 1
    return out


__all__ = ["axis_size", "client_group", "client_slices", "local_slice",
           "all_reduce_sum", "all_gather_slices", "all_to_all",
           "all_gather_equal", "default_mesh", "replicated"]
