"""Logical sharding rules: tree paths -> PartitionSpec -> DTensor placements.

The port's counterpart of the JAX package's ``repro.sharding.rules``, the
same scheme (megatron-style TP x DP, the FLaaS pod axis on top):

  batch               -> ("pod", "data") when present, else ("data",)
  fused head dims     -> "model"    (q/k/v/up projections: column parallel)
  contracting dims    -> "model"    (o/down projections: row parallel)
  vocab               -> "model" when divisible, else replicated
  MoE expert axis     -> "model"    (expert parallelism)
  LoRA adapters       -> replicated (tiny), except per-expert pairs
  KV cache time axis  -> data axes when the batch axis is unshardable
                         (long_500k, global_batch=1)

Every rule degrades to replication when the dimension does not divide the
mesh axis (e.g. whisper's 51866 vocab) -- recorded via :func:`maybe`.

A spec (:class:`P`) is data: a tuple of one entry per tensor dimension,
each ``None``, an axis name or a tuple of axis names.  The rules read a
mesh only through its axis names and sizes, so a
``torch.distributed.device_mesh.DeviceMesh`` and any object with
``axis_names`` and a ``shape`` mapping (the tests' ``FakeMesh``) both
serve, and the production meshes' specs need no 256 ranks.  Then
:func:`to_shardings` turns a spec into the DTensor placements over a
``DeviceMesh``'s dimensions, :func:`shaped` builds DTensors over meta
local shards (the dry run's inputs, the reference's
``ShapeDtypeStruct(..., sharding=)``) and :func:`place` distributes real
tensors (the reference's ``jax.jit(init, out_shardings=...)``).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

PyTree = Any


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.

    As the reference's ``PartitionSpec`` does, a one-name tuple entry is
    the name itself and an empty one is ``None``, so ``P(None, ("data",))
    == P(None, "data")``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ----------------------------------------------------------------- meshes ----
def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or an
    object's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _size(mesh, name: str) -> int:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return n


def maybe(mesh, dim: int, axes):
    """axes if dim divides the mesh axes product, else None (replicate)."""
    return axes if dim % axis_size(mesh, axes) == 0 else None


# ------------------------------------------------------------------ trees ----
def _map_with_path(fn: Callable, tree: PyTree, path=()) -> PyTree:
    """``fn(path, leaf)`` over a nested dict/tuple tree; ``None`` is an
    empty subtree.  ``path`` holds the dict keys and sequence indices."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _zip_specs(fn: Callable, specs: PyTree, *trees: PyTree) -> PyTree:
    """``fn(spec, *leaves)`` over a spec tree (a :class:`P` is a leaf) and
    trees of the same structure."""
    if specs is None:
        return None
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, Mapping):
        return {k: _zip_specs(fn, v, *[t[k] for t in trees])
                for k, v in specs.items()}
    return type(specs)(_zip_specs(fn, v, *[t[i] for t in trees])
                       for i, v in enumerate(specs))


# --------------------------------------------------------------- params ----
_COL = ("q", "k", "v", "xq", "xk", "xv", "gate", "up", "fc1", "q_b",
        "kv_b", "in_proj")
_ROW = ("o", "xo", "down", "fc2", "out_proj")


def param_spec_for(path: str, leaf, mesh, fsdp: bool = False) -> P:
    """``fsdp=True`` additionally shards the *contracting* dim of big 2-D
    kernels over the data axes: the base is frozen in LoRA fine-tuning, so
    zero-redundancy sharding costs only the forward all-gather."""
    parts = path.split("/")
    name = parts[-2] if parts[-1] in ("w", "b") else parts[-1]
    ndim = leaf.ndim
    m = "model"
    da = data_axes(mesh)

    def lead(*last) -> P:
        return P(*([None] * (ndim - len(last))), *last)

    def fs(dim: int):
        return maybe(mesh, dim, da) if fsdp else None

    if parts[-1] == "b":                      # biases: shard like fan-out
        if name in _COL:
            return lead(maybe(mesh, leaf.shape[-1], m))
        return lead(None)
    if "experts" in parts:                    # (L, E, in, out): expert axis
        e_axis = ndim - 3
        spec = [None] * ndim
        if leaf.shape[e_axis] % axis_size(mesh, m) == 0:
            spec[e_axis] = m
        if fsdp and leaf.shape[-2] % axis_size(mesh, da) == 0:
            spec[ndim - 2] = da
        return P(*spec)
    if name == "table":                       # embedding (V, d)
        return P(maybe(mesh, leaf.shape[0], m), fs(leaf.shape[1]))
    if name == "lm_head" or (len(parts) >= 2 and parts[-2] == "lm_head"):
        return lead(fs(leaf.shape[-2]), maybe(mesh, leaf.shape[-1], m))
    if name in _COL:
        return lead(fs(leaf.shape[-2]), maybe(mesh, leaf.shape[-1], m))
    if name in _ROW:
        return lead(maybe(mesh, leaf.shape[-2], m), fs(leaf.shape[-1]))
    return P(*([None] * ndim))                # norms, scalars, conv, misc


def param_specs(params: PyTree, mesh, fsdp: bool = False) -> PyTree:
    return _map_with_path(
        lambda path, leaf: param_spec_for(_path_str(path), leaf, mesh, fsdp),
        params)


def replicated_specs(tree: PyTree) -> PyTree:
    return _map_with_path(lambda _, leaf: P(*([None] * leaf.ndim)), tree)


def adapter_specs(adapters: PyTree, mesh) -> PyTree:
    """LoRA adapters are tiny and replicated -- EXCEPT per-expert adapters
    (A (L, E, r, d), B (L, E, out, r)) whose expert axis is sharded over
    'model' exactly like the expert weights they adapt."""
    def f(path, leaf):
        if "experts" in _path_str(path) and leaf.ndim == 4:
            spec = [None] * leaf.ndim
            if leaf.shape[1] % axis_size(mesh, "model") == 0:
                spec[1] = "model"
            return P(*spec)
        return P(*([None] * leaf.ndim))
    return _map_with_path(f, adapters)


# ---------------------------------------------------------------- batch ----
def batch_specs(batch: PyTree, mesh) -> PyTree:
    da = data_axes(mesh)

    def f(_, leaf):
        if leaf.ndim == 0:
            return P()
        b = leaf.shape[0]
        ax = da if b % axis_size(mesh, da) == 0 else (
            ("data",) if b % _size(mesh, "data") == 0 else None)
        return P(ax, *([None] * (leaf.ndim - 1)))
    return _map_with_path(f, batch)


# ---------------------------------------------------------------- cache ----
def batch_axes(mesh, global_batch: int):
    """The axes a cache's batch of ``global_batch`` shards over: the data
    axes where the batch divides them, else ``("data",)`` where it divides
    that, else None."""
    da = data_axes(mesh)
    if global_batch % axis_size(mesh, da) == 0:
        return da
    if global_batch % _size(mesh, "data") == 0:
        return ("data",)
    return None


def cache_specs(caches: PyTree, mesh, global_batch: int,
                seq_shard_model: bool = False) -> PyTree:
    """Caches are stacked (L, B, T, ...) kv / (L, B, T, R) latent /
    (L, B, ...) mamba states.  Shard batch over data axes when divisible;
    otherwise (long_500k) shard the *time* axis of attention caches.

    ``seq_shard_model=True`` additionally shards the time axis of a cache
    without a model-sharded head axis (the MLA latent) over 'model'."""
    da = batch_axes(mesh, global_batch)
    batch_shardable = da is not None
    da = da or data_axes(mesh)
    m = "model"

    def time_axis(leaf):
        return da if leaf.shape[2] % axis_size(mesh, da) == 0 \
            else maybe(mesh, leaf.shape[2], ("data",))

    def f(path, leaf):
        name = _path_str(path).split("/")[-1]
        spec = [None] * leaf.ndim
        if batch_shardable:
            spec[1] = da
        if name in ("k", "v", "xk", "xv"):        # (L,B,T,KV,hd)
            spec[3] = maybe(mesh, leaf.shape[3], m)
            if not batch_shardable:
                spec[2] = time_axis(leaf)
        elif name in ("ckv", "kr"):               # (L,B,T,R)
            if not batch_shardable:
                spec[2] = time_axis(leaf)
            elif seq_shard_model:
                spec[2] = maybe(mesh, leaf.shape[2], m)
        elif name == "ssm":                       # (L,B,H,P,N)
            spec[2] = maybe(mesh, leaf.shape[2], m)
        elif name == "conv":                      # (L,B,K-1,C)
            spec[3] = maybe(mesh, leaf.shape[3], m)
        return P(*spec)
    return _map_with_path(f, caches)


# ------------------------------------------------------------- placements ----
def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``'s dimensions: a mesh
    dimension whose axis a tensor dimension names shards that dimension
    (``Shard(d)``), every other one replicates.  A tensor dimension naming
    several axes (``("pod", "data")``) is split over them in the mesh's
    order, which is the spec's for the production meshes."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in owner:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            owner[a] = d
    for entry in spec:
        if isinstance(entry, tuple) and list(entry) != sorted(
                entry, key=names.index):
            raise ValueError(f"spec {spec}: the axes {entry} must follow "
                             f"the mesh's order {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def to_shardings(specs: PyTree, mesh) -> PyTree:
    """Each spec of ``specs`` as its tuple of placements over ``mesh``."""
    return _zip_specs(lambda s: placements(s, mesh), specs)


def _local_shape(shape, places, mesh) -> tuple[int, ...]:
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if out[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(shape)} "
                                 f"does not divide mesh dimension {i} "
                                 f"({n})")
            out[pl.dim] //= n
    return tuple(out)


def shaped(shapes: PyTree, specs: PyTree, mesh, device="meta") -> PyTree:
    """DTensors of ``shapes``' leaves (anything with ``shape`` and
    ``dtype``: meta tensors, say) placed by ``specs`` over ``mesh``, each
    over an empty local shard on ``device``: on the meta device, or under
    ``FakeTensorMode`` on any, no memory -- the dry run's inputs."""
    from torch.distributed.tensor import DTensor

    def f(spec, leaf):
        places = placements(spec, mesh)
        local = torch.empty(_local_shape(leaf.shape, places, mesh),
                            dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=torch.Size(leaf.shape),
                                  stride=_contiguous_stride(leaf.shape))
    return _zip_specs(f, specs, shapes)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """``distribute_tensor`` of every leaf of ``tree`` by its spec: each rank
    keeps its shard of the tensor it holds whole.  Every rank must hold the
    same tensor, as after ``Model.init`` from one seed: nothing is sent
    (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    return _zip_specs(
        lambda spec, t: distribute_tensor(t, mesh, placements(spec, mesh),
                                          src_data_rank=None),
        specs, tree)


__all__ = ["P", "axis_names", "data_axes", "axis_size", "maybe",
           "param_spec_for", "param_specs", "replicated_specs",
           "adapter_specs", "batch_specs", "batch_axes", "cache_specs",
           "placements", "to_shardings", "shaped", "place"]
