"""Distributed RBLA: the paper's server loop as ``torch.distributed``
collectives.

Alg. 1 in the paper is a Python ``for`` over clients and layers on one
server.  In FLaaS at scale the clients of a round are spread over the
ranks of a *client axis*, and aggregation becomes a sum over that axis of
masked numerators and owner-mass denominators: no rank ever holds
``n_clients`` copies of a reduced leaf.

The method-specific math lives in ``repro_torch.core.strategy`` (and the
mean family's collective round in ``repro_torch.core.plan``); this module
is the thin veneer the JAX package's ``repro.core.distributed`` is.

**The SPMD contract.**  The JAX package has one controller that traces a
``shard_map`` body for a mesh; the port has one process a rank, and every
rank runs the same program.  A mesh is a ``DeviceMesh`` (``repro_torch
.launch.mesh``) and a mesh axis its process group (``repro_torch.core
.compat``).  With no mesh the paths reduce over the default process group
(``plan.default_client_mesh``), and with no process group initialised over
this process alone, calling no collective.

* ``aggregate_adapters(..., backend="distributed")`` (and ``aggregate``,
  ``run_simulation``, ``AsyncAggregator``): every rank is given the whole
  cohort, as the JAX package's caller is.  Each rank reduces a contiguous
  slice of the clients, as even as ``n`` allows (``compat.client_slices``:
  a rank may hold none), and every rank returns the same aggregate.  The
  mean family's round is one ``all_reduce`` of one fp32 buffer; flora and
  svd ``all_gather`` the slices (padded to the largest, the padding
  dropped) and finish replicated.  This differs from the JAX package's
  mesh, which takes the largest device count dividing ``n``, only in which
  partial sums are formed: the result depends on the world size by
  summation order alone.  Weights are transformed (rbla_ranked) once, on
  the whole cohort, before the collective; a rank never sees another
  rank's ranks unless it gathers them (svd).
* :func:`make_distributed_aggregator`: the callable takes **this rank's
  clients only** -- a stacked tree ``(n_local, ...)``, its masks, and
  weights already transformed.
* :func:`rbla_allreduce` / :func:`rbla_tree_allreduce`: one client a rank.

Reductions run in fp32 and the outputs take the leaf's dtype.  A
collective runs on the tensors where they lie (a CUDA tensor goes to the
backend as a CUDA tensor) and its failure propagates; every call is
counted in ``repro_torch.kernels.runtime.COLLECTIVES``.  rbla_norm and the
robust family have no distributed path and raise ``NotImplementedError``
naming the method.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map

from .strategy import get_strategy

PyTree = Any


def rbla_allreduce(local: torch.Tensor, mask, weight, mesh=None,
                   client_axis: str = "clients",
                   method: str = "rbla") -> torch.Tensor:
    """Aggregate this rank's one-client leaf with its peers over
    ``client_axis`` of ``mesh``.

    Eq. 7 as one all-reduce of the numerator and its denominator:
        C = sum(w * m * x) / sum(w * m)            (rbla)
        C = sum(w * m * x) / sum(w)                (zeropad baseline)

    Dispatches on the strategy registry; any registered strategy with a
    distributed path works."""
    return get_strategy(method).allreduce_leaf(local, mask, weight, mesh,
                                               client_axis)


def rbla_tree_allreduce(local_tree: PyTree, mask_tree: PyTree, weight,
                        mesh=None, client_axis: str = "clients",
                        method: str = "rbla") -> PyTree:
    """Tree version of :func:`rbla_allreduce` (one collective a leaf; a 0-d
    mask means a fully shared leaf)."""
    strategy = get_strategy(method)
    return tree_map(
        lambda x, m: strategy.allreduce_leaf(
            x, None if (m is not None and m.ndim == 0) else m, weight,
            mesh, client_axis),
        local_tree, mask_tree)


def make_distributed_aggregator(mesh, client_axis: str = "data",
                                method: str = "rbla"):
    """``get_strategy(method).make_distributed_aggregator(mesh,
    client_axis)``: a callable over this rank's clients only."""
    return get_strategy(method).make_distributed_aggregator(mesh,
                                                            client_axis)


__all__ = ["rbla_allreduce", "rbla_tree_allreduce",
           "make_distributed_aggregator"]
