"""Expert-parallel MoE dispatch with explicit all-to-all (``moe_mode=
"ep_a2a"``) on ``torch.distributed``.

The JAX package's ``repro.models.moe_ep`` runs GShard-style expert
parallelism inside a ``shard_map`` over ``(data..., model)``.  Here every
rank runs the program (SPMD, one process a rank) and the mesh's ``model``
axis is a process group (``repro_torch.launch.mesh``,
``core.compat``):

  1. each rank routes its own tokens into per-expert capacity slots (E
     experts, ``cap`` slots each, as one routing group);
  2. ``all_to_all`` over the model group swaps the expert dimension for
     the rank dimension: each rank receives the slots of ITS ``E / ep``
     experts from every model peer, ``(E / ep, ep * cap, d)``;
  3. the local experts' matmuls;
  4. the inverse ``all_to_all`` returns the outputs to the tokens' owners.

So a rank's result is the sort path's (``moe.moe_forward``) for a routing
group of its own tokens: over a world, the sort path with one group a rank.
Autograd runs through both collectives (``core.compat``).  The gradients
of :func:`moe_forward_ep` are this rank's tokens' share; the wrapped form
sums them over the world (``compat.replicated``), so that, as under the
reference's pjit, every rank gets the whole gradient of a loss every rank
computes alike.  Each collective, forward and backward, is counted in
``runtime.COLLECTIVES``.  Without a process group (``group=None``, or no
group initialised for the wrapped form) this is a world of one: no
collective is called.

Restrictions (raised): the expert count divisible by the model group's
size; the batch divisible by the mesh's size.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.core import compat
from repro_torch.tree import tree_leaves, tree_map

from .common import norm
from .moe import (combine, dispatch, expert_capacity, experts_forward, route,
                  shared_and_norm)

#: the mesh axis the experts are split over, as in the reference
MODEL_AXIS = "model"


def moe_forward_ep(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg,
                   *, group=None, alpha: float = 16.0) -> torch.Tensor:
    """One rank's part: ``x`` is this rank's tokens (b_local, s, d) and the
    expert kernels in ``p`` (and the ``experts/*`` LoRA pairs in ``lora``)
    this rank's ``E / ep`` experts; ``group`` is the mesh's model group
    (None: a world of one).  The gradients it gives ``p`` and ``lora`` are
    partial sums, from this rank's tokens (and, for its experts, from the
    tokens its model peers sent): the caller sums them over the world."""
    lora = lora or {}
    ep = compat.axis_size(group) if group is not None else 1
    e = cfg.n_experts + cfg.moe_pad_experts
    if e % ep:
        raise ValueError(f"moe_forward_ep: {e} experts do not divide over "
                         f"{ep} model ranks")
    e_local = e // ep
    b, s, d = x.shape
    n = b * s
    cap = expert_capacity(cfg, n)

    h = norm(p["ln"], x, cfg.norm_eps)
    flat = h.reshape(1, n, d)
    # router weights are replicated; logits over ALL experts
    logits = torch.einsum("gnd,de->gne", flat.float(), p["router"]["w"])
    w, ix = route(cfg, logits)                        # (1, n, k)
    einp, plan = dispatch(flat, ix, e, cap)           # (1, e, cap, d)

    # to the experts' owners: chunk j of the expert axis goes to model rank
    # j; what peer j sent lands in columns [j * cap, (j + 1) * cap)
    got = compat.all_to_all(einp[0], group)           # (ep * e_local, ...)
    einp = got.reshape(ep, e_local, cap, d).transpose(0, 1).reshape(
        1, e_local, ep * cap, d)
    eo = experts_forward(p["experts"], lora, einp, alpha)
    # back to the tokens' owners: columns [j * cap, (j + 1) * cap) to peer j
    send = eo[0].reshape(e_local, ep, cap, d).transpose(0, 1)
    eo = compat.all_to_all(send.reshape(e, cap, d), group)
    y = combine(eo[None], w, plan, n)
    return shared_and_norm(p, lora, y.reshape(n, d), flat.reshape(n, d),
                           (b, s, d), cfg, alpha)


def _model_slice(t: torch.Tensor, j: int, e_local: int) -> torch.Tensor:
    return t[j * e_local:(j + 1) * e_local]


def moe_forward_ep_wrapped(p: Mapping, lora: Mapping | None,
                           x: torch.Tensor, cfg, alpha: float = 16.0, *,
                           mesh=None):
    """The block's call: ``p``, ``lora`` and ``x`` (B, S, d) are whole, as
    on every rank of the reference's pjit program.  Each rank takes its
    token slice -- batch rows split over every rank of ``mesh``, in mesh
    order with the ``"model"`` axis last (the reference's ``P((data...,
    "model"))``) -- and its ``E / ep`` experts along ``"model"``, runs
    :func:`moe_forward_ep`, and the slices are gathered back so that every
    rank returns the whole (B, S, d).  Under autograd, the gradient of
    every input that needs one is summed over the world in the backward
    (``compat.replicated``): each rank then holds the whole gradient of a
    loss that every rank computes alike from the whole output.

    ``mesh=None`` takes the 1-D ``"model"`` mesh over the default
    process group (``compat.default_mesh``), or, with no group
    initialised, a world of one (no collective)."""
    if mesh is None:
        mesh = compat.default_mesh(MODEL_AXIS)
    if mesh is None:
        return moe_forward_ep(p, lora, x, cfg, alpha=alpha)
    names = tuple(mesh.mesh_dim_names)
    perm = ([i for i, a in enumerate(names) if a != MODEL_AXIS]
            + [names.index(MODEL_AXIS)])
    by_chunk = mesh.mesh.permute(perm).flatten().tolist()
    if sorted(by_chunk) != list(range(dist.get_world_size())):
        raise ValueError("moe_forward_ep_wrapped: the mesh must hold every "
                         "rank of the default group")
    chunk = by_chunk.index(dist.get_rank())
    n_chunks = len(by_chunk)
    b = x.shape[0]
    if b % n_chunks:
        raise ValueError(f"moe_forward_ep_wrapped: batch {b} does not split "
                         f"over the mesh's {n_chunks} ranks")
    bl = b // n_chunks
    summed = iter(compat.replicated(tree_leaves((p, lora, x)),
                                    dist.group.WORLD))
    p, lora, x = tree_map(lambda _: next(summed), (p, lora, x))
    group = mesh.get_group(MODEL_AXIS)
    ep = compat.axis_size(group)
    e_local = (cfg.n_experts + cfg.moe_pad_experts) // ep
    j = mesh.get_local_rank(MODEL_AXIS)
    p_local = dict(p, experts={
        k: {"w": _model_slice(v["w"], j, e_local)}
        for k, v in p["experts"].items()})
    lora_local = {
        k: (dict(v, A=_model_slice(v["A"], j, e_local),
                 B=_model_slice(v["B"], j, e_local))
            if k.startswith("experts/") else v)
        for k, v in (lora or {}).items()}
    y = moe_forward_ep(p_local, lora_local, x[chunk * bl:(chunk + 1) * bl],
                       cfg, group=group, alpha=alpha)
    # every rank's slice, in chunk order
    outs = compat.all_gather_equal(y, dist.group.WORLD)
    return outs[by_chunk].flatten(0, 1)


__all__ = ["moe_forward_ep", "moe_forward_ep_wrapped"]
