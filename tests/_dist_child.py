"""One rank of a ``torch.distributed`` world for ``tests/test_torch_distributed.py``,
``tests/test_torch_moe.py`` (the expert-parallel MoE),
``tests/test_torch_train.py`` (the training launcher on a test mesh) and the
card tests in ``tests/test_torch_cuda.py``.

    python tests/_dist_child.py INPUTS STORE RANK WORLD OUT [BACKEND DEVICE]

Joins a ``BACKEND`` group (default ``gloo``) through the ``FileStore`` at
``STORE``, runs every case of the pickled ``INPUTS`` (numpy trees made by
the parent from a seed) on ``DEVICE`` (default ``cpu``) through the port's
distributed paths, and writes each case's result leaves and the
collectives it made to ``OUT`` (``.npz``, keys ``case|path``).  Imports the
port only: the parent holds the results against the JAX package.
"""
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import compat, get_strategy  # noqa: E402
from repro_torch.core.distributed import (make_distributed_aggregator,  # noqa: E402
                                          rbla_tree_allreduce)
from repro_torch.core.strategy import stack_trees  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.lora import adapter_masks, set_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(device)


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}|{k}", out)
    else:
        out[prefix] = tree.detach().cpu().float().numpy()


def run_case(case, rank, world, device):
    kind = case["kind"]
    if kind == "agg":           # aggregate_adapters on the whole cohort
        s = get_strategy(case["method"])
        if case.get("options"):
            s = s.with_options(**case["options"])
        ranks = case.get("ranks")
        return s.aggregate_adapters(
            [to_torch(a, device) for a in case["adapters"]],
            to_torch(case["weights"], device), r_max=case["r_max"],
            client_ranks=None if ranks is None else to_torch(ranks, device),
            prev_global=(None if case.get("prev") is None
                         else to_torch(case["prev"], device)),
            backend="distributed")
    if kind == "local_aggregator":   # this rank's slice only
        s = get_strategy(case["method"])
        stacked = stack_trees([to_torch(a, device)
                               for a in case["adapters"]])
        w = s.transform_weights(to_torch(case["weights"], device).float(),
                                to_torch(case["ranks"], device))
        loc = compat.local_slice(int(w.shape[0]), dist.group.WORLD)
        masks = adapter_masks(stacked)
        agg = make_distributed_aggregator(None, "clients", case["method"])
        return agg(tree_map(lambda t: t[loc], stacked),
                   tree_map(lambda m: m if m.ndim == 0 else m[loc], masks),
                   w[loc])
    if kind == "tree_allreduce":     # one client a rank
        server = to_torch(case["server"], device)
        x = torch.as_tensor(case["xs"][rank]).to(device)
        upd = {k: dict(p, A=p["A"] + 0.1 * x.mean()) for k, p in
               set_ranks(server, case["client_ranks"][rank]).items()}
        ad = set_ranks(upd, case["client_ranks"][rank])
        return rbla_tree_allreduce(ad, adapter_masks(ad), 1.0)
    if kind == "mesh":
        from repro_torch.launch.mesh import make_test_mesh
        try:
            mesh = make_test_mesh((2, 2), device=device.type)
        except RuntimeError as e:
            return {"error": str(e)}
        return {"names": list(mesh.mesh_dim_names),
                "sizes": [compat.axis_size(mesh, a) for a in ("data",
                                                              "model")],
                "groups": {a: dist.get_process_group_ranks(
                    compat.client_group(mesh, a)) for a in ("data", "model")}}
    if kind in ("moe_ep", "moe_ep_block"):   # the expert-parallel MoE
        from repro_torch.configs import get_config
        cfg = get_config(case["arch"]).reduced(**case["overrides"])
        p = to_torch(case["params"], device)
        lora = (None if case.get("lora") is None
                else to_torch(case["lora"], device))
        x = torch.as_tensor(case["x"]).to(device)
        if kind == "moe_ep":
            from repro_torch.launch.mesh import make_test_mesh
            from repro_torch.models.moe_ep import moe_forward_ep_wrapped
            mesh = make_test_mesh(tuple(case["mesh"]), device=device.type)
            if case.get("cotangent") is None:
                return {"y": moe_forward_ep_wrapped(p, lora, x, cfg,
                                                    mesh=mesh)}
            # the gradient of <y, cotangent> w.r.t. the params, the LoRA
            # factors and x, which every rank must hold whole
            wrt = {"p": p, "x": x,
                   "lora": {k: {f: v[f] for f in ("A", "B")}
                            for k, v in (lora or {}).items()}}
            leaves = tree_leaves(wrt)
            for t in leaves:
                t.requires_grad_(True)
            y = moe_forward_ep_wrapped(p, lora, x, cfg, mesh=mesh)
            ct = torch.as_tensor(case["cotangent"]).to(device)
            grads = iter(torch.autograd.grad((y * ct).sum(), leaves))
            return {"y": y, "grad": tree_map(lambda _: next(grads), wrt)}
        # a whole block with moe_mode="ep_a2a": the default model mesh
        import dataclasses
        from repro_torch.configs import BlockSpec
        from repro_torch.models.transformer import block_forward
        cfg = dataclasses.replace(cfg, moe_mode="ep_a2a")
        y, _ = block_forward(p, lora, x, cfg, BlockSpec(**case["spec"]),
                             mode="full")
        return {"y": y}
    if kind == "moe_ep_dtensor":     # moe_mode="ep_a2a" on DTensors
        return _moe_ep_dtensor(case, device)
    if kind == "train":         # launch.train's loop on a test mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(tuple(case["mesh"]), device=device.type)
        res = train.train(get_config(case["arch"]).reduced(), mesh,
                          device=device, **case["kw"])
        return {"losses": torch.tensor(res["losses"]),
                "trained": _dictify(res["trained"]),
                "adapters": _dictify(res["adapters"])}
    raise ValueError(f"unknown case kind {kind!r}")


def _moe_ep_dtensor(case, device):
    """The expert-parallel MoE's block call on a (data, model) test mesh of
    DTensors: the params placed by the sharding rules, the ``experts/*``
    factors by expert over "model", the rest of the adapters whole, x's
    batch over "data"; the loss <y, cotangent> and its gradient w.r.t.
    every LoRA factor, whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe_ep import moe_forward_ep_wrapped
    from repro_torch.sharding import P, rules
    cfg = get_config(case["arch"]).reduced(**case["overrides"])
    mesh = make_test_mesh(tuple(case["mesh"]), device=device.type)
    p = rules.place(to_torch(case["params"], device),
                    rules.param_specs(case["params"], mesh), mesh)
    lora = {}
    for k, v in case["lora"].items():
        lora[k] = {}
        for f, t in v.items():
            t = torch.as_tensor(t).to(device)
            split = k.startswith("experts/") and f in ("A", "B")
            lora[k][f] = distribute_tensor(
                t, mesh, rules.placements(
                    P("model" if split else None, *([None] * (t.ndim - 1))),
                    mesh))
    factors = [lora[k][f] for k in lora for f in ("A", "B")]
    for t in factors:
        t.requires_grad_(True)
    x = distribute_tensor(torch.as_tensor(case["x"]).to(device), mesh,
                          (Shard(0), Replicate()))
    runtime.reset_counts()
    if case.get("expect_raise"):     # refused before any collective
        try:
            moe_forward_ep_wrapped(p, lora, x, cfg)
        except ValueError as e:
            return {"raised": torch.tensor(int(case["expect_raise"]
                                               in str(e)))}
        return {"raised": torch.tensor(0)}
    y = moe_forward_ep_wrapped(p, lora, x, cfg)
    fwd = dict(runtime.COLLECTIVES)
    ct = torch.as_tensor(case["cotangent"]).to(device)
    loss = (y.full_tensor() * ct).sum()
    grads = iter(torch.autograd.grad(loss, factors))
    return {"y": y.full_tensor(), "loss": loss.detach(),
            "fwd_all_to_all": torch.tensor(fwd["all_to_all"]),
            "grad": {k: {f: next(grads).full_tensor() for f in ("A", "B")}
                     for k in lora}}


def _dictify(tree):
    """A tree's tuples as dicts keyed by their indices (for :func:`flat`)."""
    if isinstance(tree, dict):
        return {k: _dictify(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return {str(i): _dictify(v) for i, v in enumerate(tree)}
    return tree


def main(argv):
    inputs, store, rank, world, out = argv[:5]
    backend = argv[5] if len(argv) > 5 else "gloo"
    device = torch.device(argv[6] if len(argv) > 6 else "cpu")
    rank, world = int(rank), int(world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    arrays, meta = {}, {}
    try:
        for case in cases:
            runtime.reset_counts()
            got = run_case(case, rank, world, device)
            meta[case["name"]] = {"collectives": dict(runtime.COLLECTIVES),
                                  "launches": {k: v for k, v in
                                               runtime.LAUNCHES.items() if v}}
            if case["kind"] == "mesh":
                meta[case["name"]].update(got)
            else:
                flat(got, case["name"], arrays)
    finally:
        dist.destroy_process_group()
    np.savez(out, **arrays)
    with open(out + ".meta", "wb") as f:
        pickle.dump(meta, f)


if __name__ == "__main__":
    main(sys.argv[1:])
