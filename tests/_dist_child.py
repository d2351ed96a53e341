"""One rank of a ``torch.distributed`` world for ``tests/test_torch_distributed.py``,
``tests/test_torch_moe.py`` (the expert-parallel MoE) and the card tests in
``tests/test_torch_cuda.py``.

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
    raise ValueError(f"unknown case kind {kind!r}")


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
