"""Heterogeneous ranks under the hood, on the PyTorch port: Alg. 2
slicing, delta masks, and the difference between zero-padding and RBLA on
a single adapter; FLoRA's stacking; then the same RBLA aggregation as a
collective over 8 ranks.

    PYTHONPATH=src python examples/heterogeneous_ranks_torch.py
    PYTHONPATH=src python examples/heterogeneous_ranks_torch.py --device cpu

The counterpart of ``examples/heterogeneous_ranks.py``.  On the card
(the default) the FLoRA round launches the stack kernel, and the last
section spawns 8 gloo ranks on the one card (CUDA tensors, as NCCL
refuses two ranks on one device), each reducing its own client through
``make_distributed_aggregator``'s ``all_reduce``; the result is held
against the host's ``rbla_leaf`` at rtol 1e-5, atol 1e-6, as the
reference's shard_map psum is.  ``--device cpu`` runs all of it on the
CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

R_MAX, FAN_IN, FAN_OUT = 8, 16, 12
N_CLIENTS = 8
RANK_TIMEOUT = 300          # seconds, each spawned rank


def _cohort():
    """The reference's single-adapter cohort from ``default_rng(42)``:
    staircase-free random ranks, rows of mean ~1 where live."""
    from repro_torch.core import stacked_rank_masks
    rng = np.random.default_rng(42)
    ranks = torch.as_tensor(rng.integers(1, R_MAX + 1, N_CLIENTS),
                            dtype=torch.int32)
    masks = stacked_rank_masks(R_MAX, ranks)[:, :, None]
    stacked = torch.as_tensor(rng.normal(size=(N_CLIENTS, R_MAX, FAN_IN)),
                              dtype=torch.float32) * masks + masks
    return ranks, masks, stacked


def _rank(rank: int, world: int, store: str, src: str, out: str,
          device: str) -> None:
    """One rank of the collective: its client's slice, reduced with every
    rank's in one ``all_reduce``; rank 0 saves the result."""
    import torch.distributed as dist
    from repro_torch.core import compat, get_strategy
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    stacked, masks, w = (t.to(dev) for t in torch.load(src))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        loc = compat.local_slice(int(w.shape[0]), dist.group.WORLD)
        agg = get_strategy("rbla").make_distributed_aggregator(
            None, client_axis="clients")
        got = agg(stacked[loc], torch.broadcast_to(masks, stacked.shape)[loc],
                  w[loc])
        if rank == 0:
            torch.save(got.cpu(), out)
        dist.barrier()      # no rank tears its group down under a peer
    finally:
        dist.destroy_process_group()


def collective(stacked, masks, w, device: str, world: int = N_CLIENTS):
    """The rbla aggregate of the cohort over ``world`` spawned gloo ranks
    on ``device``; rank 0's result on the CPU."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "cohort.pt"), os.path.join(tmp, "out.pt")
        torch.save((stacked.cpu(), masks.cpu(), w.cpu()), src)
        procs = [ctx.Process(target=_rank, args=(k, world,
                                                 os.path.join(tmp, "store"),
                                                 src, out, device))
                 for k in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"collective: rank exit codes {codes}")
        return torch.load(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.core import get_strategy, rbla_leaf, zeropad_leaf
    from repro_torch.kernels import runtime
    from repro_torch.lora import init_adapters, init_pair, set_ranks
    from repro_torch.tree import tree_map
    device = runtime.resolve_device(args.device)

    print("== Alg. 2: clients slice the server adapter to their rank ==")
    server_pair = init_pair(torch.Generator(device=device).manual_seed(0),
                            FAN_OUT, FAN_IN, R_MAX, R_MAX)
    live = {}
    for rank in (2, 5, 8):
        client = set_ranks(server_pair, rank)
        live[rank] = int((client["A"].abs().sum(-1) > 0).sum())
        print(f"  client rank {rank}: live A rows = {live[rank]}/{R_MAX}")

    print("\n== zero-padding dilution vs RBLA preservation (paper Sec. 3) ==")
    ranks, masks, stacked = _cohort()
    ranks, masks, stacked = (t.to(device) for t in (ranks, masks, stacked))
    w = torch.ones(N_CLIENTS, device=device)
    zp = zeropad_leaf(stacked, masks, w)
    rb = rbla_leaf(stacked, masks, w)
    owners = masks[:, :, 0].sum(0)
    for row in range(R_MAX):
        print(f"  row {row}: owners={int(owners[row])}  "
              f"|zp|={float(zp[row].abs().mean()):.3f}  "
              f"|rbla|={float(rb[row].abs().mean()):.3f}")
    print("  (zero-padding shrinks scarce rows by owners/n; RBLA does not)")

    print("\n== FLoRA stacking: rank-growing, noise-free aggregation ==")
    # the flora strategy concatenates client factors instead of averaging
    # rows: the served update is *exactly* the convex combination of the
    # clients' effective updates, at the price of a growing global rank
    specs = {"fc": (FAN_OUT, FAN_IN)}
    cranks = (2, 3, 5)
    cohort = []
    for i, r in enumerate(cranks):
        ad = init_adapters(torch.Generator(device=device).manual_seed(3 + i),
                           specs, R_MAX, r)
        ad = tree_map(lambda x: x + 0.1 if x.is_floating_point() else x,
                      ad)           # randomize B too (it inits to zero)
        cohort.append(set_ranks(ad, r))
    flora = get_strategy("flora").with_options(stack_r_cap=32)
    wf = torch.ones(len(cohort), device=device)
    cr = torch.tensor(cranks, dtype=torch.int32, device=device)
    runtime.reset_counts()
    glob = flora.aggregate_adapters(cohort, wf, r_max=R_MAX, client_ranks=cr)
    flora_launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
    g_rank = int(glob["fc"]["rank"])
    print(f"  client ranks {cranks} -> stacked global rank {g_rank} "
          f"(storage {glob['fc']['A'].shape[-2]}); launches "
          f"{flora_launches or 'none (plain version on the CPU)'}")
    eff = (glob["fc"]["B"] @ glob["fc"]["A"]) / g_rank
    want = sum((c["fc"]["B"] @ c["fc"]["A"]) / r
               for c, r in zip(cohort, cranks)) / len(cohort)
    flora_diff = float((eff - want).abs().max())
    print(f"  served update == mean client update: max |diff| = "
          f"{flora_diff:.2e}  (stacking is noise-free)")
    nxt = flora.aggregate_adapters(cohort, wf, r_max=R_MAX, client_ranks=cr,
                                   prev_global=glob)
    print(f"  next round stacks the previous global as one more "
          f"contributor: rank {g_rank} -> {int(nxt['fc']['rank'])}")
    capped = flora.with_options(stack_r_cap=R_MAX).aggregate_adapters(
        cohort, wf, r_max=R_MAX, client_ranks=cr)
    print(f"  with stack_r_cap={R_MAX} the same cohort SVD-reprojects back "
          f"to rank {int(capped['fc']['rank'])}")

    print("\n== the same aggregation as a pod-level collective ==")
    # every registered mean strategy carries its own distributed path:
    # masked partial sums a rank, one all_reduce over the ranks
    out = collective(stacked, masks, w, str(device))
    np.testing.assert_allclose(out.numpy(), rb.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    coll_diff = float((out - rb.cpu()).abs().max())
    print(f"  masked all_reduce over {N_CLIENTS} gloo ranks on {device} "
          f"matches the host result (max |diff| = {coll_diff:.2e})")
    return {"live_rows": live, "zp": zp.cpu(), "rbla": rb.cpu(),
            "stacked": stacked.cpu(), "masks": masks.cpu(),
            "flora_rank": g_rank, "flora_diff": flora_diff,
            "flora_launches": flora_launches,
            "next_rank": int(nxt["fc"]["rank"]),
            "capped_rank": int(capped["fc"]["rank"]),
            "collective": out, "collective_diff": coll_diff}


if __name__ == "__main__":
    main()
