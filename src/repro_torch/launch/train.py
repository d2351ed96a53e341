"""Training launcher: LoRA fine-tuning of a zoo model on one device, ending
in the cohort's upload through an aggregation strategy.

    python -m repro_torch.launch.train --preset full --steps 20
    python -m repro_torch.launch.train --preset reduced --device cpu \\
        --steps 2 --method rbla --ckpt /path/to/dir

The JAX package's ``repro.launch.train`` loop without its mesh (one
device; ``--multi-pod`` and the sharding rules wait for their own slice):
weights from ``Model.init`` and adapters from ``Model.init_adapters``
(seeds 0 and 1), the factors split from their ranks (``strip_ranks``) and
trained by ``adam(lr)`` on ``make_lm_dataset(vocab, seq + 1, batch * 32,
seed=42)``, each step's rows drawn by ``numpy.random.default_rng(0)``;
each step takes the loss and its gradient with respect to the factors by
``torch.autograd``, then the optimizer's update.  Prints the reference's
``step`` lines.  The run ends like the FLaaS server: the trained adapters
go through ``--method``'s ``aggregate_adapters`` as a cohort of one at
``r_max = rank`` (an rbla upload is one ``packed_agg`` launch on the card);
a strategy that cannot aggregate the layer-stacked pairs (rbla_norm)
raises ``NotImplementedError``, and the unaggregated adapters are kept,
as in the reference.  ``--ckpt`` saves the result with
``repro_torch.checkpoint.save``.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the plain path.

The model is built with ``scan_backend="ref"``: the ``ssd_scan`` kernel
has no backward, so a mamba layer (mamba2-1.3b, jamba) trains through the
plain scan.  The batch holds ``tokens`` only, as in the reference, so the
front-end archs (whisper-large-v3, phi-3-vision-4.2b) fail in
``Model.loss`` with ``KeyError`` for their ``frames`` or ``patches``, as
the reference launcher does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs import get_config
from repro_torch.core.strategy import get_strategy, list_strategies
from repro_torch.data import make_lm_dataset
from repro_torch.kernels import runtime
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map


def make_step(model, params, ranks, opt):
    """One training step over the adapter factors: ``step(factors,
    opt_state, tokens) -> (factors, opt_state, loss)``, the loss
    ``model.loss`` with the frozen ``params`` and the factors' gradient
    from ``torch.autograd``."""
    def step(factors, opt_state, tokens):
        live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
        loss = model.loss(params, attach_ranks(live, ranks),
                          {"tokens": tokens})
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(grads), factors)
        updates, opt_state = opt.update(grads, opt_state, factors)
        return apply_updates(factors, updates), opt_state, loss.detach()
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--method", default="rbla",
                    help="server aggregation strategy for the cohort "
                         f"upload: one of {list_strategies()}")
    ap.add_argument("--agg-backend", default="auto",
                    choices=["auto", "ref", "kernel", "pallas",
                             "distributed"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    strategy = get_strategy(args.method)   # fail fast on typos
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs the production mesh and the sharding rules, "
            "which wait for ROADMAP item 19b-iv's sharding slice")

    device = runtime.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    runtime.full_fp32()
    model = make_model(cfg, remat=args.preset == "full", scan_backend="ref")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device=device).manual_seed(1), rank=args.rank)
    factors, ranks = strip_ranks(adapters)
    opt = adam(args.lr)
    opt_state = opt.init(factors)
    data = make_lm_dataset(cfg.vocab_size, args.seq + 1,
                           n_seqs=args.batch * 32, seed=42)
    step = make_step(model, params, ranks, opt)

    rng = np.random.default_rng(0)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        ix = rng.integers(0, len(data), args.batch)
        tokens = torch.as_tensor(data[ix], dtype=torch.long, device=device)
        factors, opt_state, loss = step(factors, opt_state, tokens)
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    # the pod-side round ends like the FLaaS server: the cohort's adapter
    # upload goes through the registered strategy (one cohort here; the FL
    # simulator drives many).  r_max=args.rank keeps the live rank (and
    # the alpha/rank forward scale) identical to the model just trained
    trained = attach_ranks(factors, ranks)
    try:
        global_adapters = strategy.aggregate_adapters(
            [trained], torch.ones(1, device=device), r_max=args.rank,
            client_ranks=torch.tensor([args.rank], dtype=torch.int32,
                                      device=device),
            backend=args.agg_backend)
        print(f"aggregated cohort upload via strategy={strategy.name} "
              f"backend={args.agg_backend}")
    except NotImplementedError as e:
        # e.g. rbla_norm on layer-stacked pairs: don't lose the run --
        # checkpoint the raw trained adapters instead
        print(f"WARNING: strategy={strategy.name} cannot aggregate this "
              f"adapter structure ({e}); saving unaggregated adapters")
        global_adapters = trained
    _sync(device)
    if args.ckpt:
        ckpt_save(args.ckpt, global_adapters)
        print(f"saved aggregated adapters to {args.ckpt}")
    return {"losses": [float(v) for v in losses], "step_s": step_s,
            "trained": trained, "adapters": global_adapters, "cfg": cfg,
            "rank": args.rank}


if __name__ == "__main__":
    main()
