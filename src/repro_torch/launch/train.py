"""Training launcher: LoRA fine-tuning of a zoo model on a mesh, ending in
the cohort's upload through an aggregation strategy.

    python -m repro_torch.launch.train --preset full --steps 20
    python -m repro_torch.launch.train --preset reduced --device cpu \\
        --steps 2 --method rbla --ckpt /path/to/dir
    torchrun --nproc-per-node 256 -m repro_torch.launch.train --preset full

The JAX package's ``repro.launch.train`` loop.  The mesh follows the
reference's rule (``launch.mesh.launcher_mesh``): ``--preset reduced`` a
``(1, 1)`` test mesh, ``--preset full`` the ``(16, 16)`` production mesh,
``--multi-pod`` the ``(2, 16, 16)`` one, each raising without the ranks it
needs.  One deliberate difference: with no ``torch.distributed`` group
initialised (a plain ``python -m``), both presets run on this process's
one device, the reference's ``(1, 1)`` mesh, with nothing placed, and the
full preset prints the mesh it uses.  On a mesh (:func:`train`) the
weights are placed by ``rules.param_specs``, the adapter factors and the
Adam state replicated, each batch split over the data axes by
``rules.batch_specs``, and each step runs under ``implicit_replication``
(the model's own constants, positions and RoPE angles, are replicated);
the factors' gradients are reduced to the factors' placement before the
update, the reference's psum.

Weights from ``Model.init`` and adapters from ``Model.init_adapters``
(seeds 0 and 1), the factors split from their ranks (``strip_ranks``) and
trained by ``adam(lr)`` on ``make_lm_dataset(vocab, seq + 1, batch * 32,
seed=42)``, each step's rows drawn by ``numpy.random.default_rng(0)``;
each step takes the loss and its gradient with respect to the factors by
``torch.autograd``, then the optimizer's update.  Prints the reference's
``step`` lines (rank 0 only).  The run ends like the FLaaS server: the
trained factors' full tensors go through ``--method``'s
``aggregate_adapters`` as a cohort of one at ``r_max = rank`` (an rbla
upload is one ``packed_agg`` launch on the card); a strategy that cannot
aggregate the layer-stacked pairs (rbla_norm) raises
``NotImplementedError``, and the unaggregated adapters are kept, as in the
reference.  ``--ckpt`` saves the result with
``repro_torch.checkpoint.save`` (rank 0 only).  ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain path.

The model is built with ``scan_backend="ref"``: the ``ssd_scan`` kernel
has no backward, so a mamba layer (mamba2-1.3b, jamba) trains through the
plain scan.  The batch holds ``tokens`` only, as in the reference, so the
front-end archs (whisper-large-v3, phi-3-vision-4.2b) fail in
``Model.loss`` with ``KeyError`` for their ``frames`` or ``patches``, as
the reference launcher does.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs import get_config
from repro_torch.core.strategy import get_strategy, list_strategies
from repro_torch.data import make_lm_dataset
from repro_torch.kernels import runtime
from repro_torch.launch.mesh import describe, launcher_mesh
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models.model import make_model
from repro_torch.obs import trace_span
from repro_torch.optim import adam, apply_updates
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map


def _like(grad, factor):
    """A DTensor gradient in its factor's placement (a partial sum reduced
    over the ranks that hold parts of it); a plain one as it is."""
    if isinstance(grad, DTensor):
        return grad.redistribute(factor.device_mesh, factor.placements)
    return grad


def full(t):
    """A DTensor's whole tensor; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_step(model, params, ranks, opt):
    """One training step over the adapter factors: ``step(factors,
    opt_state, tokens) -> (factors, opt_state, loss)``, the loss
    ``model.loss`` with the frozen ``params`` and the factors' gradient
    from ``torch.autograd``, in the factors' placement on a mesh.  Traced
    as ``train.step`` around ``train.forward`` (the loss),
    ``train.backward`` (the gradient, a remat's recompute included) and
    ``train.optimizer`` (the update and its application), each with its
    device time."""
    def step(factors, opt_state, tokens):
        dev = tokens.device
        with trace_span("train.step", device=dev):
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            factors)
            with trace_span("train.forward", device=dev):
                loss = model.loss(params, attach_ranks(live, ranks),
                                  {"tokens": tokens})
            with trace_span("train.backward", device=dev):
                grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
                grads = tree_map(lambda f: _like(next(grads), f), factors)
            with trace_span("train.optimizer", device=dev):
                updates, opt_state = opt.update(grads, opt_state, factors)
                factors = apply_updates(factors, updates)
            return factors, opt_state, loss.detach()
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def train(cfg, mesh=None, *, steps: int = 20, batch: int = 4, seq: int = 128,
          rank: int = 8, lr: float = 1e-3, method: str = "rbla",
          agg_backend: str = "auto", device="cuda", remat=False,
          ckpt: str = "") -> dict:
    """The launcher's loop on ``mesh`` (a ``DeviceMesh`` over every rank of
    the default group, or None: this process's one device, nothing
    placed): ``steps`` steps, then the cohort upload.  Every rank runs it
    alike.  Returns the losses, each step's host seconds (each ending in a
    synchronise), the trained adapters and the uploaded aggregate (whole
    tensors on this rank's device), the config and the rank."""
    strategy = get_strategy(method)   # fail fast on typos
    device = runtime.resolve_device(device)
    runtime.full_fp32()
    model = make_model(cfg, remat=remat, scan_backend="ref")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device=device).manual_seed(1), rank=rank)
    factors, ranks = strip_ranks(adapters)
    if mesh is not None:
        params = rules.place(params, rules.param_specs(params, mesh), mesh)
        factors = rules.place(factors, rules.replicated_specs(factors), mesh)
    opt = adam(lr)
    opt_state = opt.init(factors)
    data = make_lm_dataset(cfg.vocab_size, seq + 1, n_seqs=batch * 32,
                           seed=42)
    step = make_step(model, params, ranks, opt)
    on_mesh = (implicit_replication if mesh is not None
               else contextlib.nullcontext)

    rng = np.random.default_rng(0)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        ix = rng.integers(0, len(data), batch)
        tokens = torch.as_tensor(data[ix], dtype=torch.long, device=device)
        if mesh is not None:
            tokens = rules.place(tokens, rules.batch_specs(tokens, mesh),
                                 mesh)
        with on_mesh():
            factors, opt_state, loss = step(factors, opt_state, tokens)
            loss = full(loss)
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if i % max(1, steps // 10) == 0 and _lead():
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    # the pod-side round ends like the FLaaS server: the cohort's adapter
    # upload goes through the registered strategy (one cohort here; the FL
    # simulator drives many).  r_max=rank keeps the live rank (and the
    # alpha/rank forward scale) identical to the model just trained
    trained = attach_ranks(tree_map(full, factors), ranks)
    try:
        global_adapters = strategy.aggregate_adapters(
            [trained], torch.ones(1, device=device), r_max=rank,
            client_ranks=torch.tensor([rank], dtype=torch.int32,
                                      device=device),
            backend=agg_backend)
        if _lead():
            print(f"aggregated cohort upload via strategy={strategy.name} "
                  f"backend={agg_backend}")
    except NotImplementedError as e:
        # e.g. rbla_norm on layer-stacked pairs: don't lose the run --
        # checkpoint the raw trained adapters instead
        if _lead():
            print(f"WARNING: strategy={strategy.name} cannot aggregate this "
                  f"adapter structure ({e}); saving unaggregated adapters")
        global_adapters = trained
    _sync(device)
    if ckpt and _lead():
        ckpt_save(ckpt, global_adapters)
        print(f"saved aggregated adapters to {ckpt}")
    return {"losses": [float(v) for v in losses], "step_s": step_s,
            "trained": trained, "adapters": global_adapters, "cfg": cfg,
            "rank": rank}


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
    get_strategy(args.method)   # fail fast on typos
    device = runtime.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    mesh = launcher_mesh(args.preset, args.multi_pod, device.type)
    if args.preset == "full" and _lead():
        print(describe(mesh, device), flush=True)
    return train(cfg, mesh, steps=args.steps, batch=args.batch,
                 seq=args.seq, rank=args.rank, lr=args.lr,
                 method=args.method, agg_backend=args.agg_backend,
                 device=device, remat=args.preset == "full", ckpt=args.ckpt)


if __name__ == "__main__":
    main()
