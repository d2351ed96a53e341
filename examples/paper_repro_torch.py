"""End-to-end driver on the PyTorch port: the paper's experiment (Table 1 /
Figs 5-10 analogue) -- the counterpart of ``examples/paper_repro.py``, same
CLI and configurations, plus ``--device``.

Trains the global model with federated LoRA across 10 staircase-non-IID
clients until target accuracy (or --rounds), for each requested
aggregation method, and prints the rounds-to-target comparison and each
method's best accuracy.  ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the plain path.

    PYTHONPATH=src python examples/paper_repro_torch.py \
        --dataset mnist --model mlp --rounds 50 --target 0.95

The full-participation + random-20% pair reproduces the paper's left/right
subfigures.  Seed fixed to 42 like the paper.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.fl import FLConfig, run_simulation
from repro_torch.kernels import runtime


def make_cfg(method: str, *, dataset: str = "mnist", model: str = "mlp",
             rounds: int = 30, n_per_class: int = 400,
             participation: float = 1.0, lr: float | None = None
             ) -> FLConfig:
    """One method's configuration, as the reference driver builds it."""
    opt = "adam" if dataset in ("cifar", "cinic") else "sgd"
    # 0.05: lr 0.1 diverges for the FFT baseline under the staircase
    lr = lr or (1e-3 if opt == "adam" else 0.05)
    return FLConfig(dataset=dataset, model=model, method=method,
                    rounds=rounds, n_per_class=n_per_class,
                    n_test_per_class=max(50, n_per_class // 4),
                    local_epochs=2, optimizer=opt, lr=lr,
                    participation=participation, seed=42)


def main(argv=None) -> dict:
    """Returns ``{method: {"rounds_to_target", "best", "test_acc",
    "round_time_s", "wall_s"}}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "fmnist", "cifar", "cinic"])
    ap.add_argument("--model", default="mlp",
                    choices=["mlp", "cnn_mnist", "cnn_cifar"])
    ap.add_argument("--methods", default="rbla,zeropad,fft",
                    help="comma-separated registered strategy names "
                         "(see repro_torch.core.list_strategies(); e.g. "
                         "add rbla_ranked,rbla_norm,svd)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--target", type=float, default=0.90)
    ap.add_argument("--n-per-class", type=int, default=400)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runtime.full_fp32()

    summary = {}
    for method in args.methods.split(","):
        cfg = make_cfg(method, dataset=args.dataset, model=args.model,
                       rounds=args.rounds, n_per_class=args.n_per_class,
                       participation=args.participation, lr=args.lr)
        print(f"=== {method} ===")
        t0 = time.perf_counter()
        hist = run_simulation(cfg, verbose=True, device=args.device)
        summary[method] = {"rounds_to_target":
                           hist.rounds_to_target(args.target),
                           "best": max(hist.test_acc),
                           "test_acc": list(hist.test_acc),
                           "round_time_s": list(hist.round_time_s),
                           "wall_s": time.perf_counter() - t0}

    print(f"\nrounds to reach {args.target:.0%} "
          f"({args.dataset}/{args.model}, "
          f"participation={args.participation}):")
    for method, res in summary.items():
        r2t, best = res["rounds_to_target"], res["best"]
        print(f"  {method:>10s}: "
              f"{r2t if r2t else f'N/A (best {best:.4f})'}")
    print("best accuracy:")
    for method, res in summary.items():
        print(f"  {method:>10s}: {res['best']:.4f}")
    return summary


if __name__ == "__main__":
    main()
