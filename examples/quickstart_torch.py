"""Quickstart on the PyTorch port: 6 rounds of heterogeneous-rank LoRA
federated learning with RBLA aggregation on a synthetic MNIST analogue --
the counterpart of ``examples/quickstart.py``, same configuration.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain path.  ``--rounds``/``--n-per-class`` shrink the run
(the defaults are the reference's).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.fl import FLConfig, FLHistory, run_simulation
from repro_torch.kernels import runtime

cfg = FLConfig(
    dataset="mnist", model="mlp",
    method="rbla",              # any registered AggregationStrategy name:
                                # "zeropad", "fft", "rbla_ranked",
                                # "rbla_norm", "svd" (see docs/strategies.md)
    rounds=6, n_clients=10,
    n_per_class=200, n_test_per_class=50,
    local_epochs=2, lr=0.05,
    r_max=64,                   # client i gets rank ~ r_max * 0.1 * |labels|
    seed=42,
)


def make_cfg(rounds: int = cfg.rounds,
             n_per_class: int = cfg.n_per_class,
             n_test_per_class: int = cfg.n_test_per_class) -> FLConfig:
    """The quickstart's configuration at the given size."""
    return dataclasses.replace(cfg, rounds=rounds, n_per_class=n_per_class,
                               n_test_per_class=n_test_per_class)


def main(argv=None) -> FLHistory:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=cfg.rounds)
    ap.add_argument("--n-per-class", type=int, default=cfg.n_per_class)
    ap.add_argument("--n-test-per-class", type=int,
                    default=cfg.n_test_per_class)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runtime.full_fp32()
    hist = run_simulation(make_cfg(args.rounds, args.n_per_class,
                                   args.n_test_per_class),
                          verbose=True, device=args.device)
    print("\nper-round test accuracy:",
          " ".join(f"{a:.3f}" for a in hist.test_acc))
    return hist


if __name__ == "__main__":
    main()
