"""LoRA fine-tuning of a transformer LM on synthetic Markov token streams
with the PyTorch port -- the counterpart of ``examples/finetune_lm.py``
and the single-device analogue of ``repro_torch.launch.train``.

Default is the quick ``15m`` preset; ``--preset 100m --steps 300`` trains
the ~100M-parameter model for a few hundred steps.  ``--device`` defaults
to ``cuda`` and raises without a card; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/finetune_lm_torch.py --steps 60
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockSpec, Stage
from repro_torch.data import make_lm_dataset
from repro_torch.kernels import runtime
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map

PRESETS = {
    # name: (layers, d_model, heads, kv, d_ff, vocab)  ~params
    "15m": (4, 256, 8, 4, 1024, 2048),
    "100m": (12, 768, 12, 4, 3072, 16384),
}


def make_cfg(preset: str) -> ArchConfig:
    l, d, h, kv, f, v = PRESETS[preset]
    return ArchConfig(
        name=f"lm-{preset}", arch_type="dense", source="examples",
        d_model=d, n_heads=h, n_kv_heads=kv, head_dim=d // h, d_ff=f,
        vocab_size=v,
        stages=(Stage(unit=(BlockSpec(),), repeat=l),),
        dtype="float32", lora_r_max=32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="15m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = runtime.resolve_device(args.device)
    runtime.full_fp32()
    cfg = make_cfg(args.preset)
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    adapters = model.init_adapters(
        torch.Generator(device=device).manual_seed(1), rank=args.rank)
    n_lora = sum(t.numel() for t in tree_leaves(adapters))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{n_lora / 1e6:.2f}M LoRA params (rank {args.rank})")

    data = make_lm_dataset(cfg.vocab_size, args.seq + 1,
                           n_seqs=args.batch * 64, seed=42)
    factors, ranks = strip_ranks(adapters)
    # the base here is random, not pretrained: train embeddings + head
    # alongside the adapters (standard when no pretrained base exists);
    # all transformer blocks stay frozen + LoRA.
    trainable = (factors, {"embed": params["embed"],
                           "lm_head": params["lm_head"]})
    frozen = {k: v for k, v in params.items()
              if k not in ("embed", "lm_head")}
    opt = adam(args.lr)
    opt_state = opt.init(trainable)

    def step(trainable, opt_state, tokens):
        live = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        f, head = live
        p = dict(frozen)
        p.update(head)
        loss = model.loss(p, attach_ranks(f, ranks), {"tokens": tokens})
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(grads), trainable)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return apply_updates(trainable, updates), opt_state, loss.detach()

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        ix = rng.integers(0, len(data), args.batch)
        tokens = torch.as_tensor(data[ix], dtype=torch.long, device=device)
        trainable, opt_state, loss = step(trainable, opt_state, tokens)
        losses.append(float(loss))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    print(f"finished {args.steps} steps in {time.time() - t0:.1f}s; "
          "loss must be well below ln(vocab) = "
          f"{np.log(cfg.vocab_size):.2f} if LoRA learned the stream")
    return {"losses": losses, "cfg": cfg}


if __name__ == "__main__":
    main()
