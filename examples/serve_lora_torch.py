"""Serve a LoRA-adapted model with the PyTorch port: prefill a prompt
batch, then decode with the KV cache -- the counterpart of
``examples/serve_lora.py``.

Uses a reduced h2o-danube config (SWA ring cache) by default; --arch picks
any of the ten architectures' reduced variant (whisper-large-v3's encoder
runs once in the prefill; phi-3-vision-4.2b's patches come before the
prompt).  ``repro_torch.launch.serve.generate`` runs the prefill and the
greedy decode; throughput is reported as aggregate tokens/sec (batch x
steps) over the decode loop.  ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/serve_lora_torch.py --arch gemma2-9b --new 16

For *multi-tenant adapter* serving (many LoRA ranks, one batched kernel)
see ``repro_torch.serving``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.launch.serve import generate, make_batch
from repro_torch.models.model import make_model


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = runtime.resolve_device(args.device)
    runtime.full_fp32()
    cfg = get_config(args.arch).reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device=device).manual_seed(1), rank=8)

    batch = make_batch(cfg, args.batch, args.prompt_len, device)
    res = generate(model, params, adapters, batch, args.new)
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{res['prefill_s']:.2f}s")
    steps, dt = args.new - 1, res["decode_s"]
    if steps:
        print(f"decoded {steps} steps in {dt:.2f}s: "
              f"{steps * args.batch / max(dt, 1e-9):.1f} tok/s "
              f"({steps / max(dt, 1e-9):.1f} tok/s/seq greedy)")
    gen = res["tokens"]
    print("generated token ids (seq 0):", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
