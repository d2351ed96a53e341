"""Serving launcher: batched prefill, then greedy decode.

    python -m repro_torch.launch.serve --preset full --prompt-len 2048
    python -m repro_torch.launch.serve --arch mamba2-1.3b --preset full \\
        --batch 4 --prompt-len 2048 --new 16 --rank 8

The JAX package's ``repro.launch.serve`` path.  Its mesh follows the
training launcher's rule (``launch.mesh.launcher_mesh``: a ``(1, 1)`` test
mesh for the reduced preset, the ``(16, 16)`` production mesh for the full
one under a process group, this process's one device without a group),
and ``generate`` runs within it; like the reference, nothing is placed by
the rules, so every rank serves the whole batch.  Weights from
``Model.init`` and adapters from ``Model.init_adapters`` (seeds 0 and 1),
then from one ``numpy.random.default_rng(0)``, in the reference's order,
random prompt tokens, an encoder-decoder's ``frames`` (batch,
encoder_seq, frontend_dim) and a VLM's ``patches`` (batch,
n_prefix_tokens, frontend_dim); one prefill into KV caches of
``prompt_len + new + n_prefix`` slots, then ``new - 1`` decode steps each
feeding back the argmax token at position ``prompt_len + n_prefix + i``.
Prints the reference's ``prefill:`` and ``decode:`` lines.  ``--arch``
defaults to the reference's ``h2o-danube-3-4b`` and takes all ten archs:
the dense GQA ones (also ``yi-34b``, ``chatglm3-6b``, ``gemma2-9b``),
``mamba2-1.3b``, the MoE archs (``granite-moe-3b-a800m``;
``jamba-1.5-large-398b``, whose mamba layers launch ``ssd_scan``;
``deepseek-v3-671b``, MLA with a latent cache), ``whisper-large-v3``
(the encoder runs once in the prefill, whose caches keep its keys and
values) and ``phi-3-vision-4.2b`` (576 patches before the prompt).  At a
full config's ``capacity_factor`` (1.25) a prompt's capacity can drop
tokens that a one-token decode step keeps.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.model import Model, make_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(cfg, batch: int, prompt_len: int, device) -> dict:
    """The reference's serving batch from ``default_rng(0)``: tokens, then
    an encoder-decoder's ``frames``, then a VLM's ``patches`` (fp32)."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(batch, cfg.encoder_seq,
                                         cfg.frontend_dim))
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(size=(batch, cfg.n_prefix_tokens,
                                          cfg.frontend_dim))
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else torch.float32, device=device)
            for k, v in out.items()}


def generate(model: Model, params, adapters, batch: dict, new: int) -> dict:
    """Prefill ``batch`` (the prompt ``tokens`` (B, S), with an
    encoder-decoder's ``frames`` or a VLM's ``patches``), then ``new - 1``
    greedy decode steps.

    The prefill's KV caches have ``S + new + n_prefix`` slots (a mamba
    model has none), and decode positions count the VLM's ``n_prefix``
    patches.  Returns the generated tokens (B, new) -- the prefill's
    argmax first -- the prefill's last-position logits, the last step's
    logits, the caches after the last step and the host seconds of the
    prefill and the decode loop (each ending in a synchronise)."""
    tokens = batch["tokens"]
    device = tokens.device
    prompt_len = tokens.shape[1]
    n_prefix = model.n_prefix
    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        prefill_logits, caches = model.prefill(
            params, adapters, batch, capacity=prompt_len + new + n_prefix)
        tok = prefill_logits.argmax(-1)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        out, logits = [tok], prefill_logits
        t0 = time.perf_counter()
        for i in range(new - 1):
            logits, caches = model.decode_step(params, adapters, caches, tok,
                                               prompt_len + n_prefix + i)
            tok = logits.argmax(-1)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out, 1), "prefill_logits": prefill_logits,
            "logits": logits, "caches": caches, "prefill_s": prefill_s,
            "decode_s": decode_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = runtime.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    mesh = launcher_mesh(args.preset, device=device.type)
    runtime.full_fp32()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device=device).manual_seed(1), rank=args.rank)
    batch = make_batch(cfg, args.batch, args.prompt_len, device)

    with mesh if mesh is not None else contextlib.nullcontext():
        res = generate(model, params, adapters, batch, args.new)
    print(f"prefill: {res['prefill_s']:.2f}s")
    steps = args.new - 1
    print(f"decode: {steps} steps, "
          f"{steps * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s")
    return res


if __name__ == "__main__":
    main()
