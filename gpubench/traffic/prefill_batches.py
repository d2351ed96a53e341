"""Traffic driver ``prefill_batches``: serving the global adapter on a
zoo model, closed-loop batches of prompts through ``Model.prefill``.

The benchmark makes the model's weights (in the configuration's dtype),
one adapter tree at ``adapter_rank`` of ``r_max`` and a pool of ``pool``
batches of ``batch`` bigram prompts of ``seq`` tokens on the device from
the seed.  The window prefills the pool's batches in turn, back to back,
with ``scan_backend`` as the workload sets it (``"auto"``: the port's
``ssd_scan`` kernel), under ``torch.inference_mode``, as
``repro_torch.launch.serve.generate`` does; each prefill ends in a
synchronise.

End-to-end, host clock: ``prefill_tokens_per_s``, every prompt token
prefilled in the window over the time from its first prefill's start to
its last one's end (a prefill that straddles the deadline is finished and
counted).  The check compares the last-position logits of prefills of
the window drawn from the seed (the first always) with the reference's,
prompt by prompt.

The configuration names its plain reference (``"reference"``, a module
of ``gpubench/reference/`` with ``adapter_pairs`` and ``last_logits``)
and its prefill's count (``"counts"["prefill"]``, a module of
``gpubench/counts/`` with ``prefill_flops``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.lib import cell as C
from gpubench.lib import program, seeded, spec
from gpubench.lib import trace as tr
from gpubench.reference import compare


def inputs(cell):
    """(the program's arch, weights, the adapter tree, the prompt pool
    (pool, batch, seq)) from the seed."""
    p, dev = cell.params, cell.device
    arch = program.build_arch(cell.config, cell.arch_overrides)
    pstruct, astruct = program.structures(arch, p["r_max"])
    gen = seeded.generator(cell.seed, dev)
    weights = seeded.model_weights(pstruct, gen, dev,
                                   cell.config.get("weight_rules"))
    adapters = seeded.set_rank(seeded.fill(
        astruct, gen, seeded.lora_rule(p["a_std"], p["b_std"]), dev),
        p["adapter_rank"])
    b, s = p["batch"], p["seq"]
    tokens = seeded.bigram_tokens(gen, cell.cfg["vocab_size"],
                                  p["pool"] * b, s, p["p_follow"], dev)
    return arch, weights, adapters, tokens.view(p["pool"], b, s)


def run(cell) -> dict:
    from repro_torch.models.model import make_model

    p, dev = cell.params, cell.device
    sync = C.syncer(dev)
    arch, weights, adapters, tokens = inputs(cell)
    b, s = p["batch"], p["seq"]
    model = make_model(arch, remat=False, scan_backend=p["scan_backend"])
    times: list = []
    count = [0]

    def prefill():
        t0 = time.perf_counter()
        with tr.label("prefill"), torch.inference_mode():
            logits, _ = model.prefill(
                weights, adapters,
                {"tokens": tokens[count[0] % p["pool"]]})
            sync()
        times.append((t0, time.perf_counter()))
        count[0] += 1
        return logits

    for _ in range(p["warm_calls"]):
        prefill()
    times.clear()
    count[0] = 0
    rng = np.random.default_rng(seeded.sub_seed(cell.seed, 13))
    sample = {0} | set(int(v) for v in rng.integers(
        1, p["check_span"], p["check_calls"] - 1))
    kept = []
    setup_peak = C.peak_reset(dev)
    start = time.perf_counter()
    deadline = start + cell.seconds
    while time.perf_counter() < deadline:
        idx = count[0]
        logits = prefill()
        if idx in sample:
            kept.append({"tokens": idx % p["pool"], "logits": logits})
    window_calls = list(times)
    window = window_calls[-1][1] - window_calls[0][0]
    window_peak = C.peak(dev)
    prefill_flops = spec.load_count(cell.config, "prefill").prefill_flops
    flops = prefill_flops(cell.cfg, b, s, p["adapter_rank"]) \
        * len(window_calls)
    ctx = {"window_s": window, "calls": len(window_calls), "flops": flops}
    reading = None
    if cell.trace:
        def units():
            for _ in range(p["trace_calls"]):
                prefill()
        reading = tr.traced(dev, prefill, units, sync)
        ctx["trace"] = reading
        ctx["trace_calls"] = p["trace_calls"]
    e2e = {"prefill_tokens_per_s": b * s * len(window_calls) / window,
           "setup_s": start - cell.t0}
    memory_peak = max(setup_peak, window_peak)
    del model
    C.free(dev)
    readings = check(cell, weights, adapters, tokens, kept)
    return {"e2e": e2e, "attempted": len(window_calls), "failed": 0,
            "ctx": ctx, "trace": reading, "readings": readings,
            "memory_peak_bytes": memory_peak}


def reference_logits(cell, weights, adapters, tokens, prec="fp32"):
    """The reference's last-position logits of ``tokens`` (B, L), in blocks
    of ``check_block`` prompts."""
    blk = cell.params["check_block"]
    model_ref = spec.load_reference(cell.config)
    amap = model_ref.adapter_pairs(adapters)
    return torch.cat([
        model_ref.last_logits(weights, amap, tokens[j:j + blk], cell.cfg,
                              prec, alpha=cell.cfg["alpha"])
        for j in range(0, tokens.shape[0], blk)])


def check(cell, weights, adapters, tokens, kept) -> dict:
    """The worst prompt's relative L2 gap of the last-position logits."""
    gap = 0.0 if kept else float("inf")
    for k in kept:
        ref = reference_logits(cell, weights, adapters, tokens[k["tokens"]])
        gap = max(gap, compare.rel_l2(k["logits"], ref))
    return {"logits_gap": gap}


def control(cell, kind: str = "control") -> dict:
    """The check's number for the reference put in the program's place at
    the precision below the configuration's (bf16 weights: fp8 matmul
    operands), over the pool's first batch."""
    if kind != "control":
        raise ValueError(f"prefill_batches has no reading {kind!r}")
    _, weights, adapters, tokens = inputs(cell)
    tokens = tokens[0]
    ref = reference_logits(cell, weights, adapters, tokens)
    low = reference_logits(cell, weights, adapters, tokens, prec="fp8")
    return {"logits_gap": compare.rel_l2(low, ref)}
