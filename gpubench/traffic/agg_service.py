"""Traffic driver ``agg_service``: the FLaaS server's buffered asynchronous
aggregation service, fed a closed loop of client uploads.

A pool of ``len(ranks) * clients_per_rank`` uploads of the model's whole
adapter tree is made on the device from the seed, each at its client's
live rank of ``r_max`` and with the paper's staircase of example counts
(stair step ``k`` of ``S`` holds labels ``0..k``, label ``c`` split evenly
over the steps ``c..S-1``, ``n_per_class`` examples a label).  Uploads are
submitted back to back to ``repro_torch.fl.AsyncAggregator`` (the
workload's strategy, ``backend="auto"``, ``buffer_size`` K, the
polynomial staleness schedule), cycling the pool in a fresh seeded
permutation each pass, each ``tau`` versions stale with ``tau`` drawn
uniformly from ``0..tau_max``.  Every K-th submit flushes one aggregation
round, which publishes.

End-to-end metrics, host clock: ``uploads_per_s`` (uploads folded into a
published global over the window, which ends when the last flush started
before the deadline ends) and ``flush_p95_ms`` (every flush of the
window, from the submit that fills the buffer to the new global complete
on the device).  The check compares, for flushes of the window drawn from
the seed (the first always), the buffered uploads' staleness weights and
the published global with the reference's Eq. 7 from the global before
that flush.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.lib import cell as C
from gpubench.lib import program, seeded
from gpubench.lib import trace as tr
from gpubench.reference import compare, rbla


def staircase(steps: int, n_per_class: float) -> list[float]:
    """Examples held at each stair step."""
    return [sum(n_per_class / (steps - c) for c in range(k + 1))
            for k in range(steps)]


def make_pool(cell, device):
    """(uploads, the first global, ranks, masses, pair shapes)."""
    p = cell.params
    arch = program.build_arch(cell.config, cell.arch_overrides)
    _, structure = program.structures(arch, p["r_max"])
    gen = seeded.generator(cell.seed, device)
    rule = seeded.lora_rule(p["a_std"], p["b_std"])
    masses = staircase(len(p["ranks"]), p["n_per_class"])
    ranks, mass = [], []
    for k, r in enumerate(p["ranks"]):
        ranks += [r] * p["clients_per_rank"]
        mass += [masses[k]] * p["clients_per_rank"]
    uploads = [seeded.set_rank(seeded.fill(structure, gen, rule, device), r)
               for r in ranks]
    first = seeded.set_rank(seeded.fill(structure, gen, rule, device),
                            p["r_max"])
    shapes = [(tuple(q["A"].shape), tuple(q["B"].shape))
              for q in rbla.pairs(first).values()]
    return uploads, first, ranks, mass, shapes


def schedule(seed: int, n_pool: int, tau_max: int, n: int):
    """(upload index, staleness) of the first ``n`` submits."""
    rng = np.random.default_rng(seeded.sub_seed(seed, 7))
    passes = -(-n // n_pool)
    order = np.concatenate([rng.permutation(n_pool) for _ in range(passes)])
    taus = rng.integers(0, tau_max + 1, passes * n_pool)
    return order[:n], taus[:n]


def run(cell) -> dict:
    from repro_torch.core.strategy import ClientUpdate, ServerState
    from repro_torch.fl import AsyncAggregator
    from repro_torch.kernels import runtime
    from repro_torch.obs import MetricsRegistry

    p, dev = cell.params, cell.device
    sync = C.syncer(dev)
    uploads, first, ranks, mass, shapes = make_pool(cell, dev)
    k = p["buffer_size"]
    order, taus = schedule(cell.seed, len(uploads), p["tau_max"],
                           p["max_submits"])
    updates = [ClientUpdate(adapters=u, base_trainable={}, n_examples=m,
                            rank=r) for u, m, r in zip(uploads, mass, ranks)]
    registry = MetricsRegistry(enabled=True)
    published = {}
    svc = AsyncAggregator(
        p["strategy"], ServerState(adapters=first, base_trainable={},
                                   round=0, r_max=p["r_max"]),
        staleness=p["staleness"], staleness_a=p["staleness_a"],
        buffer_size=k, backend="auto", registry=registry,
        on_publish=lambda s: published.__setitem__("state", s))
    cursor = [0]
    batch: list = []

    def submit():
        i = cursor[0]
        cursor[0] += 1
        if i >= len(order):
            raise RuntimeError("the schedule ran out; raise max_submits")
        u, tau = int(order[i]), int(taus[i])
        batch.append((u, tau))
        return svc.submit(updates[u], model_version=svc.version - tau)

    def one_flush():
        """K submits; the last flushes."""
        batch.clear()
        for _ in range(k - 1):
            with tr.label("submit"):
                submit()
        with tr.label("flush"):
            submit()

    for _ in range(p["warm_flushes"]):
        one_flush()
    sync()

    rng = np.random.default_rng(seeded.sub_seed(cell.seed, 11))
    sample = {0} | set(int(v) for v in rng.integers(
        1, p["check_span"], p["check_flushes"] - 1))
    kept = []

    def spans():
        h = registry.get("obs_span_seconds")
        out = {}
        for stage in ("submit", "flush", "fold", "publish"):
            child = h.labels(stage=stage) if h is not None else None
            out[stage] = ([child.sum, child.count] if child is not None
                          else [0.0, 0])
        return out

    setup_peak = C.peak_reset(dev)
    spans0 = spans()
    launches0 = sum(runtime.LAUNCHES.values())
    flush_ms, n_flush = [], 0
    start = time.perf_counter()
    deadline = start + cell.seconds
    last_end = start
    while time.perf_counter() < deadline:
        batch.clear()
        for _ in range(k - 1):
            submit()
        if time.perf_counter() >= deadline:
            break           # this flush would start after the deadline
        idx = n_flush
        keep = idx in sample
        if keep:
            pre = svc.state.adapters
            buffered = [b.weight for b in svc.buffer._items]
        t0 = time.perf_counter()
        advanced = submit()
        sync()
        t1 = time.perf_counter()
        if not advanced:
            raise RuntimeError("the K-th submit did not flush")
        flush_ms.append((t1 - t0) * 1e3)
        n_flush += 1
        last_end = t1
        if keep:
            kept.append({"index": idx, "pre": pre,
                         "post": svc.state.adapters, "batch": list(batch),
                         "buffered": buffered})
    window = last_end - start
    window_peak = C.peak(dev)
    ctx = {"spans": {s: [v[0] - spans0[s][0], v[1] - spans0[s][1]]
                     for s, v in spans().items()},
           "launches": sum(runtime.LAUNCHES.values()) - launches0,
           "n_flushes": n_flush, "window_s": window, "r_max": p["r_max"],
           "pair_shapes": shapes}
    reading = None
    if cell.trace:
        trace_batches = []

        def units():
            for _ in range(p["trace_flushes"]):
                one_flush()
                trace_batches.append([ranks[u] for u, _ in batch])
        reading = tr.traced(dev, one_flush, units, sync)
        ctx["trace"] = reading
        ctx["trace_batches"] = trace_batches
    memory_peak = max(setup_peak, window_peak)

    e2e = {"uploads_per_s": k * n_flush / window if window > 0 else 0.0,
           "flush_p95_ms": float(np.percentile(flush_ms, 95))
           if flush_ms else float("nan"),
           "setup_s": start - cell.t0}
    del svc, published, updates
    C.free(dev)
    readings = check(cell, kept, uploads, ranks, mass)
    return {"e2e": e2e, "attempted": k * n_flush, "failed": 0,
            "ctx": ctx, "trace": reading, "readings": readings,
            "memory_peak_bytes": memory_peak}


def check(cell, kept, uploads, ranks, mass) -> dict:
    """The numbers over the kept flushes: the worst relative gap of a
    buffered staleness weight, of a global leaf, and the count of rank
    leaves that differ."""
    p = cell.params
    w_gap, g_gap, rank_off = 0.0, 0.0, 0
    for f in kept:
        w_ref = [rbla.staleness_weight(mass[u], tau, p["staleness_a"])
                 for u, tau in f["batch"]]
        for got, want in zip(f["buffered"], w_ref):
            w_gap = max(w_gap, abs(got - want) / want)
        ref = rbla.eq7(f["pre"], [uploads[u] for u, _ in f["batch"]], w_ref,
                       [ranks[u] for u, _ in f["batch"]], p["r_max"],
                       precision="fp64")
        gap, off = compare.tree_max_rel(rbla.pairs(f["post"]), ref)
        g_gap, rank_off = max(g_gap, gap), rank_off + off
        del ref
    if not kept:
        g_gap = float("inf")
    return {"weight_gap": w_gap, "global_gap": g_gap,
            "rank_leaves_off": float(rank_off)}


def control(cell, kind: str = "control") -> dict:
    """The check's numbers for the reference put in the program's place at
    the precision below the configuration's (fp32 uploads: bf16), over the
    first flush of the seed's schedule from the first global."""
    if kind != "control":
        raise ValueError(f"agg_service has no reading {kind!r}")
    p = cell.params
    uploads, first, ranks, mass, _ = make_pool(cell, cell.device)
    order, taus = schedule(cell.seed, len(uploads), p["tau_max"],
                           p["buffer_size"])
    w = [rbla.staleness_weight(mass[u], t, p["staleness_a"])
         for u, t in zip(order, taus)]
    w_low = [float(torch.tensor(v, dtype=torch.bfloat16)) for v in w]
    args = ([uploads[u] for u in order], [ranks[u] for u in order],
            p["r_max"])
    ref = rbla.eq7(first, args[0], w, args[1], args[2], precision="fp64")
    low = rbla.eq7(first, args[0], w, args[1], args[2], precision="bf16")
    gap, off = compare.tree_max_rel(low, ref)
    return {"weight_gap": max(abs(a - b) / b for a, b in zip(w_low, w)),
            "global_gap": gap, "rank_leaves_off": float(off)}
