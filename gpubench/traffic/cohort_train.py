"""Traffic driver ``cohort_train``: a cohort's LoRA fine-tuning on the FLaaS
server's card, round after round.

The benchmark makes the model's weights (in the configuration's dtype),
the first global adapter tree at ``r_max`` and every client's bigram
tokens on the device from the seed.  A round: each client in turn (its
live rank from ``ranks``) takes the global re-sliced to its rank
(``repro_torch.lora.set_ranks`` at ``r_max`` storage, as the simulator
hands it out), a fresh ``repro_torch.optim.adam(lr)`` state and one step
of ``repro_torch.launch.train.make_step`` (``Model.loss``, autograd over
the factors, the optimizer's update) on its own ``batch`` x ``seq``
tokens, with the model built under the workload's ``remat``; then the
registered strategy's ``aggregate_adapters`` folds the cohort's uploads
into the next global.  Round 0 runs in set-up, through the same calls.

End-to-end, host clock: ``train_tokens_per_s``, every client token
trained in the window over the time from its first step's start to its
last step's end (each step ends in a synchronise; a step that straddles
the deadline is finished and counted, a round's aggregation between two
steps counts as time).  The check follows round 0's first ``check_steps``
client steps with the reference (loss, the gradient read back from
Adam's first moment, the factors' change) and the window's first step
(round 1's first client, from the global round 0 aggregated), and holds
round 0's aggregation and the window's first (round 1's) to Eq. 7 over
the uploads each folded.  Where the window closes before round 1 is
whole, its remaining steps and its aggregation run after the window,
untimed.

The configuration names its plain reference (``"reference"``, a module
of ``gpubench/reference/`` with ``adapter_pairs``, ``loss_and_grad``)
and its training step's count (``"counts"["train"]``, a module of
``gpubench/counts/`` with ``step_flops``).
"""
from __future__ import annotations

import time

import torch

from gpubench.lib import cell as C
from gpubench.lib import program, seeded, spec
from gpubench.lib import trace as tr
from gpubench.reference import compare, lm, rbla

B1 = 0.9        # Adam's first-moment decay, as repro_torch.optim.adam


def leaves(model_ref, tree) -> dict:
    """{(pair key, side): tensor} of an adapter factor tree, its pairs as
    the reference names them."""
    return {(t, s): pair[s] for t, pair in model_ref.adapter_pairs(
        tree).items() for s in ("A", "B")}


def sliced(model_ref, global_tree, rank: int) -> dict:
    """The reference's start of a client at ``rank``: the global's pairs
    with rows (of A) and columns (of B) at or past ``rank`` zeroed."""
    out = {}
    for (t, s), x in leaves(model_ref, global_tree).items():
        y = x.clone()
        if s == "A":
            y[..., rank:, :] = 0
        else:
            y[..., rank:] = 0
        out[(t, s)] = y
    return out


def inputs(cell):
    """(the program's arch, weights, the first global, tokens (rounds,
    clients, batch, seq)) from the seed."""
    p, dev = cell.params, cell.device
    arch = program.build_arch(cell.config, cell.arch_overrides)
    pstruct, astruct = program.structures(arch, p["r_max"])
    gen = seeded.generator(cell.seed, dev)
    weights = seeded.model_weights(pstruct, gen, dev,
                                   cell.config.get("weight_rules"))
    first = seeded.set_rank(seeded.fill(
        astruct, gen, seeded.lora_rule(p["a_std"], p["b_std"]), dev),
        p["r_max"])
    n, b, s = len(p["ranks"]), p["batch"], p["seq"]
    rounds = p["token_rounds"]
    tokens = seeded.bigram_tokens(gen, cell.cfg["vocab_size"],
                                  rounds * n * b, s, p["p_follow"], dev)
    return arch, weights, first, tokens.view(rounds, n, b, s)


def run(cell) -> dict:
    from repro_torch.core.strategy import get_strategy
    from repro_torch.launch.train import make_step
    from repro_torch.lora import attach_ranks, set_ranks, strip_ranks
    from repro_torch.models.model import make_model
    from repro_torch.optim import adam

    p, dev = cell.params, cell.device
    sync = C.syncer(dev)
    arch, weights, first, tokens = inputs(cell)
    ranks = list(p["ranks"])
    n, b, s = len(ranks), p["batch"], p["seq"]
    rounds = p["token_rounds"]

    model = make_model(arch, remat=p["remat"],
                       scan_backend=p.get("scan_backend", "ref"))
    opt = adam(p["lr"])
    strategy = get_strategy(p["strategy"])
    rank_trees, steps = [], []
    for r in ranks:
        _, rk = strip_ranks(set_ranks(first, r, r_storage=p["r_max"]))
        rank_trees.append(rk)
        steps.append(make_step(model, weights, rk, opt))
    client_ranks = torch.tensor(ranks, dtype=torch.int32, device=dev)
    state = {"global": first, "round": 0, "uploads": []}
    times: list = []

    def client_step(i):
        """Client ``i`` of the current round: (factors before, after, the
        optimizer state after, the loss)."""
        g = state["global"]
        factors, _ = strip_ranks(set_ranks(g, ranks[i], r_storage=p["r_max"]))
        new, st, loss = steps[i](factors, opt.init(factors),
                                 tokens[state["round"] % rounds, i])
        state["uploads"].append(attach_ranks(new, rank_trees[i]))
        return new, st, loss

    window_round: dict = {}         # round 1, the window's first round

    def aggregate():
        prev, ups = state["global"], state["uploads"]
        state["global"] = strategy.aggregate_adapters(
            ups, torch.ones(n, device=dev), r_max=p["r_max"],
            client_ranks=client_ranks, prev_global=prev)
        if state["round"] == 1:
            window_round.update(prev=prev, uploads=list(ups),
                                post=state["global"])
        state["uploads"] = []
        state["round"] += 1

    def timed_step(i):
        t0 = time.perf_counter()
        with tr.label("client_step"):
            out = client_step(i)
            sync()
        times.append((t0, time.perf_counter(), ranks[i]))
        return out

    # round 0, in set-up: the checked steps and the first aggregation
    kept = []
    for i in range(n):
        new, st, loss = timed_step(i)
        if i < p["check_steps"]:
            kept.append({"rank": ranks[i], "loss": float(loss),
                         "m": st["m"], "new": new})
    uploads0 = list(state["uploads"])
    with tr.label("aggregate"):
        aggregate()
    global1 = state["global"]
    sync()
    times.clear()

    setup_peak = C.peak_reset(dev)
    start = time.perf_counter()
    deadline = start + cell.seconds
    i = 0
    while time.perf_counter() < deadline:
        new, st, loss = timed_step(i)
        if len(times) == 1:         # the window's first step: round 1's
            window_kept = {"rank": ranks[0], "loss": loss, "m": st["m"],
                           "new": new}
        i += 1
        if i == n:
            with tr.label("aggregate"):
                aggregate()
            i = 0
    window_steps = list(times)
    window = window_steps[-1][1] - window_steps[0][0]
    window_peak = C.peak(dev)
    while not window_round:         # round 1, after the window, untimed
        client_step(len(state["uploads"]))
        if len(state["uploads"]) == n:
            aggregate()
    state["uploads"] = []           # a later round the deadline cut short
    trained = b * s * len(window_steps)
    step_flops = spec.load_count(cell.config, "train").step_flops
    flops = sum(step_flops(cell.cfg, b, s, r) for _, _, r in window_steps)
    ctx = {"window_s": window, "steps": len(window_steps),
           "flops": flops, "peak_window_bytes": window_peak}
    reading = None
    if cell.trace:
        def units():
            for j in range(n):
                timed_step(j)
            with tr.label("aggregate"):
                aggregate()
            sync()
        def warm():
            timed_step(0)
            state["uploads"] = []
        reading = tr.traced(dev, warm, units, sync)
        ctx["trace"] = reading
    e2e = {"train_tokens_per_s": trained / window,
           "setup_s": start - cell.t0}
    memory_peak = max(setup_peak, window_peak)
    window_kept["loss"] = float(window_kept["loss"])
    del model, steps, state
    C.free(dev)
    readings = check(cell, weights, tokens, kept, window_kept, first,
                     [(first, uploads0, global1),
                      (window_round["prev"], window_round["uploads"],
                       window_round["post"])])
    return {"e2e": e2e, "attempted": len(window_steps), "failed": 0,
            "ctx": ctx, "trace": reading, "readings": readings,
            "memory_peak_bytes": memory_peak}


def follow(cell, weights, start_global, batch, rank, prec="fp32",
           rows=None):
    """The reference's client step at ``rank`` from ``start_global`` on
    ``batch`` (B, S), or its first ``rows`` rows: (loss, gradients, the
    factors' change, the factors it started from)."""
    p = cell.params
    model_ref = spec.load_reference(cell.config)
    start = sliced(model_ref, start_global, rank)
    factors = {}
    for (t, s), x in start.items():
        factors.setdefault(t, {})[s] = x
    batch = batch if rows is None else batch[:rows]
    loss, grads = model_ref.loss_and_grad(weights, factors, rank, batch,
                                          cell.cfg, prec,
                                          alpha=cell.cfg["alpha"])
    change = {k: lm.adam_first_update(g, p["lr"]) for k, g in grads.items()}
    return loss, grads, change, start


def check(cell, weights, tokens, kept, window_kept, first, rounds) -> dict:
    """The numbers: the worst relative loss gap over the checked steps
    (round 0's first ``check_steps`` and the window's first); the worst
    leaf's gap of the gradient's and of the change's norm; the worst
    relative gap from Eq. 7 of round 0's aggregation and the window's
    first, each over the uploads it folded; the count of rank leaves that
    differ."""
    p = cell.params
    model_ref = spec.load_reference(cell.config)
    n_rounds = p["token_rounds"]
    steps = [(k, first, tokens[0, i]) for i, k in enumerate(kept)]
    steps.append((window_kept, rounds[1][0], tokens[1 % n_rounds, 0]))
    loss_gap = grad_gap = change_gap = 0.0
    for k, start_global, batch in steps:
        loss, grads, change, start = follow(cell, weights, start_global,
                                            batch, k["rank"])
        loss_gap = max(loss_gap, abs(k["loss"] - loss) / abs(loss))
        g_prog = {key: x.float() / (1 - B1)
                  for key, x in leaves(model_ref, k["m"]).items()}
        c_prog = {key: x.float() - start[key]
                  for key, x in leaves(model_ref, k["new"]).items()}
        grad_gap = max(grad_gap, compare.norm_gaps(g_prog, grads)[0])
        change_gap = max(change_gap, compare.norm_gaps(c_prog, change)[0])
        del grads, change, g_prog, c_prog
    agg_gap, rank_off = 0.0, 0
    for prev, uploads, post in rounds:
        ref = rbla.eq7(prev, uploads, [1.0] * len(uploads),
                       list(p["ranks"]), p["r_max"], precision="fp64")
        gap, off = compare.tree_max_rel(rbla.pairs(post), ref)
        agg_gap, rank_off = max(agg_gap, gap), rank_off + off
        del ref
    if not kept:
        loss_gap = float("inf")
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap, "agg_gap": agg_gap,
            "rank_leaves_off": float(rank_off)}


def control(cell, kind: str = "control") -> dict:
    """The check's numbers for the reference put in the program's place:
    ``"control"`` at the precision below the configuration's (bf16
    weights: fp8 matmul operands, bf16 aggregation), ``"half_batch"`` with
    half of each checked client's rows left out; over the checked steps of
    round 0, against the fp32 reference."""
    p = cell.params
    model_ref = spec.load_reference(cell.config)
    _, weights, first, tokens = inputs(cell)
    prec = {"control": "fp8", "half_batch": "fp32"}[kind]
    rows = p["batch"] // 2 if kind == "half_batch" else None
    key_of = {id(pair): t
              for t, pair in model_ref.adapter_pairs(first).items()}
    loss_gap = grad_gap = change_gap = 0.0
    uploads = []
    for i in range(p["check_steps"]):
        rank = p["ranks"][i]
        loss, grads, change, start = follow(cell, weights, first,
                                            tokens[0, i], rank)
        l2, g2, c2, _ = follow(cell, weights, first, tokens[0, i], rank,
                               prec=prec, rows=rows)
        loss_gap = max(loss_gap, abs(l2 - loss) / abs(loss))
        grad_gap = max(grad_gap, compare.norm_gaps(g2, grads)[0])
        change_gap = max(change_gap, compare.norm_gaps(c2, change)[0])

        def stepped(pair, c2=c2, start=start):
            t = key_of[id(pair)]
            return {"A": start[(t, "A")] + c2[(t, "A")],
                    "B": start[(t, "B")] + c2[(t, "B")],
                    "rank": pair["rank"]}
        uploads.append(rbla.map_pairs(first, stepped))
    rk = list(p["ranks"][:len(uploads)])
    ref = rbla.eq7(first, uploads, [1.0] * len(uploads), rk, p["r_max"],
                   precision="fp64")
    low = rbla.eq7(first, uploads, [1.0] * len(uploads), rk, p["r_max"],
                   precision="bf16" if kind == "control" else "fp64")
    agg_gap, off = compare.tree_max_rel(low, ref)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap, "agg_gap": agg_gap,
            "rank_leaves_off": float(off)}
