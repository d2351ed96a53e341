#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

* env -- the card's name and power limit, torch and CUDA versions;
* build -- nvcc of every kernel source into ``build/kernels/``;
* kernels -- every kernel held against its plain PyTorch version on the
  card, at the paper MLP's bucket shapes and one large shape, with its time,
  the plain version's time and the HBM bound;
* main_path -- ``run_simulation`` of ``examples/quickstart.py`` (the MNIST
  MLP at full width, 10 clients, r_max 64, 6 rbla rounds) with the launch
  counts of that run: one packed_agg launch per bucket per round, no plain
  version;
* plain_reference -- the same run aggregating with the plain versions on
  the card; the kernel run must reproduce it;
* one_round -- one round each of rbla_norm (the norm_restore path) and
  zeropad;
* per_pair -- the last main-path cohort again through the per-pair
  rbla_agg path, held against the plan's result.

Then the ``{"kernels": [...]}`` summary, the card's line from nvidia-smi,
and the device summary as the last line.  Any failure ends the run with a
non-zero exit.  Exits non-zero, printing no result, when there is no CUDA
device or no port beside the script.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
REPLACES = {
    "packed_agg": "src/repro/kernels/rbla_agg/kernel.py:115",
    "rbla_agg": "src/repro/kernels/rbla_agg/kernel.py:473",
}
SOURCE = "src/repro_torch/kernels/csrc/rbla_agg.cu"
MLP_BUCKETS = ((64, 784), (256, 200), (64, 10))   # (rows, width), r_max=64
MLP_PAIR_SIDES = ((64, 784, 1), (64, 200, 4), (64, 10, 1))  # + count/round
N_CLIENTS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels --
def _agg_inputs(n, r, d, x_dtype, gen, with_prev, with_scales, out_dtype):
    import torch
    dev = "cuda"
    ranks = torch.randint(1, r + 1, (n,), generator=gen, device=dev)
    masks = (torch.arange(r, device=dev)[None, :] < ranks[:, None]).float()
    weights = torch.rand(n, generator=gen, device=dev) * 1.5 + 0.5
    if x_dtype == torch.int8:
        x = torch.randint(-127, 128, (n, r, d), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    else:
        x = torch.randn(n, r, d, generator=gen, device=dev).to(x_dtype)
    scales = (torch.rand(n, r, generator=gen, device=dev) * 0.02 + 0.001
              if with_scales else None)
    prev = (torch.randn(r, d, generator=gen, device=dev).to(out_dtype)
            if with_prev else None)
    return x, ranks, masks, weights, prev, scales


def _packed_bytes(x, masks, weights, prev, scales, out_dtype, norm_by):
    """Bytes packed_agg must move for these inputs: each input read once,
    the output written once; prev only for the rows no client owns."""
    n, r, d = x.shape
    osz = out_dtype.itemsize
    b = x.numel() * x.element_size() + masks.numel() * 4 + weights.numel() * 4
    b += r * d * osz
    if scales is not None:
        b += scales.numel() * 4
    if prev is not None and norm_by == "mask":
        b += int((masks.sum(0) == 0).sum()) * d * osz
    return b


def check_packed_case(n, r, d, x_dtype, out_dtype, norm_by, with_prev,
                      norm_restore, seed):
    import torch
    from repro_torch.kernels.rbla_agg import packed_agg, packed_agg_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with_scales = x_dtype == torch.int8
    x, _, masks, weights, prev, scales = _agg_inputs(
        n, r, d, x_dtype, gen, with_prev, with_scales, out_dtype)
    kw = dict(norm_by=norm_by, norm_restore=norm_restore, scales=scales,
              out_dtype=out_dtype)
    got = packed_agg(x, masks, weights, prev, **kw)
    want = packed_agg_ref(x, masks, weights, prev, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = (2e-2 if out_dtype == torch.bfloat16 else 2e-5) * scale
    ms = time_ms(lambda: packed_agg(x, masks, weights, prev, **kw))
    plain_ms = time_ms(lambda: packed_agg_ref(x, masks, weights, prev, **kw))
    flops = 2 * n * r * d * (2 if norm_restore else 1)
    bms, by = bound(_packed_bytes(x, masks, weights, prev, scales, out_dtype,
                                  norm_by), flops)
    case = {"kernel": "packed_agg", "shape": [n, r, d],
            "x_dtype": str(x_dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1], "norm_by": norm_by,
            "prev": with_prev, "norm_restore": norm_restore,
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit(case)
    if not err <= tol:
        raise AssertionError(f"packed_agg disagrees with its plain version: {case}")
    return case


def check_rbla_case(n, r, d, dtype, method, seed):
    import torch
    from repro_torch.kernels.rbla_agg import rbla_agg, rbla_agg_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, ranks, _, weights, _, _ = _agg_inputs(n, r, d, dtype, gen, False,
                                             False, dtype)
    norm_by = {"rbla": "mask", "zeropad": "weight"}[method]
    got = rbla_agg(x, ranks, weights, method=method)
    want = rbla_agg_ref(x, ranks, weights, norm_by=norm_by)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = (2e-2 if dtype == torch.bfloat16 else 2e-5) * scale
    ms = time_ms(lambda: rbla_agg(x, ranks, weights, method=method))
    plain_ms = time_ms(lambda: rbla_agg_ref(x, ranks, weights,
                                            norm_by=norm_by))
    b = x.numel() * x.element_size() + 8 * n + r * d * x.element_size()
    bms, by = bound(b, 2 * n * r * d)
    case = {"kernel": "rbla_agg", "shape": [n, r, d],
            "x_dtype": str(dtype).split(".")[-1], "method": method,
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit(case)
    if not err <= tol:
        raise AssertionError(f"rbla_agg disagrees with its plain version: {case}")
    return case


def phase_kernels() -> dict:
    """Every case of both kernels; returns the per-kernel summary rows
    (times summed over one main-path round's launches)."""
    import torch
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    seed = 0
    packed = []
    shapes = [(N_CLIENTS, r, d) for r, d in MLP_BUCKETS] + [(N_CLIENTS, 2048, 4096)]
    for n, r, d in shapes:
        for norm_by in ("mask", "weight"):
            for with_prev in (False, True):
                for norm_restore in (False, True):
                    for x_dtype, out_dtype in ((f32, f32), (bf16, bf16),
                                               (i8, f32)):
                        seed += 1
                        packed.append(check_packed_case(
                            n, r, d, x_dtype, out_dtype, norm_by, with_prev,
                            norm_restore, seed))
    rbla = []
    for r, d, _ in MLP_PAIR_SIDES:
        for dtype in (f32, bf16):
            for method in ("rbla", "zeropad"):
                seed += 1
                rbla.append(check_rbla_case(N_CLIENTS, r, d, dtype, method,
                                            seed))

    def main_path_sum(cases, match, counts):
        rows = {}
        for key, k in counts.items():
            hit = [c for c in cases if match(c, key)]
            if len(hit) != 1:
                raise AssertionError(f"no unique case for {key}")
            for f in ("ms", "plain_ms", "bound_ms"):
                rows[f] = rows.get(f, 0.0) + k * hit[0][f]
        return rows

    # one main-path round: rbla buckets in fp32, mask-normalised, with prev
    pk = main_path_sum(
        packed,
        lambda c, key: (tuple(c["shape"][1:]) == key and c["x_dtype"] == "float32"
                        and c["norm_by"] == "mask" and c["prev"]
                        and not c["norm_restore"]),
        {b: 1 for b in MLP_BUCKETS})
    # one per-pair round: every A and transposed B side, fp32, rbla
    rk = main_path_sum(
        rbla,
        lambda c, key: (tuple(c["shape"][1:]) == key[:2]
                        and c["x_dtype"] == "float32" and c["method"] == "rbla"),
        {s: s[2] for s in MLP_PAIR_SIDES})
    summary = {}
    for name, cases, row in (("packed_agg", packed, pk), ("rbla_agg", rbla, rk)):
        summary[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": None}
    return summary


# --------------------------------------------------------------- main path --
#: examples/quickstart.py: the paper's MNIST MLP at full width (784-200-200-10),
#: 10 staircase clients, r_max 64, 6 synchronous rbla rounds
MAIN_CFG = dict(dataset="mnist", model="mlp", method="rbla", rounds=6,
                n_clients=10, n_per_class=200, n_test_per_class=50,
                local_epochs=2, lr=0.05, r_max=64, seed=42)


class Recorder:
    """Wraps a strategy's ``aggregate`` for one run and keeps the last
    round's (incoming state, updates, returned state)."""

    def __init__(self, strategy):
        self.strategy, self.last = strategy, None
        orig = strategy.aggregate

        def spy(state, updates, *a, **k):
            updates = list(updates)
            out = orig(state, updates, *a, **k)
            self.last = (state, updates, out)
            return out
        strategy.aggregate = spy

    def close(self):
        del self.strategy.aggregate          # back to the class's method


def drive(cfg_kw: dict):
    """One ``run_simulation`` on the card with fresh counts; returns the
    history, the launch and plain-call counts, and the recorded last round."""
    import torch
    from repro_torch.core.strategy import get_strategy
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import runtime
    rec = Recorder(get_strategy(cfg_kw["method"]))
    try:
        runtime.reset_counts()
        t0 = time.perf_counter()
        hist = run_simulation(FLConfig(**cfg_kw), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    finally:
        rec.close()
    return hist, launches, plain, rec.last, seconds


def _leaves_on_card(tree) -> list:
    import torch
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    if not leaves or not all(t.is_cuda for t in leaves):
        raise AssertionError("a global tensor is not on the card")
    if not all(bool(torch.isfinite(t.float()).all()) for t in leaves):
        raise AssertionError("a global tensor is not finite")
    return leaves


def _rel_err(got_tree, want_tree) -> tuple[float, float]:
    """(max |got - want|, max |want|) over every float leaf."""
    from repro_torch.tree import tree_leaves
    err = scale = 0.0
    for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
        if w.is_floating_point():
            err = max(err, float((g.float() - w.float()).abs().max()))
            scale = max(scale, float(w.float().abs().max()))
    return err, scale


def phase_main_path():
    from repro_torch.core.strategy import get_strategy
    hist, launches, plain, last, secs = drive(MAIN_CFG)
    plans = list(get_strategy("rbla").__dict__.get("_plan_cache", {}).values())
    buckets = sorted({p.n_kernel_launches for p in plans})
    emit({"phase": "main_path", "method": "rbla", "config": MAIN_CFG,
          "test_acc": hist.test_acc, "train_loss": hist.train_loss,
          "round_time_s": hist.round_time_s, "seconds": secs,
          "launches": launches, "plain_calls": plain,
          "plan_buckets": buckets})
    if buckets != [3]:
        raise AssertionError(f"expected 3 buckets per round, got {buckets}")
    if launches["packed_agg"] != MAIN_CFG["rounds"] * 3:
        raise AssertionError(f"packed_agg launched {launches['packed_agg']} "
                             f"times, expected {MAIN_CFG['rounds'] * 3}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    if not hist.test_acc[-1] > 0.1:
        raise AssertionError(f"final accuracy {hist.test_acc[-1]} is not "
                             "above chance")
    _leaves_on_card(last[2].adapters)
    _leaves_on_card(last[2].base_trainable)
    return hist, launches, last


def phase_plain_reference(hist, last):
    """The same run with the plain versions aggregating on the card: the
    kernels' rounds must reproduce it (same init, same batches)."""
    ref_hist, launches, plain, ref_last, secs = drive(
        dict(MAIN_CFG, agg_backend="ref"))
    err, scale = _rel_err(last[2].adapters, ref_last[2].adapters)
    acc_gap = max(abs(a - b) for a, b in zip(hist.test_acc, ref_hist.test_acc))
    emit({"phase": "plain_reference", "test_acc": ref_hist.test_acc,
          "seconds": secs, "launches": launches, "plain_calls": plain,
          "max_acc_gap": acc_gap, "adapters_max_abs_err": err,
          "adapters_tol": 1e-3 * scale})
    if launches["packed_agg"] or plain["packed_agg"] != MAIN_CFG["rounds"] * 3:
        raise AssertionError("the ref backend did not run the plain version")
    if not (acc_gap <= 0.01 and err <= 1e-3 * scale):
        raise AssertionError("kernel rounds disagree with plain rounds")


def phase_other_methods():
    for method in ("rbla_norm", "zeropad"):
        hist, launches, plain, last, secs = drive(
            dict(MAIN_CFG, method=method, rounds=1))
        emit({"phase": "one_round", "method": method,
              "test_acc": hist.test_acc, "seconds": secs,
              "launches": launches, "plain_calls": plain})
        if launches["packed_agg"] != 3 or any(plain.values()):
            raise AssertionError(f"{method}: launches {launches}, plain "
                                 f"{plain}")
        _leaves_on_card(last[2].adapters)


def phase_per_pair(last) -> dict:
    """The last main-path cohort again through the per-pair kernel path
    (two rbla_agg launches per pair), held against the plan's result."""
    import torch
    from repro_torch.core.strategy import get_strategy
    from repro_torch.kernels import runtime
    prev_state, updates, out_state = last
    ranks = torch.tensor([u.rank for u in updates], dtype=torch.int32,
                         device="cuda")
    runtime.reset_counts()
    got = get_strategy("rbla").aggregate_adapters(
        [u.adapters for u in updates], [u.n_examples for u in updates],
        r_max=MAIN_CFG["r_max"], client_ranks=ranks,
        prev_global=prev_state.adapters, use_plan=False)
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    err, scale = _rel_err(got, out_state.adapters)
    emit({"phase": "per_pair", "launches": launches, "plain_calls": plain,
          "max_abs_err": err, "tol": 2e-5 * scale})
    if launches["rbla_agg"] == 0 or any(plain.values()):
        raise AssertionError(f"per-pair path: launches {launches}, plain "
                             f"{plain}")
    if not err <= 2e-5 * scale:
        raise AssertionError("per-pair kernel path disagrees with the plan")
    _leaves_on_card(got)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({SRC})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, runtime
    runtime.full_fp32()

    env = runtime.bench_env()
    smi = env["nvidia_smi"]
    if not smi:
        raise RuntimeError("nvidia-smi did not report the card")
    emit({"phase": "env", "nvidia_smi": smi, "torch": env["torch_version"],
          "cuda": env["cuda_version"], "device": env["device_kind"],
          "count": env["n_devices"]})

    t0 = time.perf_counter()
    per_source = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source})

    summary = phase_kernels()
    emit({"phase": "kernels", "ok": True})

    hist, main_launches, last = phase_main_path()
    phase_plain_reference(hist, last)
    phase_other_methods()
    pair_launches = phase_per_pair(last)
    summary["packed_agg"]["launches"] = main_launches["packed_agg"]
    summary["rbla_agg"]["launches"] = pair_launches["rbla_agg"]

    emit({"kernels": list(summary.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
