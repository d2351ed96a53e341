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
* flora -- three flora rounds at ``stack_r_cap=512``: rounds 1 and 3 stack
  (one packed_stack launch per bucket), round 2 re-projects every pair by
  SVD; the same rounds with the plain versions on the card must agree, and
  one round at the default cap (2 r_max) re-projects and stacks nothing;
* robust -- one round each of rbla_clipped, rbla_trimmed and rbla_median
  (one packed_robust launch per bucket), each against its plain round;
  then rbla_clipped's cohort again at a clip that fires on half its rows;
* svd -- one svd round, against its plain round in product space;
* per_pair -- the last main-path cohort again through the per-pair
  rbla_agg path, the last flora cohort within the cap through flora_stack
  and the last robust cohort through per-pair packed_robust, each held
  against its plan's result;
* async_main -- ``run_async_simulation`` of the same model and clients,
  fully async rbla with polynomial staleness, 60 uploads: one axpy_fold
  launch per fold bucket and per base leaf, no plain version; then the
  same run with the plain versions on the card, which it must reproduce;
* async_semi -- the same with a buffer of 5: one packed_agg launch per
  bucket per flush;
* async_codecs -- the last cohort int8- and bf16-encoded into one buffered
  flush (packed_agg with fused dequantisation), against the fp32 flush
  within the codec's tolerance and against its plain version;
* async_bf16_accum -- bf16 accumulators with stochastic rounding and
  server momentum: bit-identical under one seed, near the fp32 run;
* async_methods -- one fully async pass each of zeropad, fedavg (the
  default fold: packed_agg and axpy_fold), flora (the streaming stack)
  and rbla_norm (replay);
* per_pair_fold -- one rbla fold with the packed path declined (two
  axpy_fold launches a pair), equal to the packed fold bit for bit.

Then the ``{"kernels": [...]}`` summary, the card's line from nvidia-smi,
and the device summary as the last line.  Any failure ends the run with a
non-zero exit.  Exits non-zero, printing no result, when there is no CUDA
device or no port beside the script.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
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
    "packed_robust": "src/repro/kernels/rbla_agg/kernel.py:256",
    "packed_stack": "src/repro/kernels/rbla_agg/kernel.py:335",
    "flora_stack": "src/repro/kernels/rbla_agg/kernel.py:390",
    "axpy_fold": "src/repro/kernels/rbla_agg/kernel.py:442",
}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"packed_agg": _CSRC + "rbla_agg.cu", "rbla_agg": _CSRC + "rbla_agg.cu",
          "packed_robust": _CSRC + "packed_robust.cu",
          "packed_stack": _CSRC + "flora_stack.cu",
          "flora_stack": _CSRC + "flora_stack.cu",
          "axpy_fold": _CSRC + "axpy_fold.cu"}
MLP_BUCKETS = ((64, 784), (256, 200), (64, 10))   # (rows, width), r_max=64
MLP_PAIR_SIDES = ((64, 784, 1), (64, 200, 4), (64, 10, 1))  # + count/round
N_CLIENTS = 10
ROBUST_MODES = ("clipped", "trimmed", "median")
#: flora's per-pair sides (width, count per round) at cap 512: A widths
#: 784, 200, 200 and transposed-B widths 200, 200, 10
FLORA_PAIR_SIDES = ((784, 1), (200, 4), (10, 1))
#: the segments of a flora round within the cap: the global at live rank 64
#: first, then the staircase cohort's ranks
FLORA_SEGS = (64, 6, 13, 19, 26, 32, 38, 45, 51, 58, 64)
#: one rbla fold of the MLP: its three packed buckets (rows, width) with
#: per-row rates, then the three base trainables (the biases) mixed at one
#: rate each
FOLD_BUCKETS = ((64, 784), (256, 200), (64, 10))
FOLD_BASE_LEAVES = ((200,), (200,), (10,))
#: relative Frobenius tolerance of an encoded flush against the fp32 one
#: (benchmarks/bench_async_agg.py CODEC_TOL): bf16 keeps 8 mantissa bits,
#: int8 one of 254 levels per row
CODEC_TOL = {"bf16": 1e-2, "int8": 2e-2}


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


def time_ms_back_to_back(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` calls of
    ``fn`` issued back to back, per call.  The host runs ahead of the card,
    so where a call's device work outlasts its host work this is the
    device time; :func:`time_ms` waits for each call and also counts the
    host work before the launch."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def _robust_bytes(x, masks, weights, prev, scales, out_dtype):
    """Bytes packed_robust must move: the owned rows of x, the masks,
    weights and scales, the prev rows of rows no client owns, the output."""
    n, r, d = x.shape
    owned = masks > 0
    b = int(owned.sum()) * d * x.element_size() + masks.numel() * 4 + n * 4
    b += r * d * out_dtype.itemsize
    if scales is not None:
        b += scales.numel() * 4
    if prev is not None:
        b += int((owned.sum(0) == 0).sum()) * d * out_dtype.itemsize
    return b


def check_robust_case(n, r, d, x_dtype, out_dtype, mode, with_prev, seed):
    import math
    import torch
    from repro_torch.kernels.rbla_agg import packed_robust, packed_robust_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with_scales = x_dtype == torch.int8
    x, _, masks, weights, prev, scales = _agg_inputs(
        n, r, d, x_dtype, gen, with_prev, with_scales, out_dtype)
    kw = dict(mode=mode, clip_norm=2.5, trim_frac=0.2, scales=scales,
              out_dtype=out_dtype)
    got = packed_robust(x, masks, weights, prev, **kw)
    want = packed_robust_ref(x, masks, weights, prev, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    scale = max(1.0, float(want.float().abs().max()))
    if out_dtype == torch.bfloat16:
        # element by element: both round one fp32 result to bf16 once, so
        # they differ by at most one bf16 ulp (<= 2^-7 |want|), plus the
        # fp32 summation-order error where a mean cancels near zero
        tol = 2.0 ** -7 * want.float().abs() + 1e-6 * scale
    else:
        tol = torch.full_like(diff, 2e-5 * scale)
    err_over_tol = float((diff / tol).max())
    ms = time_ms(lambda: packed_robust(x, masks, weights, prev, **kw))
    plain_ms = time_ms(lambda: packed_robust_ref(x, masks, weights, prev,
                                                 **kw))
    # the least work: clipped 2 passes of a multiply-add per owned element,
    # the order statistics n*log2(n) comparisons per element
    per_elem = 4 if mode == "clipped" else n * max(1, math.ceil(math.log2(n)))
    bms, by = bound(_robust_bytes(x, masks, weights, prev, scales, out_dtype),
                    per_elem * r * d)
    case = {"kernel": "packed_robust", "shape": [n, r, d], "mode": mode,
            "x_dtype": str(x_dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1], "prev": with_prev,
            "max_abs_err": err, "max_err_over_tol": err_over_tol,
            "tol": ("2^-7 |want| + 1e-6 max(1, max|want|) per element"
                    if out_dtype == torch.bfloat16 else 2e-5 * scale),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit(case)
    if not err_over_tol <= 1.0:
        raise AssertionError(f"packed_robust disagrees with its plain "
                             f"version: {case}")
    return case


def _stack_bytes(table, x):
    """Bytes a stack must move: the copied source rows, the table, the
    output."""
    rows = table.rows
    d = x.shape[-1]
    copied = int((rows[:, 0] != -2).sum())
    return (copied * d * x.element_size() + rows.size * 4
            + rows.shape[0] * d * x.element_size())


def check_stack_case(label, x, scales, prev, copies_x, copies_prev, out_rows,
                     table):
    """packed_stack on the card against its plain version: both are one
    fp32 multiply per element, so they agree exactly."""
    import torch
    from repro_torch.kernels.rbla_agg import packed_stack, packed_stack_ref
    kw = dict(copies_x=copies_x, copies_prev=copies_prev, out_rows=out_rows)
    got = packed_stack(x, scales, prev, table=table, **kw)
    want = packed_stack_ref(x, scales, prev, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = time_ms(lambda: packed_stack(x, scales, prev, table=table, **kw))
    plain_ms = time_ms(lambda: packed_stack_ref(x, scales, prev, **kw))
    bms, by = bound(_stack_bytes(table, x), out_rows * x.shape[-1])
    case = {"kernel": "packed_stack", "case": label,
            "shape": [*x.shape, out_rows], "x_dtype": str(x.dtype).split(".")[-1],
            "max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit(case)
    if err != 0.0:
        raise AssertionError(f"packed_stack disagrees with its plain "
                             f"version: {case}")
    return case


def check_flora_case(label, x, scales, segs, out_rows):
    import torch
    from repro_torch.kernels.rbla_agg import (flora_stack, flora_stack_ref,
                                              flora_table)
    got = flora_stack(x, scales, segs=segs, out_rows=out_rows)
    want = flora_stack_ref(x, scales, segs, out_rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = time_ms(lambda: flora_stack(x, scales, segs=segs, out_rows=out_rows))
    plain_ms = time_ms(lambda: flora_stack_ref(x, scales, segs, out_rows))
    table = flora_table(tuple(segs), out_rows, x.shape[1])
    bms, by = bound(_stack_bytes(table, x), out_rows * x.shape[-1])
    case = {"kernel": "flora_stack", "case": label,
            "shape": [*x.shape, out_rows], "x_dtype": str(x.dtype).split(".")[-1],
            "max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit(case)
    if err != 0.0:
        raise AssertionError(f"flora_stack disagrees with its plain "
                             f"version: {case}")
    return case


def check_axpy_case(label, y, x, alpha, generator_seed=None):
    """axpy_fold on the card against its plain version.  The kernel rounds
    its three fp32 operations as the plain version does, so they agree to
    the bit; the stated tolerance is 2e-5 max|want| in fp32 and one bf16
    ulp per element in bf16.  With a generator the fp32 result is rounded
    to bf16 stochastically: within one ulp of the plain fp32 fold, and the
    same bits for the same seed."""
    import torch
    from repro_torch.kernels.rbla_agg import axpy_fold, axpy_fold_ref

    def gen():
        return (None if generator_seed is None else
                torch.Generator(device="cuda").manual_seed(generator_seed))
    got = axpy_fold(y, x, alpha, generator=gen())
    exact = axpy_fold_ref(y, x, alpha, out_dtype=torch.float32)
    want = axpy_fold_ref(y, x, alpha)
    torch.cuda.synchronize()
    diff = (got.float() - (exact if generator_seed is not None
                           else want.float())).abs()
    err = float(diff.max())
    if y.dtype == torch.bfloat16:
        tol = 2.0 ** -7 * exact.abs() + 1e-30
        tol_text = "one bf16 ulp per element (2^-7 |want|)"
    else:
        tol = torch.full_like(diff, 2e-5 * max(1.0, float(want.abs().max())))
        tol_text = 2e-5 * max(1.0, float(want.abs().max()))
    ok = bool((diff <= tol).all())
    if generator_seed is not None:
        ok = ok and torch.equal(got, axpy_fold(y, x, alpha, generator=gen()))
    ms = time_ms(lambda: axpy_fold(y, x, alpha, generator=gen()))
    plain_ms = time_ms(lambda: axpy_fold_ref(y, x, alpha))
    r = y.shape[0] if y.ndim else 1
    if isinstance(alpha, torch.Tensor) and alpha.ndim:
        w = alpha.to(y.dtype)[(slice(None),) + (None,) * (y.ndim - 1)]
    else:
        w = float(alpha)
    yc, xc = y.contiguous(), x.to(y.dtype).contiguous()
    library_ms = time_ms(lambda: torch.lerp(yc, xc, w))
    device_ms = time_ms_back_to_back(
        lambda: axpy_fold(y, x, alpha, generator=gen()))
    library_device_ms = time_ms_back_to_back(lambda: torch.lerp(yc, xc, w))
    n = y.numel()
    per_row = isinstance(alpha, torch.Tensor) and alpha.ndim == 1
    bms, by = bound(n * (y.element_size() + x.element_size()
                         + y.element_size()) + (4 * r if per_row else 0),
                    3 * n)
    case = {"kernel": "axpy_fold", "case": label, "shape": list(y.shape),
            "y_dtype": str(y.dtype).split(".")[-1],
            "x_dtype": str(x.dtype).split(".")[-1],
            "contiguous": y.is_contiguous(), "per_row_alpha": per_row,
            "stochastic_rounding": generator_seed is not None,
            "max_abs_err": err, "tol": tol_text, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "back_to_back_ms": device_ms,
            "library_back_to_back_ms": library_device_ms}
    emit(case)
    if not ok:
        raise AssertionError(f"axpy_fold disagrees with its plain version: "
                             f"{case}")
    return case


def _fold_inputs(shape, gen, dtype=None, x_dtype=None, zero_rows=True):
    import torch
    f32 = torch.float32
    y = torch.randn(*shape, generator=gen, device="cuda").to(dtype or f32)
    x = torch.randn(*shape, generator=gen, device="cuda").to(
        x_dtype or dtype or f32)
    alpha = torch.rand(shape[0], generator=gen, device="cuda")
    if zero_rows:                       # rows the client does not own
        alpha[torch.rand(shape[0], generator=gen, device="cuda") < 0.3] = 0.0
    return y, x, alpha


def _flora_plan_layouts(r_max=64, cap=512):
    """The packed_stack buckets of a main-path flora round (the staircase
    cohort at r_max storage, a global of live rank r_max at cap storage):
    the real plan's copy lists and tables, with inputs of its shapes."""
    import torch
    from repro_torch.core import plan as tplan
    from repro_torch.core.strategy import get_strategy, stack_trees
    from repro_torch.models.paper_nets import PAPER_MODELS
    ranks = (6, 13, 19, 26, 32, 38, 45, 51, 58, 64)
    specs = PAPER_MODELS["mlp"]().lora_specs
    gen = torch.Generator(device="cuda").manual_seed(0)

    def pair(fo, fi, storage, rank):
        return {"A": torch.randn(storage, fi, generator=gen, device="cuda"),
                "B": torch.randn(fo, storage, generator=gen, device="cuda"),
                "rank": torch.tensor(rank, dtype=torch.int32, device="cuda")}
    clients = [{k: pair(fo, fi, r_max, r) for k, (fo, fi) in specs.items()}
               for r in ranks]
    prev = {k: pair(fo, fi, cap, r_max) for k, (fo, fi) in specs.items()}
    round_ = get_strategy("flora").with_options(stack_r_cap=cap).plan(
        None, tplan.build_cohort_spec(stack_trees(clients), kind="kernel",
                                      r_max=r_max, prev_tree=prev))
    return round_.stack_layouts


def _stack_inputs(lay, n, gen):
    import torch
    n_scales = lay["table"].n_scales
    d = lay["width"]
    x = torch.randn(n, lay["r_in"], d, generator=gen, device="cuda")
    prev = torch.randn(lay["r_prev"], d, generator=gen, device="cuda")
    scales = torch.rand(n_scales, generator=gen, device="cuda") + 0.5
    return x, scales, prev


def phase_kernels() -> dict:
    """Every case of every kernel; returns the per-kernel summary rows
    (times summed over one main-path round's launches: for packed_robust
    one round of each robust method)."""
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

    robust = []
    for n, r, d in shapes:
        for mode in ROBUST_MODES:
            for with_prev in (False, True):
                for x_dtype, out_dtype in ((f32, f32), (bf16, bf16),
                                           (i8, f32)):
                    seed += 1
                    robust.append(check_robust_case(
                        n, r, d, x_dtype, out_dtype, mode, with_prev, seed))
    # the smallest sort network, the 64-slot one, selection by counting
    for n in (1, 33, 70):
        for mode in ROBUST_MODES:
            seed += 1
            robust.append(check_robust_case(n, 64, 784, f32, f32, mode, True,
                                            seed))

    from repro_torch.kernels.rbla_agg import stack_table
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stack = []
    for lay in _flora_plan_layouts():
        x, scales, prev = _stack_inputs(lay, N_CLIENTS, gen)
        stack.append(check_stack_case(
            f"plan bucket {lay['width']}", x, scales, prev, lay["copies_x"],
            lay["copies_prev"], lay["out_rows"], lay["table"]))
    # large: a prev block, then 200 rows of each client; the tail is zero
    big_x = [(i, 0, 1024 + 200 * i, 200, 1 + i) for i in range(N_CLIENTS)]
    big_prev = [(0, 0, 1024, 0)]
    big_table = stack_table(big_x, big_prev, out_rows=4096, n=N_CLIENTS,
                            r_in=2048, r_prev=2048, n_scales=N_CLIENTS + 1)
    for dtype in (f32, bf16):
        x = torch.randn(N_CLIENTS, 2048, 4096, generator=gen,
                        device="cuda").to(dtype)
        prev = torch.randn(2048, 4096, generator=gen, device="cuda").to(dtype)
        scales = torch.rand(N_CLIENTS + 1, generator=gen, device="cuda")
        stack.append(check_stack_case("large", x, scales, prev, big_x,
                                      big_prev, 4096, big_table))
    flora = []
    for d, _ in FLORA_PAIR_SIDES:
        for dtype in (f32, bf16):
            x = torch.randn(N_CLIENTS + 1, 512, d, generator=gen,
                            device="cuda").to(dtype)
            scales = torch.rand(N_CLIENTS + 1, generator=gen, device="cuda")
            flora.append(check_flora_case(f"per-pair {d}", x, scales,
                                          FLORA_SEGS, 512))
    for dtype in (f32, bf16):
        x = torch.randn(N_CLIENTS, 2048, 4096, generator=gen,
                        device="cuda").to(dtype)
        scales = torch.rand(N_CLIENTS, generator=gen, device="cuda")
        flora.append(check_flora_case("large", x, scales,
                                      (200,) * N_CLIENTS, 4096))

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    axpy = []
    for r, d in FOLD_BUCKETS + ((512, 1024),):
        y, x, alpha = _fold_inputs((r, d), gen)
        axpy.append(check_axpy_case(f"bucket {r}x{d}", y, x, alpha))
    for shape in FOLD_BASE_LEAVES[1:]:          # (200,) and (10,)
        y, x, _ = _fold_inputs(shape, gen)
        axpy.append(check_axpy_case(f"base leaf {shape[0]}", y, x, 0.3))
    y, x, alpha = _fold_inputs((256, 200), gen, bf16)
    axpy.append(check_axpy_case("bf16 256x200", y, x, alpha))
    axpy.append(check_axpy_case("bf16 256x200 stochastic rounding", y, x,
                                alpha, generator_seed=5))
    y, x, alpha = _fold_inputs((200, 64), gen)
    axpy.append(check_axpy_case("transposed B 64x200", y.T, x.T,
                                alpha[:64]))
    for dtype in (f32, bf16):
        y, x, alpha = _fold_inputs((2048, 4096), gen, dtype)
        axpy.append(check_axpy_case(f"large {str(dtype)[6:]}", y, x, alpha))

    def main_path_sum(cases, match, counts):
        rows = {}
        for key, k in counts.items():
            hit = [c for c in cases if match(c, key)]
            if len(hit) != 1:
                raise AssertionError(f"no unique case for {key}")
            for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
                if hit[0][f] is not None:
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
    # one round of each robust method: its three buckets, fp32, with prev
    rb = main_path_sum(
        robust,
        lambda c, key: (tuple(c["shape"]) == (N_CLIENTS,) + key[1]
                        and c["mode"] == key[0] and c["x_dtype"] == "float32"
                        and c["prev"]),
        {(m, b): 1 for m in ROBUST_MODES for b in MLP_BUCKETS})
    # one stacking round: the plan's three buckets
    st = main_path_sum(stack, lambda c, key: c["case"] == key,
                       {f"plan bucket {w}": 1 for w in (784, 200, 10)})
    # one per-pair flora round: every A and transposed B side, fp32
    fl = main_path_sum(
        flora, lambda c, key: (c["case"] == f"per-pair {key[0]}"
                               and c["x_dtype"] == "float32"),
        {side: side[1] for side in FLORA_PAIR_SIDES})
    # one main-path rbla fold: its three buckets, then the three biases
    # (the two 200-wide ones share one case)
    ax = main_path_sum(
        axpy, lambda c, key: c["case"] == key,
        {**{f"bucket {r}x{d}": 1 for r, d in FOLD_BUCKETS},
         "base leaf 200": 2, "base leaf 10": 1})
    summary = {}
    for name, cases, row in (("packed_agg", packed, pk), ("rbla_agg", rbla, rk),
                             ("packed_robust", robust, rb),
                             ("packed_stack", stack, st),
                             ("flora_stack", flora, fl),
                             ("axpy_fold", axpy, ax)):
        summary[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row.get("library_ms")}
    return summary


# --------------------------------------------------------------- main path --
#: examples/quickstart.py: the paper's MNIST MLP at full width (784-200-200-10),
#: 10 staircase clients, r_max 64, 6 synchronous rbla rounds
MAIN_CFG = dict(dataset="mnist", model="mlp", method="rbla", rounds=6,
                n_clients=10, n_per_class=200, n_test_per_class=50,
                local_epochs=2, lr=0.05, r_max=64, seed=42)


class Recorder:
    """Wraps ``AggregationStrategy.aggregate`` for one run (on the class, so
    the configured copies a run makes with ``with_options`` are seen too).
    Keeps the strategy instance, the last round's (incoming state, updates,
    returned state), and per round the kernel launches it made and the
    plan it ran (its launches and the pairs it re-projected)."""

    def __init__(self):
        from repro_torch.core.strategy import AggregationStrategy
        from repro_torch.kernels import runtime
        self.cls, self.orig = AggregationStrategy, AggregationStrategy.aggregate
        self.strategy, self.last, self.rounds = None, None, []
        orig = self.orig

        def spy(strategy, state, updates, *a, **k):
            updates = list(updates)
            before = dict(runtime.LAUNCHES)
            out = orig(strategy, state, updates, *a, **k)
            plans = list(strategy.__dict__.get("_plan_cache", {}).values())
            self.rounds.append({
                "launches": {n: runtime.LAUNCHES[n] - before[n]
                             for n in runtime.KERNELS
                             if runtime.LAUNCHES[n] != before[n]},
                "plan_launches": plans[-1].n_kernel_launches,
                "fallback_pairs": plans[-1].n_fallback_pairs})
            self.strategy, self.last = strategy, (state, updates, out)
            return out
        AggregationStrategy.aggregate = spy

    def close(self):
        self.cls.aggregate = self.orig


def drive(cfg_kw: dict):
    """One ``run_simulation`` on the card with fresh counts; returns the
    history, the launch and plain-call counts, the recorded last round,
    the seconds and the per-round record."""
    import torch
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import runtime
    rec = Recorder()
    try:
        runtime.reset_counts()
        t0 = time.perf_counter()
        hist = run_simulation(FLConfig(**cfg_kw), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    finally:
        rec.close()
    return hist, launches, plain, rec.last, seconds, rec


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
    hist, launches, plain, last, secs, rec = drive(MAIN_CFG)
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
    return hist, launches, last, rec


def phase_plain_reference(hist, last):
    """The same run with the plain versions aggregating on the card: the
    kernels' rounds must reproduce it (same init, same batches)."""
    ref_hist, launches, plain, ref_last, secs, _ = drive(
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
        hist, launches, plain, last, secs, _ = drive(
            dict(MAIN_CFG, method=method, rounds=1))
        emit({"phase": "one_round", "method": method,
              "test_acc": hist.test_acc, "seconds": secs,
              "launches": launches, "plain_calls": plain})
        if launches["packed_agg"] != 3 or any(plain.values()):
            raise AssertionError(f"{method}: launches {launches}, plain "
                                 f"{plain}")
        _leaves_on_card(last[2].adapters)


def _products(tree) -> dict:
    """Each pair's product ``B @ A`` (fp32): what serving applies, and
    free of the signs an SVD leaves arbitrary."""
    from repro_torch.lora import is_pair
    return {k: p["B"].float() @ p["A"].float() for k, p in tree.items()
            if is_pair(p)}


def _product_err(got_tree, want_tree) -> tuple[float, float]:
    err = scale = 0.0
    g, w = _products(got_tree), _products(want_tree)
    for k in w:
        err = max(err, float((g[k] - w[k]).abs().max()))
        scale = max(scale, float(w[k].abs().max()))
    return err, scale


def _against_plain(cfg_kw, hist, last, phase):
    """The same run aggregating with the plain versions on the card: the
    same accuracy, and adapters within 1e-4 of max|B @ A| in product space
    (the kernels and the plain versions do the same fp32 arithmetic; the
    tolerance covers a different summation order)."""
    ref_hist, launches, plain, ref_last, secs, _ = drive(
        dict(cfg_kw, agg_backend="ref"))
    err, scale = _product_err(last[2].adapters, ref_last[2].adapters)
    emit({"phase": phase + "_plain", "test_acc": ref_hist.test_acc,
          "seconds": secs, "plain_calls": plain,
          "product_max_abs_err": err, "tol": 1e-4 * scale})
    if any(launches.values()):
        raise AssertionError(f"{phase}: the ref backend launched {launches}")
    if ref_hist.test_acc != hist.test_acc or not err <= 1e-4 * scale:
        raise AssertionError(f"{phase}: kernel rounds disagree with plain "
                             f"rounds ({hist.test_acc} vs "
                             f"{ref_hist.test_acc}, err {err})")


#: flora at a cap the quickstart cohort (ranks 6..64, sum 352) alternates
#: under: 64 + 352 = 416 rows stack in round 1, 416 + 352 = 768 > 512
#: re-project to 64 in round 2, and round 3 stacks 416 again
FLORA_CFG = dict(MAIN_CFG, method="flora", stack_r_cap=512, rounds=3)


def phase_flora():
    hist, launches, plain, last, secs, rec = drive(FLORA_CFG)
    per_round = [(r["launches"].get("packed_stack", 0), r["fallback_pairs"])
                 for r in rec.rounds]
    live = sorted({int(p["rank"]) for p in last[2].adapters.values()})
    emit({"phase": "flora", "config": FLORA_CFG, "test_acc": hist.test_acc,
          "round_time_s": hist.round_time_s, "seconds": secs,
          "launches": launches, "plain_calls": plain,
          "rounds": rec.rounds, "live_rank": live})
    if per_round != [(3, 0), (0, 3), (3, 0)]:
        raise AssertionError(f"flora rounds (packed_stack launches, "
                             f"re-projected pairs): {per_round}")
    if launches["packed_stack"] != 6 or any(plain.values()) or live != [416]:
        raise AssertionError(f"flora: launches {launches}, plain {plain}, "
                             f"live rank {live}")
    _leaves_on_card(last[2].adapters)
    _against_plain(FLORA_CFG, hist, last, "flora")

    # the default cap (2 r_max = 128) never stacks this cohort
    hist1, launches1, _, _, secs1, rec1 = drive(
        dict(MAIN_CFG, method="flora", rounds=1))
    emit({"phase": "flora_default_cap", "test_acc": hist1.test_acc,
          "seconds": secs1, "launches": launches1, "rounds": rec1.rounds})
    if launches1["packed_stack"] != 0 or rec1.rounds[0]["fallback_pairs"] != 3:
        raise AssertionError(f"flora at the default cap: {rec1.rounds}")
    return launches, rec


def phase_robust():
    out = {}
    for method in ("rbla_clipped", "rbla_trimmed", "rbla_median"):
        cfg = dict(MAIN_CFG, method=method, rounds=1)
        hist, launches, plain, last, secs, rec = drive(cfg)
        emit({"phase": "robust", "method": method, "test_acc": hist.test_acc,
              "seconds": secs, "launches": launches, "plain_calls": plain})
        if launches["packed_robust"] != 3 or any(plain.values()):
            raise AssertionError(f"{method}: launches {launches}, plain "
                                 f"{plain}")
        _leaves_on_card(last[2].adapters)
        _against_plain(cfg, hist, last, method)
        out[method] = (launches, rec)
    return out


def _row_norms(updates):
    """The L2 norm of every owned rank-row the clip sees: each client's
    live A rows and B columns (the packed rows of the robust plan)."""
    import torch
    from repro_torch.lora import is_pair
    norms = []
    for u in updates:
        for p in u.adapters.values():
            if is_pair(p):
                r = int(p["rank"])
                norms += [p["A"][:r].float().norm(dim=-1),
                          p["B"][:, :r].float().norm(dim=0)]
    return torch.cat(norms)


def phase_robust_clip(rec):
    """rbla_clipped's round again at a clip that fires.  The default clip
    (100) is above every rank-row of this cohort, so that round is plain
    rbla; at the median row norm half the rows clip.  The kernel plan must
    match its plain version and differ from the unclipped round."""
    import torch
    from repro_torch.kernels import runtime
    prev_state, updates, out_state = rec.last
    norms = _row_norms(updates)
    clip = float(norms.median())
    strat = rec.strategy.with_options(clip_norm=clip)
    args = ([u.adapters for u in updates], [u.n_examples for u in updates])
    kw = dict(r_max=MAIN_CFG["r_max"], prev_global=prev_state.adapters,
              client_ranks=torch.tensor([u.rank for u in updates],
                                        dtype=torch.int32, device="cuda"))
    runtime.reset_counts()
    got = strat.aggregate_adapters(*args, **kw)
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    want = strat.aggregate_adapters(*args, backend="ref", **kw)
    err, scale = _rel_err(got, want)
    moved, _ = _rel_err(got, out_state.adapters)
    emit({"phase": "robust_clip_fires", "rows": norms.numel(),
          "rows_over_default_clip": int((norms > rec.strategy.clip_norm).sum()),
          "clip_norm": clip, "rows_clipped": int((norms > clip).sum()),
          "launches": launches, "plain_calls": plain, "max_abs_err": err,
          "tol": 2e-5 * scale, "moved_from_default_clip": moved})
    if launches["packed_robust"] != 3 or any(plain.values()):
        raise AssertionError(f"robust_clip_fires: launches {launches}, "
                             f"plain {plain}")
    if not err <= 2e-5 * scale:
        raise AssertionError("robust_clip_fires: the kernel plan disagrees "
                             "with its plain version")
    if not (int((norms > clip).sum()) > 0 and moved > 100 * 2e-5 * scale):
        raise AssertionError("robust_clip_fires: the clip did not change "
                             "the round")
    _leaves_on_card(got)


def phase_svd():
    cfg = dict(MAIN_CFG, method="svd", rounds=1)
    hist, launches, plain, last, secs, _ = drive(cfg)
    emit({"phase": "svd", "test_acc": hist.test_acc, "seconds": secs,
          "launches": launches, "plain_calls": plain})
    if any(plain.values()):
        raise AssertionError(f"svd: plain {plain}")
    _leaves_on_card(last[2].adapters)
    _against_plain(cfg, hist, last, "svd")


def phase_per_pair(rec, kernel, want_launches, tol_rel, phase):
    """The recorded last cohort of ``rec`` through the strategy's per-pair
    kernel path (``use_plan=False``), held against the plan's result."""
    import torch
    from repro_torch.kernels import runtime
    prev_state, updates, out_state = rec.last
    ranks = torch.tensor([u.rank for u in updates], dtype=torch.int32,
                         device="cuda")
    runtime.reset_counts()
    got = rec.strategy.aggregate_adapters(
        [u.adapters for u in updates], [u.n_examples for u in updates],
        r_max=MAIN_CFG["r_max"], client_ranks=ranks,
        prev_global=prev_state.adapters, use_plan=False)
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    err, scale = _rel_err(got, out_state.adapters)
    emit({"phase": phase, "launches": launches, "plain_calls": plain,
          "max_abs_err": err, "tol": tol_rel * scale})
    if launches[kernel] != want_launches or any(plain.values()):
        raise AssertionError(f"{phase}: launches {launches}, plain {plain}")
    if not err <= tol_rel * scale:
        raise AssertionError(f"{phase}: the per-pair kernel path disagrees "
                             "with the plan")
    _leaves_on_card(got)
    return launches


# -------------------------------------------------------------- async slice --
#: the async FLaaS service on the main path's model and clients: fully
#: async rbla, polynomial staleness, 60 uploads, an evaluation every 10
ASYNC_CFG = dict(MAIN_CFG, buffer_size=1, staleness="polynomial",
                 total_updates=60, eval_every=10)


class AsyncRecorder:
    """Wraps ``AsyncAggregator.submit`` for one run: keeps the service and
    each client's last upload (the staircase gives every client its own
    rank, so the rank names the client)."""

    def __init__(self):
        from repro_torch.fl import AsyncAggregator
        self.cls, self.orig = AsyncAggregator, AsyncAggregator.submit
        self.agg, self.last = None, {}
        orig = self.orig

        def spy(agg, update, *a, **k):
            self.agg, self.last[update.rank] = agg, update
            return orig(agg, update, *a, **k)
        AsyncAggregator.submit = spy

    def close(self):
        self.cls.submit = self.orig

    def cohort(self) -> list:
        return [self.last[r] for r in sorted(self.last)]


def drive_async(cfg_kw: dict):
    """One ``run_async_simulation`` on the card with fresh counts; returns
    the history, the launch and plain-call counts, the recorder (the
    service and the last cohort) and the seconds."""
    import torch
    from repro_torch.fl import AsyncFLConfig, run_async_simulation
    from repro_torch.kernels import runtime
    rec = AsyncRecorder()
    try:
        runtime.reset_counts()
        t0 = time.perf_counter()
        hist = run_async_simulation(AsyncFLConfig(**cfg_kw), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    finally:
        rec.close()
    return hist, launches, plain, rec, seconds


def _async_line(phase, cfg, hist, launches, plain, rec, secs, **extra):
    emit({"phase": phase, "config": cfg, "test_acc": hist.test_acc,
          "sim_time_s": hist.sim_time_s,
          "mean_staleness": hist.mean_staleness,
          "round_time_s": hist.round_time_s, "seconds": secs,
          "n_folded": rec.agg.n_folded, "n_flushes": rec.agg.n_flushes,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v}, **extra})


def phase_async_main():
    hist, launches, plain, rec, secs = drive_async(ASYNC_CFG)
    folds = rec.agg.n_folded
    per_fold = launches["axpy_fold"] / max(folds, 1)
    _async_line("async_main", ASYNC_CFG, hist, launches, plain, rec, secs,
                axpy_fold_per_fold=per_fold)
    want = len(FOLD_BUCKETS) + len(FOLD_BASE_LEAVES)
    if folds != ASYNC_CFG["total_updates"] or per_fold != want:
        raise AssertionError(f"async_main: {launches['axpy_fold']} axpy_fold "
                             f"launches over {folds} folds, expected {want} "
                             "a fold")
    if any(plain.values()) or any(v for k, v in launches.items()
                                  if k != "axpy_fold"):
        raise AssertionError(f"async_main: launches {launches}, plain "
                             f"{plain}")
    # a fully async running mean over every upload since the anchor moves
    # slowly (the CPU run of this config stays near 0.08): the run is held
    # to its plain-version twin below, not to an accuracy floor
    if not (len(hist.test_acc) == 6 and all(0.0 <= a <= 1.0 for a in
                                            hist.test_acc)
            and all(math.isfinite(v) for v in hist.train_loss)):
        raise AssertionError(f"async_main: history {hist}")
    _leaves_on_card(rec.agg.state.adapters)
    _leaves_on_card(rec.agg.state.base_trainable)

    # the same run folding with the plain versions on the card
    ref_hist, ref_launches, ref_plain, ref_rec, ref_secs = drive_async(
        dict(ASYNC_CFG, agg_backend="ref"))
    err, scale = _rel_err(rec.agg.state.adapters, ref_rec.agg.state.adapters)
    emit({"phase": "async_main_plain", "test_acc": ref_hist.test_acc,
          "seconds": ref_secs, "plain_calls": ref_plain,
          "adapters_max_abs_err": err, "tol": 2e-5 * scale})
    if any(ref_launches.values()) or ref_plain["axpy_fold"] != \
            launches["axpy_fold"]:
        raise AssertionError("async_main_plain: the ref backend did not run "
                             "the plain version")
    if ref_hist.test_acc != hist.test_acc or not err <= 2e-5 * scale:
        raise AssertionError(f"async_main: kernel folds disagree with plain "
                             f"folds ({hist.test_acc} vs {ref_hist.test_acc}"
                             f", err {err})")
    return launches, rec


def phase_async_semi():
    cfg = dict(ASYNC_CFG, buffer_size=5)
    hist, launches, plain, rec, secs = drive_async(cfg)
    _async_line("async_semi", cfg, hist, launches, plain, rec, secs)
    flushes = rec.agg.n_flushes
    if flushes != cfg["total_updates"] // 5 or \
            launches["packed_agg"] != 3 * flushes or any(plain.values()):
        raise AssertionError(f"async_semi: {flushes} flushes, launches "
                             f"{launches}, plain {plain}")
    _leaves_on_card(rec.agg.state.adapters)


def _frobenius(got, want) -> float:
    """Relative Frobenius distance over the float leaves."""
    from repro_torch.tree import tree_leaves
    num = den = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if w.is_floating_point():
            num += float(((g.float() - w.float()) ** 2).sum())
            den += float((w.float() ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def _flush_cohort(state, updates, codec="none", backend="auto", **kw):
    """One buffered flush of ``updates`` (encoded with ``codec``) into a
    fresh service at ``state``; returns the service and the counts."""
    import torch
    from repro_torch.core.codec import encode_update
    from repro_torch.fl import AsyncAggregator
    from repro_torch.kernels import runtime
    agg = AsyncAggregator("rbla", state, buffer_size=len(updates),
                          backend=backend, **kw)
    runtime.reset_counts()
    for u in updates:
        agg.submit(encode_update(u, codec))
    torch.cuda.synchronize()
    return agg, dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)


def phase_async_codecs(rec):
    """The last cohort of async_main, encoded, into one buffered flush."""
    state, cohort = rec.agg.state, rec.cohort()
    base, _, _ = _flush_cohort(state, cohort)
    out = {}
    for codec in ("int8", "bf16"):
        agg, launches, plain = _flush_cohort(state, cohort, codec)
        ref, _, ref_plain = _flush_cohort(state, cohort, codec,
                                          backend="ref")
        rel = _frobenius(agg.state.adapters, base.state.adapters)
        err, scale = _rel_err(agg.state.adapters, ref.state.adapters)
        emit({"phase": "async_codecs", "codec": codec, "clients": len(cohort),
              "launches": {k: v for k, v in launches.items() if v},
              "plain_calls": {k: v for k, v in plain.items() if v},
              "wire_bytes": agg.wire_bytes_received,
              "fp32_wire_bytes": base.wire_bytes_received,
              "rel_frobenius_vs_fp32": rel, "codec_tol": CODEC_TOL[codec],
              "plain_max_abs_err": err, "plain_tol": 2e-5 * scale})
        if launches["packed_agg"] != 3 or any(plain.values()) or \
                ref_plain["packed_agg"] != 3:
            raise AssertionError(f"async_codecs {codec}: launches "
                                 f"{launches}, plain {plain}")
        if not (rel <= CODEC_TOL[codec] and err <= 2e-5 * scale):
            raise AssertionError(f"async_codecs {codec}: {rel} vs fp32, "
                                 f"{err} vs its plain version")
        _leaves_on_card(agg.state.adapters)
        out[codec] = launches
    return out


def phase_async_bf16_accum(rec):
    """bf16 accumulators with stochastic rounding and server momentum: the
    last cohort folded one update at a time.  The same seed gives the same
    bits; the result stays within the bf16 tolerance of the fp32 run."""
    import torch
    from repro_torch.fl import AsyncAggregator
    from repro_torch.kernels import runtime
    from repro_torch.tree import tree_leaves
    state, cohort = rec.agg.state, rec.cohort()

    def run(accum):
        agg = AsyncAggregator("rbla", state, accum_dtype=accum,
                              server_momentum=0.5, seed=0)
        for u in cohort:
            agg.submit(u)
        torch.cuda.synchronize()
        return agg
    runtime.reset_counts()
    a = run(torch.bfloat16)
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    b, fp32 = run(torch.bfloat16), run(None)
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a.state.adapters), tree_leaves(b.state.adapters)))
    rel = _frobenius(a.state.adapters, fp32.state.adapters)
    emit({"phase": "async_bf16_accum", "folds": a.n_folded,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v},
          "bit_identical_under_one_seed": same,
          "rel_frobenius_vs_fp32": rel, "tol": 2e-2,
          "dtype": str(a.state.adapters["fc1"]["A"].dtype)})
    if not same or not rel <= 2e-2 or any(plain.values()):
        raise AssertionError("async_bf16_accum failed")
    if a.state.adapters["fc1"]["A"].dtype != torch.bfloat16:
        raise AssertionError("async_bf16_accum: accumulators are not bf16")
    _leaves_on_card(a.state.adapters)


def phase_async_methods():
    """One fully async pass (one upload per client) of each other method:
    zeropad and fedavg take the default fold (a one-client packed_agg
    round, then axpy_fold per float leaf), flora its streaming stack (base
    leaves through axpy_fold) and rbla_norm the replay path (packed_agg
    with norm_restore over the updates since the anchor)."""
    n = ASYNC_CFG["n_clients"]
    per_fold = {"zeropad": {"packed_agg": 3, "axpy_fold": 9},
                "fedavg": {"packed_agg": 3, "axpy_fold": 9},
                "flora": {"axpy_fold": 3},
                "rbla_norm": {"packed_agg": 3}}
    for method, want in per_fold.items():
        cfg = dict(ASYNC_CFG, method=method, total_updates=n, eval_every=n)
        hist, launches, plain, rec, secs = drive_async(cfg)
        _async_line("async_methods", {"method": method}, hist, launches,
                    plain, rec, secs)
        got = {k: v for k, v in launches.items() if v}
        if got != {k: v * n for k, v in want.items()} or any(plain.values()):
            raise AssertionError(f"async_methods {method}: launches {got}, "
                                 f"plain {plain}")
        _leaves_on_card(rec.agg.state.adapters)


def phase_per_pair_fold(rec):
    """One rbla fold of the last cohort's first upload into the final
    async_main state, packed and with the packed path declined."""
    import torch
    from repro_torch.core.strategy import get_strategy
    from repro_torch.kernels import runtime
    from repro_torch.tree import tree_leaves
    strat, state, upd = get_strategy("rbla"), rec.agg.state, rec.cohort()[0]
    counts = []
    outs = []
    for use_plan in (True, False):
        runtime.reset_counts()
        out, _ = strat.fold(state, upd, use_plan=use_plan)
        torch.cuda.synchronize()
        counts.append((dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)))
        outs.append(out)
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves((outs[0].adapters, outs[0].base_trainable)),
        tree_leaves((outs[1].adapters, outs[1].base_trainable))))
    n_pairs = len(state.adapters)
    emit({"phase": "per_pair_fold",
          "packed_launches": counts[0][0]["axpy_fold"],
          "per_pair_launches": counts[1][0]["axpy_fold"],
          "plain_calls": sum(sum(c[1].values()) for c in counts),
          "bit_identical": same})
    if (counts[0][0]["axpy_fold"] != 3 + len(FOLD_BASE_LEAVES)
            or counts[1][0]["axpy_fold"] != 2 * n_pairs + len(FOLD_BASE_LEAVES)
            or any(sum(c[1].values()) for c in counts) or not same):
        raise AssertionError("per_pair_fold: the per-pair fold does not "
                             "reproduce the packed fold")


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
    t_start = time.perf_counter()
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

    hist, main_launches, last, main_rec = phase_main_path()
    phase_plain_reference(hist, last)
    phase_other_methods()
    flora_launches, flora_rec = phase_flora()
    robust = phase_robust()
    phase_robust_clip(robust["rbla_clipped"][1])
    phase_svd()
    # the per-pair paths on each phase's last cohort: 2 launches a pair
    pair_launches = phase_per_pair(main_rec, "rbla_agg", 6, 2e-5, "per_pair")
    # the last flora cohort is round 3's, within the cap: pure copies with
    # the plan's scale arithmetic up to its order (a few ulp of B)
    stack_launches = phase_per_pair(flora_rec, "flora_stack", 6, 1e-6,
                                    "per_pair_flora")
    robust_launches = phase_per_pair(robust["rbla_median"][1],
                                     "packed_robust", 6, 2e-5,
                                     "per_pair_robust")
    summary["packed_agg"]["launches"] = main_launches["packed_agg"]
    summary["rbla_agg"]["launches"] = pair_launches["rbla_agg"]
    summary["packed_robust"]["launches"] = sum(
        launches["packed_robust"] for launches, _ in robust.values())
    summary["packed_stack"]["launches"] = flora_launches["packed_stack"]
    summary["flora_stack"]["launches"] = stack_launches["flora_stack"]

    async_launches, async_rec = phase_async_main()
    phase_async_semi()
    phase_async_codecs(async_rec)
    phase_async_bf16_accum(async_rec)
    phase_async_methods()
    phase_per_pair_fold(async_rec)
    summary["axpy_fold"]["launches"] = async_launches["axpy_fold"]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    emit({"kernels": list(summary.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
