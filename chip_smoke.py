#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases agg_rounds,lora_kernels [--src DIR]

With no arguments every phase runs.  ``--phases`` runs only the named
independent phases (after env and build); ``--src`` runs them against
another checkout's ``src/`` (the parent commit's, say), so that two
versions are timed in one process order on one card; checks of this
checkout's design alone (the serve call's device kernels) are then
reported and not enforced.

Phases, each printing JSON lines:

* env -- the card's name and power limit, torch and CUDA versions;
* build -- nvcc of every kernel source into ``build/kernels/``;
* kernels -- every kernel held against its plain PyTorch version on the
  card, at the paper MLP's bucket shapes and one large shape, with its time,
  the plain version's time and the HBM bound; packed_agg and packed_robust
  also as one grouped call of a main-path round (the unit of their rows:
  rbla's mean, and each robust mode), packed_stack as one grouped call of
  a flora plan's stacking round (the real plan's 6 segments, fp32 and
  bf16, and one large call; its copy-list form on the same round's three
  buckets and one large bucket beside it), rbla_agg and flora_stack as one
  grouped call of a per-pair round (6 segments; their one-segment forms
  per pair side too, the unit of their rows before) and at one large
  shape each, back to back, the device's time alone and the device
  kernels of one call; axpy_fold also as grouped
  calls (a whole rbla fold of the MLP in fp32 and bf16, a column-mode B, a
  ragged width, a mixed-dtype fold that launches twice, a large fold)
  beside ``torch._foreach_lerp`` and the sum of one ``torch.lerp`` a
  segment;
* agg_rounds -- ``CompiledRound.__call__`` on the main-path cohort (the
  MLP's three pairs, 10 staircase clients, r_max 64, fp32, with prev) for
  rbla, fedavg, rbla_norm, rbla_clipped, rbla_trimmed, rbla_median, an
  int8 and a mixed-codec rbla cohort and flora's stacking round at
  ``stack_r_cap=512`` (a global at storage 512, live rank 64): wall,
  back-to-back and graph ms and the device kernels of one call (one
  grouped launch and nothing else, enforced), each against the plain
  round; runs on an older port too (``--src``);
* per_pair_rounds -- ``aggregate_tree_kernel``, the per-pair round (the
  mean family's fallback without a plan, flora's per-pair stacking), on
  the same cohort for rbla, zeropad and rbla_ranked and on a flora cohort
  within the cap (a global at storage 512, live rank 64): wall,
  back-to-back and graph ms and the device kernels and copies of one call
  (one grouped kernel for rbla, zeropad and flora, enforced), each against
  the plain path; runs on an older port too (``--src``);
* robust_large (selectable, not in the default run) -- packed_robust at
  (10, 2048, 4096) fp32 with prev in each mode: wrapper, back-to-back and
  graph ms, each device kernel's time (torch.profiler) and the HBM bound;
  runs on an older port too (``--src``);
* main_path -- ``run_simulation`` of ``examples/quickstart.py`` (the MNIST
  MLP at full width, 10 clients, r_max 64, 6 rbla rounds) with the launch
  counts of that run: one grouped packed_agg launch per round, no plain
  version;
* plain_reference -- the same run aggregating with the plain versions on
  the card; the kernel run must reproduce it;
* one_round -- one round each of rbla_norm (the norm_restore path) and
  zeropad;
* flora -- three flora rounds at ``stack_r_cap=512``: rounds 1 and 3 stack
  (one grouped packed_stack launch a round; the last stacking round's
  profile holds that one kernel and nothing else, enforced), round 2
  re-projects every pair by SVD; the same rounds with the plain versions
  on the card must agree, and one round at the default cap (2 r_max)
  re-projects and stacks nothing;
* robust -- one round each of rbla_clipped, rbla_trimmed and rbla_median
  (one grouped packed_robust launch a round), each against its plain round;
  then rbla_clipped's cohort again at a clip that fires on half its rows;
* svd -- one svd round, against its plain round in product space;
* per_pair -- the last main-path cohort again through the per-pair
  rbla_agg path and the last flora cohort within the cap through
  flora_stack (one grouped launch a round, and one device kernel in a
  round's profile, enforced), and the last robust cohort through per-pair
  packed_robust (one grouped launch a pair), each held against its plan's
  result;
* async_main -- ``run_async_simulation`` of the same model and clients,
  fully async rbla with polynomial staleness, 60 uploads: one grouped
  axpy_fold launch a fold, no plain version; then the same run with the
  plain versions on the card, which it must reproduce;
* async_semi -- the same with a buffer of 5: one packed_agg launch per
  flush;
* async_codecs -- the last cohort int8- and bf16-encoded into one buffered
  flush (packed_agg with fused dequantisation), against the fp32 flush
  within the codec's tolerance and against its plain version;
* async_bf16_accum -- bf16 accumulators with stochastic rounding and
  server momentum: bit-identical under one seed, near the fp32 run;
* async_methods -- one fully async pass each of zeropad, fedavg (the
  default fold: packed_agg and axpy_fold), flora (the streaming stack)
  and rbla_norm (replay);
* per_pair_fold -- one rbla fold with the fold plan declined (rates built
  pair by pair, still one launch), equal to the planned fold bit for bit;
* async_durable -- the durable service (write-ahead log and checkpoints
  every 16 accepted uploads in a temporary directory) at the same width
  under a chaos plan (drops and retries, duplicates, reordering,
  corrupt and truncated uploads, stale pulls), each case against the same
  plan without crashes: (a) the streaming fold with crash-restarts after
  13, 29 and 47 received uploads, bit for bit, the replays launching
  axpy_fold and no plain version, and the same plan without a WAL (what
  the journal costs: checkpoint ms and bytes, restore + replay ms and
  records, WAL bytes and journal ms per record, beside the card's name
  and power limit); (b) a buffer of 5, the replays' flushes launching
  packed_agg, bit for bit; (c) bf16 accumulators stochastically rounded
  from the card's generator, bit for bit; (d) (a) with the plain versions
  on the card, within 2e-5 of max|want| of (a); (e) rbla_median over 10
  uploads with one crash, replayed from the anchor through packed_robust,
  within 2e-5 of max|want|;
* lora_kernels -- batched_lora_matmul and lora_matmul against their plain
  versions at the MLP's three serving paths (500 test rows, 11 slots x
  r_max 64), at bench_serve's full case (512 x 512 x 512, 128 tenants x
  r_max 8) and at M = K = N = 4096 with 2048 packed rows (and once more
  with every tenant at rank 0: the base product alone), fp32 and bf16,
  NaN/Inf outside the live segments and rank-0 slots in every case; time,
  back-to-back time, the device's time alone (a CUDA graph), the plain
  version's time, the bound at the fp32 SIMT rate and at the tensor
  cores' (TF32 for fp32), the base product's ``torch.matmul`` time beside
  it, and the device kernels of one call (``torch.profiler``) for every
  lora_matmul case and batched_lora_matmul's serve and large ones (the
  serve call's two kernels and lora_matmul's down_gemm and gemm, once
  each and nothing else, enforced);
* serve_main -- bench_serve's full case through the port's AdapterStore and
  ServingEngine (128 tenants, width 512, batches of 512, 8 mixed batches):
  parity with merged_reference, requests/s, then 4 aggregate -> publish ->
  serve rounds through an AsyncAggregator whose on_publish is the
  engine's publisher, and parity again; one batched_lora_matmul launch per
  apply, no plain version;
* serve_mlp -- the final global of main_path published into a store of the
  10 staircase clients at their ranks plus the null slot; the test set
  served with mixed client ids layer by layer, held against
  merged_reference and against the MLP's forward with each client's
  re-sliced adapters; a publish under a live pin leaves the pinned batch
  unchanged;
* serve_streams -- the store's three cross-stream hazards on two streams,
  each held open by ``torch.cuda._sleep``: write after read, read after
  write, free while read (capacity growth);
* serve_dense -- lora_dense_apply on each MLP layer of the final global
  against the plain dense layer;
* obs -- one ServiceHealth snapshot of serve_main's service and store;
* ssd_kernels -- ssd_scan against its plain version in fp32 and bf16 at
  tests/test_kernels.py's four SSD shapes, one mamba2-1.3b layer at batch 1
  and 4 (L 2048, 64 heads x 64, state 128, chunk 256), L = 2000 (Q 250), a
  prime L (Q 1) and a decay past -100 within a chunk; time, back-to-back
  time, the plain version's time, the bound (fp32 operations over 67
  TFLOP/s) and the same work over the TF32 tensor-core rate, and the
  launch count (one a call, whatever the kernel's phases); at the two
  mamba2-1.3b layers also each phase's device time (``torch.profiler``);
* mamba_main -- ``repro_torch.launch.serve``'s path at full width:
  mamba2-1.3b in bf16, batch 4, a 2048-token prompt, 16 new tokens,
  adapters at rank 8 of r_max 64 with a live B; 48 ssd_scan launches for
  the prefill, no plain call, finite logits; prefill ms, decode tokens/s
  and peak device memory;
* mamba_plain -- the same prefill with the plain scan on the card (0
  launches, 48 plain calls); each bf16 layer's mixer output from the
  kernel path's input within 2e-2 of max|want| of the same layer with the
  plain scan on fp32-upcast operands, and the whole prefill in fp32 within
  2e-3 of its plain twin's logits;
* mamba_consistency -- the serve invariant at full width and depth (batch
  1, 512 tokens prefilled, 8 decoded) against forward(mode="full"), in
  fp32 within 2e-3 of max|want|; the bf16 run's distance is recorded;
* attn_main -- ``repro_torch.launch.serve``'s path at full width and
  depth: h2o-danube-3-4b in bf16 (24 layers, d_model 3840, 32 query and 8
  KV heads x 120, d_ff 10240, vocab 32000, SWA window 4096), batch 4, a
  2048-token prompt into KV caches of 2064 slots, 16 new tokens, adapters
  at rank 8 of r_max 64 with a live B; then Model.loss (bf16, 1 x 512) and
  its gradient with respect to the adapters; prefill ms, decode ms a step
  and tokens/s, peak device memory, parameter count and bytes; finite
  logits, tokens within the vocab, and no kernel launch and no plain call
  across the phase (no kernel lies on the attention path);
* attn_consistency -- the serve invariant for the same weights upcast to
  fp32 at full width and depth (batch 1, 512 tokens prefilled, 8 decoded)
  against forward(mode="full"), TF32 off, within 2e-3 of max|want|; the
  bf16 run's distance is recorded;
* attn_zoo -- the same invariant at full width in fp32, each depth cut to
  one repeat of its unit (stated on its line): h2o-danube-3-4b with a
  256-token window (320 prefilled, 64 decoded: the ring wraps), yi-34b,
  chatglm3-6b (half RoPE, kv 2, QKV bias) and gemma2-9b (one local and one
  global layer, query scale, both softcaps, post-block norms, GeGLU, tied
  256,000-word embeddings), each within 2e-3 of max|want|;
* moe_main, moe_consistency, moe_zoo, moe_ep -- granite-moe-3b-a800m at
  full depth in bf16 with one rbla round over four clients' expert pairs
  (one packed_agg launch), its fp32 serve invariant, jamba and deepseek at
  full width, the expert-parallel layer;
* vlm_main -- phi-3-vision-4.2b at full depth in bf16: 576 patches before
  a 2048-token prompt, batch 4, 16 new tokens, then Model.loss and its
  adapter gradient; prefill ms and its device split, decode ms a step
  and its device split, peak memory; no launch and no plain call;
* encdec_main -- whisper-large-v3 at full depth in bf16 (32 encoder and
  32 decoder layers): 1500 frames, a 432-token prompt, batch 4, 16 new
  tokens, the same figures, then the loss and its gradient at 1 x 1500 x
  256;
* frontend_consistency -- both archs' weights upcast to fp32 in place,
  prefill + 8 decode steps against the full forward within 2e-3 of
  max|want|;
* frontend_round -- one rbla round over four clients' whole whisper
  adapter trees (``enc``, ``frontend``, ``stages``) at ranks 8-64: one
  packed_agg launch and no plain call, enforced, against the plain
  round, with ms against the HBM bound of the live rows;
* train_main -- ``repro_torch.launch.train.main`` at the full preset
  (h2o-danube-3-4b, 20 steps; mamba2-1.3b, 3 steps through the plain
  scan) with a temporary ``--ckpt``: finite losses, ms a step, the cohort
  upload one packed_agg launch, enforced, held against the plain round
  and the trained adapters, the checkpoint restored equal to the
  aggregate;
* distributed -- ``backend="distributed"`` against kernel-path twins run
  first in the phase: (a) main_path's config under a one-rank NCCL group
  (one all_reduce a round and no launch, the accuracies within 0.01 and
  the adapters within 1e-3 of max|want|), a distributed rbla
  ``CompiledRound`` call timed beside the kernel round with the device
  kernels of one call and the buffer's bytes; (b) one flora round at
  ``stack_r_cap=512`` (one all_gather, one flora_stack launch) and one svd
  round (one all_gather, no launch), within 1e-4 of max|B @ A|; (c) the
  async service streaming (60 axpy_fold launches, bit for bit) and with a
  buffer of 5 (one all_reduce a flush); (d) two gloo ranks on cuda:0
  spawned over the quickstart's last cohort: fedavg, zeropad, rbla,
  rbla_ranked and rbla's local aggregator within 2e-5 of max|want| of the
  kernel round on each rank, svd and flora where gloo gathers CUDA
  tensors, and the round's wall.

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
#: False when ``--src`` runs another checkout: checks of this checkout's
#: design are reported, not enforced
ENFORCE_DESIGN = True
#: the phases ``--phases`` may pick: the others need the main path's run
SELECTABLE = ("kernels", "agg_rounds", "robust_large", "per_pair_rounds",
              "lora_kernels", "serve_main", "serve_streams", "ssd_kernels",
              "async_durable", "distributed", "attn_main",
              "attn_consistency", "attn_zoo", "moe_main", "moe_consistency",
              "moe_zoo", "moe_ep", "vlm_main", "encdec_main",
              "frontend_consistency", "frontend_round", "train_main")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 dense tensor cores (data sheet)
REPLACES = {
    "packed_agg": "src/repro/kernels/rbla_agg/kernel.py:115",
    "rbla_agg": "src/repro/kernels/rbla_agg/kernel.py:473",
    "packed_robust": "src/repro/kernels/rbla_agg/kernel.py:256",
    "packed_stack": "src/repro/kernels/rbla_agg/kernel.py:335",
    "flora_stack": "src/repro/kernels/rbla_agg/kernel.py:390",
    "axpy_fold": "src/repro/kernels/rbla_agg/kernel.py:442",
    "batched_lora_matmul": "src/repro/kernels/lora_matmul/kernel.py:148",
    "lora_matmul": "src/repro/kernels/lora_matmul/kernel.py:78",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:83",
}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"packed_agg": _CSRC + "rbla_agg.cu", "rbla_agg": _CSRC + "rbla_agg.cu",
          "packed_robust": _CSRC + "packed_robust.cu",
          "packed_stack": _CSRC + "flora_stack.cu",
          "flora_stack": _CSRC + "flora_stack.cu",
          "axpy_fold": _CSRC + "axpy_fold.cu",
          "batched_lora_matmul": _CSRC + "lora_matmul.cu",
          "lora_matmul": _CSRC + "lora_matmul.cu",
          "ssd_scan": _CSRC + "ssd_scan.cu"}
MLP_BUCKETS = ((64, 784), (256, 200), (64, 10))   # (rows, width), r_max=64
#: the main path's pairs (fan_out, fan_in) and its staircase cohort's ranks
MLP_PAIRS = (("fc1", 200, 784), ("fc2", 200, 200), ("out", 10, 200))
STAIRCASE = (6, 13, 19, 26, 32, 38, 45, 51, 58, 64)
MLP_PAIR_SIDES = ((64, 784, 1), (64, 200, 4), (64, 10, 1))  # + count/round
N_CLIENTS = 10
ROBUST_MODES = ("clipped", "trimmed", "median")
#: flora's per-pair sides (width, count per round) at cap 512: A widths
#: 784, 200, 200 and transposed-B widths 200, 200, 10
FLORA_PAIR_SIDES = ((784, 1), (200, 4), (10, 1))
#: the segments of a flora round within the cap: the global at live rank 64
#: first, then the staircase cohort's ranks
FLORA_SEGS = (64, 6, 13, 19, 26, 32, 38, 45, 51, 58, 64)
#: per-call axpy_fold cases at the MLP's (rows, width) bucket shapes
FOLD_BUCKETS = ((64, 784), (256, 200), (64, 10))
#: one rbla fold of the MLP as one grouped call: each pair's A by rank row,
#: its B (fan_out, r) in column mode, then the three base trainables (the
#: biases) at one rate each
FOLD_A_SIDES = ((64, 784), (64, 200), (64, 200))
FOLD_B_SIDES = ((200, 64), (200, 64), (10, 64))
FOLD_BASE_LEAVES = ((200,), (200,), (10,))
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 dense tensor cores
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


def time_ms_graph(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of one replay of a CUDA
    graph that holds ``calls`` calls of ``fn``, per call: the device's time
    alone, without the host work of issuing each call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _device_kernels(fn, calls: int = 5) -> dict:
    """Every device kernel one call of ``fn`` runs, from ``torch.profiler``
    over ``calls`` calls: its function name (no namespace, no template
    arguments) -> [launches a call, device ms a call].  Empty where the
    profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    # a warm-up step, then the counted one: records of the first launches
    # after the profiler starts may be lost, so only the second step counts
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if not us:
            continue
        key = ev.key.replace("(anonymous namespace)::", "")
        name = key.split("<", 1)[0].split("(", 1)[0].split("::")[-1].split()
        name = name[-1] if name else key
        n, ms = out.get(name, (0.0, 0.0))
        out[name] = [n + ev.count / calls, ms + us / calls / 1e3]
    return out


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
    if ((r, d) in MLP_BUCKETS and x_dtype == torch.float32 and prev is not None
            and norm_by == "mask" and not norm_restore):
        # an rbla bucket of the main path: the device's time alone beside
        # the call's, so that ms minus graph_ms is host work
        case["back_to_back_ms"] = time_ms_back_to_back(
            lambda: packed_agg(x, masks, weights, prev, **kw))
        case["graph_ms"] = time_ms_graph(
            lambda: packed_agg(x, masks, weights, prev, **kw))
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


def _round_segments(gen, r_max=64):
    """One main-path round as grouped-call arguments on the card: each
    pair's A (10, 64, fan_in) and B (10, fan_out, 64), fp32, the staircase
    ranks' owner masks, a previous global."""
    import torch
    own = (torch.arange(r_max, device="cuda")[None, :]
           < torch.tensor(STAIRCASE, device="cuda")[:, None]).float()
    n = len(STAIRCASE)
    xs, prevs, cols = [], [], []
    for _, fo, fi in MLP_PAIRS:
        for col, shape in ((False, (r_max, fi)), (True, (fo, r_max))):
            xs.append(torch.randn((n,) + shape, generator=gen, device="cuda"))
            prevs.append(torch.randn(shape, generator=gen, device="cuda"))
            cols.append(col)
    return dict(xs=xs, masks=own.repeat(1, len(xs)).contiguous(),
                weights=torch.rand(n, generator=gen, device="cuda") + 0.5,
                prevs=prevs, cols=cols, scales=[None] * len(xs),
                mask_offs=[i * r_max for i in range(len(xs))],
                out_dtypes=[torch.float32] * len(xs))


def _round_bytes(kw, owned_only):
    """Bytes a grouped call must move: every client's segment (only the
    owned rank rows for the order statistics), the masks and weights, each
    output once, and prev where no client owns a rank row."""
    n = int(kw["weights"].numel())
    b = kw["masks"].numel() * 4 + n * 4
    for x, prev, col, off in zip(kw["xs"], kw["prevs"], kw["cols"],
                                 kw["mask_offs"]):
        shape = tuple(x.shape[1:])
        rr = shape[-1] * math.prod(shape[:-2]) if col else math.prod(
            shape[:-1])
        elems = math.prod(shape) // rr
        m = kw["masks"][:, off:off + rr]
        rows = int((m > 0).sum()) if owned_only else n * rr
        b += rows * elems * x.element_size() + math.prod(shape) * 4
        if prev is not None:
            b += int(((m > 0).sum(0) == 0).sum()) * elems * 4
    return b


def check_group_round(kernel, kw, mode=None):
    """One grouped call over a main-path round's segments (``kernel``
    packed_agg: rbla's masked mean with prev; packed_robust: ``mode``)
    against its plain twin, with its time, back-to-back time, the
    device's time alone, the plain twin's time, the bound and the device
    kernels of one call."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels import rbla_agg as ra
    extra = {} if mode is None else dict(mode=mode, clip_norm=2.5,
                                         trim_frac=0.2)
    group = ra.packed_agg_group if kernel == "packed_agg" \
        else ra.packed_robust_group
    plain = ra.packed_agg_group_ref if kernel == "packed_agg" \
        else ra.packed_robust_group_ref

    def call():
        return group(**kw, **extra)
    before = runtime.LAUNCHES[kernel]
    got = call()
    launches = runtime.LAUNCHES[kernel] - before
    want = plain(**kw, **extra)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    tol = 2e-5 * scale
    n = int(kw["weights"].numel())
    elems = sum(x[0].numel() for x in kw["xs"])
    per_elem = (2 if mode is None else 4 if mode == "clipped"
                else n * max(1, math.ceil(math.log2(n))))
    bms, by = bound(_round_bytes(kw, mode in ("trimmed", "median")),
                    per_elem * elems)
    kernels, copies = _device_events(call)
    case = {"kernel": kernel, "case": "main-path round, one grouped call",
            "mode": mode, "segments": len(kw["xs"]), "launches": launches,
            "max_abs_err": err, "tol": tol, "ms": time_ms(call),
            "plain_ms": time_ms(lambda: plain(**kw, **extra)),
            "back_to_back_ms": time_ms_back_to_back(call),
            "graph_ms": time_ms_graph(call), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "device_kernels": kernels}
    emit(case)
    if not err <= tol or launches != 1:
        raise AssertionError(f"{kernel}: a grouped round disagrees with its "
                             f"plain twin or launched {launches} times")
    if sum(c for c, _ in kernels.values()) != 1 or copies:
        raise AssertionError(f"{kernel}: a grouped round ran {kernels}, "
                             f"{copies}")
    return case


def _pair_round_kw(gen, r_max=64, dtype=None):
    """One per-pair round as rbla_agg_group's arguments on the card: each
    MLP pair's A (10, 64, fan_in) and B (10, fan_out, 64), the staircase
    ranks as one column, a previous global, weights."""
    import torch
    n = len(STAIRCASE)
    xs, prevs, cols = [], [], []
    for _, fo, fi in MLP_PAIRS:
        for col, shape in ((False, (r_max, fi)), (True, (fo, r_max))):
            xs.append(torch.randn((n,) + shape, generator=gen,
                                  device="cuda").to(dtype or torch.float32))
            prevs.append(torch.randn(shape, generator=gen,
                                     device="cuda").to(xs[-1].dtype))
            cols.append(col)
    return dict(xs=xs, ranks=torch.tensor(STAIRCASE, dtype=torch.int32,
                                          device="cuda")[:, None],
                weights=torch.rand(n, generator=gen, device="cuda") + 0.5,
                prevs=prevs, cols=cols, rank_cols=[0] * len(xs))


def _rbla_group_bytes(kw):
    """Bytes rbla_agg_group must move: every client's segment (the mean
    reads each value, owned or not: a NaN anywhere reaches the result),
    the ranks and weights, each output once, prev where no client owns a
    rank row."""
    ranks = kw["ranks"]
    b = ranks.numel() * 4 + kw["weights"].numel() * 4
    for x, prev, col, c in zip(kw["xs"], kw["prevs"], kw["cols"],
                               kw["rank_cols"]):
        r = x.shape[-1] if col else x.shape[-2]
        b += x.numel() * x.element_size() + x[0].numel() * x.element_size()
        if prev is not None:
            unowned = max(0, r - int(ranks[:, c].max()))
            b += unowned * (x[0].numel() // r) * prev.element_size()
    return b


def check_rbla_group_case(label, kw, method="rbla", tol_rel=2e-5):
    """One grouped rbla_agg call (``rbla_agg_group``) on the card against
    its plain twin, with its time, back-to-back time, the device's time
    alone (a CUDA graph), the plain twin's time, the bound and the device
    kernels of one call (one launch and nothing else, enforced)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.rbla_agg import (rbla_agg_group,
                                              rbla_agg_group_ref)
    norm_by = {"rbla": "mask", "zeropad": "weight"}[method]

    def call():
        return rbla_agg_group(kw["xs"], kw["ranks"], kw["weights"],
                              kw["prevs"], cols=kw["cols"],
                              rank_cols=kw["rank_cols"], method=method)

    def plain():
        return rbla_agg_group_ref(kw["xs"], kw["ranks"], kw["weights"],
                                  kw["prevs"], cols=kw["cols"],
                                  rank_cols=kw["rank_cols"], norm_by=norm_by)
    before = runtime.LAUNCHES["rbla_agg"]
    got = call()
    launches = runtime.LAUNCHES["rbla_agg"] - before
    want = plain()
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    tol = tol_rel * max(1.0, max(float(w.float().abs().max()) for w in want))
    elems = sum(x.numel() for x in kw["xs"])
    bms, by = bound(_rbla_group_bytes(kw), 2 * elems)
    kernels, copies = _device_events(call)
    case = {"kernel": "rbla_agg", "case": label, "method": method,
            "segments": len(kw["xs"]),
            "shapes": [list(x.shape) for x in kw["xs"]],
            "x_dtype": _dtype_name(kw["xs"][0].dtype), "launches": launches,
            "max_abs_err": err, "tol": tol, "ms": time_ms(call),
            "plain_ms": time_ms(plain),
            "back_to_back_ms": time_ms_back_to_back(call),
            "graph_ms": time_ms_graph(call), "device_kernels": kernels,
            "device_ms": sum(m for _, m in kernels.values()), "bound_ms": bms,
            "bound_by": by, "library_ms": None}
    case["device_share_of_bound"] = (bms / case["device_ms"]
                                     if case["device_ms"] else None)
    emit(case)
    if not err <= tol or launches != 1:
        raise AssertionError(f"rbla_agg_group disagrees with its plain twin "
                             f"or launched {launches} times: {case}")
    if sum(c for c, _ in kernels.values()) != 1 or copies:
        raise AssertionError(f"rbla_agg_group: one call ran {kernels}, "
                             f"{copies}")
    return case


def _flora_round_kw(gen, r_max=64, cap=512, dtype=None):
    """One per-pair flora round as flora_stack_group's arguments on the
    card: each MLP pair's A and B at storage r_max, a global at storage cap
    and live rank r_max first, the staircase cohort's ranks, flora's mass
    scales on B."""
    import torch
    n = len(STAIRCASE)
    con = ((-1, r_max),) + tuple(enumerate(STAIRCASE))
    xs, prevs, cols = [], [], []
    for _, fo, fi in MLP_PAIRS:
        for col, shape, pshape in ((False, (r_max, fi), (cap, fi)),
                                   (True, (fo, r_max), (fo, cap))):
            xs.append(torch.randn((n,) + shape, generator=gen,
                                  device="cuda").to(dtype or torch.float32))
            prevs.append(torch.randn(pshape, generator=gen,
                                     device="cuda").to(xs[-1].dtype))
            cols.append(col)
    return dict(xs=xs, contribs=[con] * len(xs), prevs=prevs, cap=cap,
                cols=cols, scales=[None, "mass"] * len(MLP_PAIRS),
                weights=torch.rand(n, generator=gen, device="cuda") + 0.5,
                prev_weight=1.0)


def _stack_group_bytes(xs, contribs, cols, caps, n_weights):
    """Bytes a grouped stack must move: the stacked rank rows of each
    source read once, each output written once, the weights."""
    b = n_weights * 4
    for x, con, col, cap in zip(xs, contribs, cols, caps):
        width = x.shape[-2] if col else x.shape[-1]
        layers = math.prod(x.shape[1:-2])
        rows = sum(r for _, r in con)
        b += layers * width * (rows + cap) * x.element_size()
    return b


def _check_stack_group(kernel, label, call, plain, xs, contribs, cols, caps,
                       n_weights, extra):
    """A grouped stack call on the card (``kernel`` names its launch count)
    against its plain twin, bit for bit (one fp32 multiply per element,
    the mass scales summed in the same order), with its times, the device
    kernels of one call (one and nothing else, enforced) and the bound."""
    import torch
    from repro_torch.kernels import runtime
    before = runtime.LAUNCHES[kernel]
    got = call()
    launches = runtime.LAUNCHES[kernel] - before
    want = plain()
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    copied = sum(math.prod(x.shape[1:-2]) * (x.shape[-2] if c else
                                             x.shape[-1])
                 * sum(r for _, r in con)
                 for x, con, c in zip(xs, contribs, cols))
    bms, by = bound(_stack_group_bytes(xs, contribs, cols, caps, n_weights),
                    copied)
    kernels, copies = _device_events(call)
    case = {"kernel": kernel, "case": label, "segments": len(xs),
            "shapes": [list(x.shape) for x in xs], **extra,
            "x_dtype": _dtype_name(xs[0].dtype), "launches": launches,
            "max_abs_err": err, "tol": 0.0, "ms": time_ms(call),
            "plain_ms": time_ms(plain),
            "back_to_back_ms": time_ms_back_to_back(call),
            "graph_ms": time_ms_graph(call), "device_kernels": kernels,
            "device_ms": sum(m for _, m in kernels.values()), "bound_ms": bms,
            "bound_by": by, "library_ms": None}
    case["device_share_of_bound"] = (bms / case["device_ms"]
                                     if case["device_ms"] else None)
    emit(case)
    if not exact or launches != 1:
        raise AssertionError(f"{kernel}: a grouped call disagrees with its "
                             f"plain twin or launched {launches} times: "
                             f"{case}")
    if sum(c for c, _ in kernels.values()) != 1 or copies:
        raise AssertionError(f"{kernel}: one grouped call ran {kernels}, "
                             f"{copies}")
    return case


def check_flora_group_case(label, kw):
    """One grouped flora_stack call (``flora_stack_group``) on the card
    against its plain twin."""
    from repro_torch.kernels.rbla_agg import (flora_stack_group,
                                              flora_stack_group_ref)
    k = len(kw["xs"])

    def call():
        return flora_stack_group(**kw)

    def plain():
        return flora_stack_group_ref(
            kw["xs"], kw["contribs"], kw["prevs"], cols=kw["cols"],
            caps=[kw["cap"]] * k, scales=kw["scales"], weights=kw["weights"],
            prev_weight=kw["prev_weight"], out_dtypes=[
                x.dtype for x in kw["xs"]])
    return _check_stack_group(
        "flora_stack", label, call, plain, kw["xs"], kw["contribs"],
        kw["cols"], [kw["cap"]] * k, kw["weights"].numel(),
        {"cap": kw["cap"]})


def check_stack_group_case(label, plan, xs, prevs, w):
    """One packed_stack_group call -- the unit of row 5: a flora plan's
    stacking round -- on the card against its plain twin."""
    from repro_torch.kernels.rbla_agg import (packed_stack_group,
                                              packed_stack_group_ref)

    def call():
        return packed_stack_group(plan, xs, prevs, w)

    def plain():
        return packed_stack_group_ref(plan, xs, prevs, w)
    return _check_stack_group(
        "packed_stack", label, call, plain, xs, plan.contribs, plan.cols,
        plan.caps, w.numel(), {"caps": sorted(set(plan.caps))})


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
    """flora_stack, the one-segment form of flora_stack_group, on the card
    against its plain version (one fp32 multiply per element: exact)."""
    import torch
    from repro_torch.kernels.rbla_agg import flora_stack, flora_stack_ref
    got = flora_stack(x, scales, segs=segs, out_rows=out_rows)
    want = flora_stack_ref(x, scales, segs, out_rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = time_ms(lambda: flora_stack(x, scales, segs=segs, out_rows=out_rows))
    plain_ms = time_ms(lambda: flora_stack_ref(x, scales, segs, out_rows))
    d, es = x.shape[-1], x.element_size()
    bms, by = bound((sum(segs) + out_rows) * d * es + 4 * len(segs),
                    sum(segs) * d)
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


def _group_segments(gen, dtype=None, base_dtype=None, a_sides=FOLD_A_SIDES,
                    b_sides=FOLD_B_SIDES, base=FOLD_BASE_LEAVES):
    """(y, x, alpha, col) of one grouped fold: A sides with per-row rates,
    B sides in column mode with the same kind of rates, base leaves at one
    rate each; a third of the rank rows unowned (rate 0)."""
    segs = []
    for shape in a_sides:
        y, x, alpha = _fold_inputs(shape, gen, dtype)
        segs.append((y, x, alpha, False))
    for fo, r in b_sides:
        y, x, alpha = _fold_inputs((r, fo), gen, dtype)
        segs.append((y.T.contiguous(), x.T.contiguous(), alpha, True))
    for shape in base:
        y, x, _ = _fold_inputs(shape, gen, base_dtype or dtype)
        segs.append((y, x, 0.3, False))
    return segs


def check_axpy_group_case(label, segs):
    """One grouped axpy_fold call (a whole fold's segments) on the card
    against its plain version: to the bit in fp32, within one bf16 ulp of
    the exact fp32 fold in bf16, one launch per (y, x, out) dtype triple.
    Timed beside ``torch._foreach_lerp`` on the same tensors (one PyTorch
    call computing the same function, rates as (R, 1) or (1, r) weights)
    and the sum of one ``torch.lerp`` per segment; ``graph_ms`` is the
    device's time alone (a CUDA graph of 20 calls), so ``ms`` minus it is
    host work."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.rbla_agg import (axpy_fold_group,
                                              axpy_fold_group_ref)
    ys, xs, alphas, cols = (list(v) for v in zip(*segs))
    before = runtime.LAUNCHES["axpy_fold"]
    got = axpy_fold_group(ys, xs, alphas, cols=cols)
    launches = runtime.LAUNCHES["axpy_fold"] - before
    want = axpy_fold_group_ref(ys, xs, alphas, cols=cols)
    exact = axpy_fold_group_ref([y.float() for y in ys], xs, alphas,
                                cols=cols)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for g, w, e, y in zip(got, want, exact, ys):
        diff = (g.float() - w.float()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if y.dtype == torch.bfloat16:
            ok &= bool((diff <= 2.0 ** -7 * e.abs() + 1e-30).all())
        else:
            ok &= torch.equal(g, w)
    triples = {(y.dtype, x.dtype) for y, x in zip(ys, xs)}
    ok &= launches == len(triples)

    def weight(y, a, col):
        if not isinstance(a, torch.Tensor):
            return torch.tensor(a, dtype=y.dtype, device=y.device)
        a = a.to(y.dtype)
        return a[None, :] if col else a.reshape(
            a.shape + (1,) * (y.ndim - a.ndim))
    lerp_x = [x.to(y.dtype) for y, x in zip(ys, xs)]
    lerp_w = [weight(y, a, c) for y, a, c in zip(ys, alphas, cols)]

    def kernel():
        return axpy_fold_group(ys, xs, alphas, cols=cols)

    def foreach():
        return torch._foreach_lerp(ys, lerp_x, lerp_w)

    def lerp_sum():
        return [torch.lerp(y, x, w) for y, x, w in zip(ys, lerp_x, lerp_w)]
    times = {
        "ms": time_ms(kernel),
        "back_to_back_ms": time_ms_back_to_back(kernel),
        "plain_ms": time_ms(lambda: axpy_fold_group_ref(ys, xs, alphas,
                                                        cols=cols)),
        "graph_ms": time_ms_graph(kernel),
        "library_ms": time_ms(foreach),
        "library_back_to_back_ms": time_ms_back_to_back(foreach),
        "library_graph_ms": time_ms_graph(foreach),
        "lerp_sum_ms": time_ms(lerp_sum),
        "lerp_sum_back_to_back_ms": time_ms_back_to_back(lerp_sum)}
    n = sum(y.numel() for y in ys)
    rates = sum(a.numel() for a in alphas if isinstance(a, torch.Tensor))
    bytes_moved = sum(y.numel() * (2 * y.element_size() + x.element_size())
                      for y, x in zip(ys, xs)) + 4 * rates
    bms, by = bound(bytes_moved, 3 * n)
    case = {"kernel": "axpy_fold", "case": label, "grouped": True,
            "segments": len(ys), "shapes": [list(y.shape) for y in ys],
            "column_mode": sum(cols),
            "dtypes": sorted(f"{_dtype_name(a)}/{_dtype_name(b)}"
                             for a, b in triples),
            "launches": launches, "max_abs_err": err,
            "tol": "0 in fp32; one bf16 ulp (2^-7 |exact|) in bf16", **times,
            "bound_ms": bms, "bound_by": by}
    emit(case)
    if not ok:
        raise AssertionError(f"grouped axpy_fold disagrees with its plain "
                             f"version or launched {launches} times: {case}")
    return case


def _flora_plan(r_max=64, cap=512):
    """The stacking round of a main-path flora plan (the staircase cohort
    at r_max storage, a global of live rank r_max at cap storage): the
    real plan's ``StackPlan`` and its inputs on the card, fp32."""
    import torch
    from repro_torch.core import plan as tplan
    from repro_torch.core.strategy import get_strategy, stack_trees
    gen = torch.Generator(device="cuda").manual_seed(0)

    def pair(fo, fi, storage, rank):
        return {"A": torch.randn(storage, fi, generator=gen, device="cuda"),
                "B": torch.randn(fo, storage, generator=gen, device="cuda"),
                "rank": torch.tensor(rank, dtype=torch.int32, device="cuda")}
    clients = [{k: pair(fo, fi, r_max, r) for k, fo, fi in MLP_PAIRS}
               for r in STAIRCASE]
    prev = {k: pair(fo, fi, cap, r_max) for k, fo, fi in MLP_PAIRS}
    stacked = stack_trees(clients)
    round_ = get_strategy("flora").with_options(stack_r_cap=cap).plan(
        None, tplan.build_cohort_spec(stacked, kind="kernel", r_max=r_max,
                                      prev_tree=prev))
    xs = [stacked[k][side] for k, side in
          ((MLP_PAIRS[pi][0], side) for pi, side in round_.stack_sides)]
    prevs = [prev[MLP_PAIRS[pi][0]][side] for pi, side in round_.stack_sides]
    w = torch.rand(len(STAIRCASE), generator=gen, device="cuda") + 0.5
    return round_.stack_plan, xs, prevs, w


def _bucket_copies(plan):
    """``packed_stack``'s copy-list form of a stack plan's round: segments
    of one row width share a bucket, their rank rows (B's columns) one
    after another; scale 0 is 1 (A rows), then one a B contributor.
    Returns the buckets (width, copy lists, rows) and the scale count."""
    buckets, n_scales = {}, 1
    for i, (shape, col, cap, con) in enumerate(zip(
            plan.shapes, plan.cols, plan.caps, plan.contribs)):
        width, r_in = (shape[-2], shape[-1]) if col else (shape[-1],
                                                          shape[-2])
        pshape = plan.prev_shapes[i]
        r_prev = 0 if pshape is None else (pshape[-1] if col else pshape[-2])
        b = buckets.setdefault(width, dict(width=width, copies_x=[],
                                           copies_prev=[], r_in=0, r_prev=0,
                                           out_rows=0))
        layers = math.prod(shape[1:-2])
        first = n_scales
        n_scales += len(con) if col else 0
        for layer in range(layers):
            dst = b["out_rows"] + layer * cap
            for k, (src, rows) in enumerate(con):
                si = first + k if col else 0
                if src < 0:
                    b["copies_prev"].append((b["r_prev"] + layer * r_prev,
                                             dst, rows, si))
                else:
                    b["copies_x"].append((src, b["r_in"] + layer * r_in, dst,
                                          rows, si))
                dst += rows
        b["out_rows"] += layers * cap
        b["r_in"] += layers * r_in
        b["r_prev"] += layers * r_prev
    return list(buckets.values()), n_scales


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

    # the unit of row 2: one grouped call of a per-pair round; and one large
    # segment (every client's value read, owned or not)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pair_rounds = [check_rbla_group_case("per-pair round, one grouped call",
                                         _pair_round_kw(gen)),
                   check_rbla_group_case("per-pair round, zeropad",
                                         _pair_round_kw(gen), "zeropad"),
                   check_rbla_group_case("per-pair round, bf16",
                                         _pair_round_kw(gen, dtype=bf16),
                                         tol_rel=2e-2)]
    x, ranks, _, weights, prev, _ = _agg_inputs(
        N_CLIENTS, 2048, 4096, f32, gen, True, False, f32)
    rbla_large = check_rbla_group_case("large", dict(
        xs=[x], ranks=ranks.to(torch.int32)[:, None].contiguous(),
        weights=weights, prevs=[prev], cols=[False], rank_cols=[0]))
    del x, prev

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
    # the unit of rows 1 and 3: one grouped call of a main-path round
    gen = torch.Generator(device="cuda").manual_seed(seed)
    round_kw = _round_segments(gen)
    agg_round = check_group_round("packed_agg", round_kw)
    robust_rounds = [check_group_round("packed_robust", round_kw, m)
                     for m in ROBUST_MODES]

    from repro_torch.kernels.rbla_agg import stack_plan, stack_table
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the unit of row 5: one grouped call of a flora plan's stacking round
    # (6 segments), fp32 and bf16; and 10 contributors x 200 rank rows into
    # a 2048-row cap at width 4096, an A by rank row and a B by rank column
    plan, xs, prevs, w = _flora_plan()
    stack_rounds = [check_stack_group_case("plan round, one grouped call",
                                           plan, xs, prevs, w)]
    bf = [x.to(bf16) for x in xs]
    stack_rounds.append(check_stack_group_case(
        "plan round, bf16", stack_plan(
            plan.shapes, plan.contribs, cap=plan.caps, dtypes=[bf16] * 6,
            cols=plan.cols, prev_shapes=plan.prev_shapes,
            prev_dtypes=[bf16] * 6, scales=plan.scales, eps=plan.eps),
        bf, [p.to(bf16) for p in prevs], w))
    con = tuple((i, 200) for i in range(N_CLIENTS))
    big = [torch.randn(N_CLIENTS, 256, 4096, generator=gen, device="cuda"),
           torch.randn(N_CLIENTS, 4096, 256, generator=gen, device="cuda")]
    stack_large = check_stack_group_case("large", stack_plan(
        [tuple(x.shape) for x in big], [con] * 2, cap=2048,
        dtypes=[f32] * 2, cols=[False, True], scales=[None, "mass"]),
        big, None, w)
    del big
    # the copy-list form: the same round as three bucket calls (the plan's
    # round before PR 22), then one large bucket
    buckets, n_scales = _bucket_copies(plan)
    stack = []
    for b in buckets:
        x = torch.randn(N_CLIENTS, b["r_in"], b["width"], generator=gen,
                        device="cuda")
        prev = torch.randn(b["r_prev"], b["width"], generator=gen,
                           device="cuda")
        scales = torch.rand(n_scales, generator=gen, device="cuda") + 0.5
        table = stack_table(b["copies_x"], b["copies_prev"],
                            out_rows=b["out_rows"], n=N_CLIENTS,
                            r_in=b["r_in"], r_prev=b["r_prev"],
                            n_scales=n_scales)
        stack.append(check_stack_case(
            f"plan bucket {b['width']}", x, scales, prev, b["copies_x"],
            b["copies_prev"], b["out_rows"], table))
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
    # the unit of row 6: one grouped call of a per-pair flora round; and
    # 10 contributors x 200 rank rows into a 2048-row cap at width 4096, by
    # rank row (an A side) and by rank column (a B side)
    flora_rounds = [check_flora_group_case("per-pair round, one grouped call",
                                           _flora_round_kw(gen)),
                    check_flora_group_case("per-pair round, bf16",
                                           _flora_round_kw(gen, dtype=bf16))]
    flora_large = []
    for col in (False, True):
        x = torch.randn((N_CLIENTS,) + ((4096, 256) if col else (256, 4096)),
                        generator=gen, device="cuda")
        flora_large.append(check_flora_group_case(
            "large, by rank " + ("column" if col else "row"), dict(
                xs=[x], contribs=[tuple((i, 200) for i in range(N_CLIENTS))],
                prevs=[None], cap=2048, cols=[col],
                scales=[torch.rand(N_CLIENTS, generator=gen, device="cuda")],
                weights=torch.rand(N_CLIENTS, generator=gen, device="cuda"),
                prev_weight=1.0)))
        del x

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
    # grouped: one call per fold
    group = [check_axpy_group_case("rbla fold", _group_segments(gen)),
             check_axpy_group_case("rbla fold bf16",
                                   _group_segments(gen, bf16)),
             check_axpy_group_case("column-mode B 4096x64", _group_segments(
                 gen, a_sides=(), b_sides=((4096, 64),), base=())),
             check_axpy_group_case("ragged width 33x4099", _group_segments(
                 gen, a_sides=((33, 4099),), b_sides=((4099, 7),),
                 base=((4099,),))),
             check_axpy_group_case("mixed bf16 adapters, fp32 base",
                                   _group_segments(gen, bf16, f32)),
             check_axpy_group_case("large fp32 2048x4096", _group_segments(
                 gen, a_sides=((2048, 4096),), b_sides=((4096, 2048),),
                 base=((4096,),)))]

    def main_path_sum(cases, match, counts):
        rows = {}
        for key, k in counts.items():
            hit = [c for c in cases if match(c, key)]
            if len(hit) != 1:
                raise AssertionError(f"no unique case for {key}")
            for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "back_to_back_ms", "graph_ms"):
                if hit[0].get(f) is not None:
                    rows[f] = rows.get(f, 0.0) + k * hit[0][f]
        return rows

    # one main-path round: one grouped call (rbla, fp32, with prev)
    pk = main_path_sum([agg_round], lambda c, key: True, {"round": 1})
    # one per-pair round through the one-segment form: every A and
    # transposed B side, fp32, rbla (the parent's unit of this row)
    rk = main_path_sum(
        rbla,
        lambda c, key: (tuple(c["shape"][1:]) == key[:2]
                        and c["x_dtype"] == "float32" and c["method"] == "rbla"),
        {s: s[2] for s in MLP_PAIR_SIDES})
    # one round of each robust method: one grouped call each
    rb = main_path_sum(robust_rounds, lambda c, key: c["mode"] == key,
                       {m: 1 for m in ROBUST_MODES})
    # one stacking round: one grouped call (fp32); in its copy-list form,
    # three bucket calls (the unit of this row before PR 22)
    st = main_path_sum(stack_rounds[:1], lambda c, key: True, {"round": 1})
    sb = main_path_sum(stack, lambda c, key: c["case"] == key,
                       {f"plan bucket {w}": 1 for w in (784, 200, 10)})
    # one per-pair flora round through the one-segment form: every A and
    # transposed B side, fp32 (the parent's unit of this row)
    fl = main_path_sum(
        flora, lambda c, key: (c["case"] == f"per-pair {key[0]}"
                               and c["x_dtype"] == "float32"),
        {side: side[1] for side in FLORA_PAIR_SIDES})
    # one main-path rbla fold: one grouped call
    ax = main_path_sum(group, lambda c, key: c["case"] == key,
                       {"rbla fold": 1})
    # one per-pair round: one grouped call each (rbla fp32; flora fp32)
    prk = main_path_sum(pair_rounds[:1], lambda c, key: True, {"round": 1})
    pfl = main_path_sum(flora_rounds[:1], lambda c, key: True, {"round": 1})
    summary = {}
    for name, cases, row in (("packed_agg", packed + [agg_round], pk),
                             ("rbla_agg", rbla + pair_rounds + [rbla_large],
                              prk),
                             ("packed_robust", robust + robust_rounds, rb),
                             ("packed_stack", stack_rounds + [stack_large]
                              + stack, st),
                             ("flora_stack", flora + flora_rounds
                              + flora_large, pfl),
                             ("axpy_fold", axpy + group, ax)):
        summary[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row.get("library_ms")}
    summary["packed_agg"].update(
        per="one grouped call of a main-path rbla round (6 segments)",
        back_to_back_ms=pk["back_to_back_ms"], graph_ms=pk["graph_ms"])
    summary["packed_stack"].update(
        per="one grouped call of a flora plan's stacking round (6 segments)",
        back_to_back_ms=st["back_to_back_ms"], graph_ms=st["graph_ms"],
        device_ms=stack_rounds[0]["device_ms"],
        copy_list={"per": "the same round as three copy-list bucket calls",
                   "ms": sb["ms"], "plain_ms": sb["plain_ms"],
                   "bound_ms": sb["bound_ms"]},
        large_fp32={"device_ms": stack_large["device_ms"],
                    "bound_ms": stack_large["bound_ms"],
                    "device_share_of_bound":
                        stack_large["device_share_of_bound"]})
    for name, row, side_sum, large in (
            ("rbla_agg", prk, rk, [rbla_large]),
            ("flora_stack", pfl, fl, flora_large)):
        summary[name].update(
            per="one grouped call of a per-pair round (6 segments)",
            back_to_back_ms=row["back_to_back_ms"], graph_ms=row["graph_ms"],
            per_side_sum_ms=side_sum["ms"],
            large_fp32={c["case"]: {"device_ms": c["device_ms"],
                                    "bound_ms": c["bound_ms"],
                                    "device_share_of_bound":
                                        c["device_share_of_bound"]}
                        for c in large})
    large = {c["mode"]: c for c in robust if c["shape"] == [N_CLIENTS, 2048, 4096]
             and c["x_dtype"] == "float32" and c["prev"]}
    summary["packed_robust"].update(
        per="one grouped call of a main-path round for each robust mode",
        back_to_back_ms=rb["back_to_back_ms"], graph_ms=rb["graph_ms"],
        large_fp32={m: {"ms": c["ms"], "bound_ms": c["bound_ms"],
                        "share_of_bound": c["bound_ms"] / c["ms"]}
                    for m, c in large.items()})
    fold = group[0]
    summary["axpy_fold"].update(
        per="one grouped call: an rbla fold of the MLP (9 segments)",
        back_to_back_ms=fold["back_to_back_ms"],
        library="torch._foreach_lerp", lerp_sum_ms=fold["lerp_sum_ms"])
    return summary


def phase_robust_large() -> list:
    """packed_robust at (10, 2048, 4096) fp32 with prev, each mode: the
    wrapper's time, back to back, the device's time alone (a CUDA graph)
    and each device kernel's time from torch.profiler, against the HBM
    bound.  Uses only the one-bucket call every version of the port has,
    so ``--src`` profiles an older port's kernel in the same run."""
    import torch
    from repro_torch.kernels.rbla_agg import packed_robust
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, _, masks, weights, prev, _ = _agg_inputs(
        N_CLIENTS, 2048, 4096, torch.float32, gen, True, False,
        torch.float32)
    rows = []
    for mode in ROBUST_MODES:
        kw = dict(mode=mode, clip_norm=2.5, trim_frac=0.2)

        def call():
            return packed_robust(x, masks, weights, prev, **kw)
        bms, by = bound(_robust_bytes(x, masks, weights, prev, None,
                                      torch.float32), 0)
        kernels = _device_kernels(call)
        device_ms = sum(m for _, m in kernels.values())
        row = {"phase": "robust_large", "mode": mode,
               "shape": list(x.shape), "ms": time_ms(call),
               "back_to_back_ms": time_ms_back_to_back(call),
               "graph_ms": time_ms_graph(call), "device_kernels": kernels,
               "device_ms": device_ms, "bound_ms": bms, "bound_by": by,
               "device_share_of_bound": bms / device_ms if device_ms else None}
        emit(row)
        rows.append(row)
    return rows


# -------------------------------------------------------------- agg rounds --
#: the rounds agg_rounds times: strategy, then the cohort's upload codec;
#: flora stacks at cap 512 under a global at storage 512 and live rank 64
AGG_ROUNDS = (("rbla", None), ("fedavg", None), ("rbla_norm", None),
              ("rbla_clipped", None), ("rbla_trimmed", None),
              ("rbla_median", None), ("rbla", "int8"), ("rbla", "mixed"),
              ("flora", None))


def _mlp_cohort(seed):
    """The main path's cohort on the card: 10 clients' uploads of the MLP's
    three pairs at r_max 64 and the staircase ranks (A rows and B columns
    past a client's rank zero), a previous global at full rank, weights."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def pair(fo, fi, rank):
        a = torch.randn(64, fi, generator=gen, device="cuda")
        b = torch.randn(fo, 64, generator=gen, device="cuda")
        a[rank:], b[:, rank:] = 0.0, 0.0
        return {"A": a, "B": b, "rank": torch.tensor(rank, dtype=torch.int32,
                                                     device="cuda")}
    clients = [{k: pair(fo, fi, r) for k, fo, fi in MLP_PAIRS}
               for r in STAIRCASE]
    prev = {k: pair(fo, fi, 64) for k, fo, fi in MLP_PAIRS}
    return clients, prev, torch.rand(len(STAIRCASE), generator=gen,
                                     device="cuda") + 0.5


def _flora_prev(prev, cap=512):
    """``prev`` as a flora global: each pair at storage ``cap``, its live
    rank unchanged (zero rank rows beyond)."""
    import torch

    def widen(pair):
        extra = cap - pair["A"].shape[0]
        return {"A": torch.cat([pair["A"], torch.zeros(
                    extra, pair["A"].shape[1], device="cuda")]),
                "B": torch.cat([pair["B"], torch.zeros(
                    pair["B"].shape[0], extra, device="cuda")], 1),
                "rank": pair["rank"]}
    return {k: widen(p) for k, p in prev.items()}


def phase_agg_rounds() -> list:
    """``CompiledRound.__call__`` on the main-path cohort for each of
    AGG_ROUNDS: wall ms, back-to-back ms, graph ms where the round can be
    captured, and the device kernels of one call (torch.profiler), with
    its result against the plain round's.  Uses only APIs the port had
    before its rounds were grouped, so ``--src`` times an older port in
    the same run."""
    import torch
    from repro_torch.core import codec, plan, strategy
    from repro_torch.kernels import runtime
    clients, mlp_prev, w = _mlp_cohort(11)
    ranks = torch.tensor(STAIRCASE, dtype=torch.int32, device="cuda")
    stacked = strategy.stack_trees(clients)
    rows = []
    for name, wire in AGG_ROUNDS:
        flora = name == "flora"
        strat = strategy.get_strategy(name).with_options(
            **(dict(stack_r_cap=512) if flora else {}))
        prev = _flora_prev(mlp_prev) if flora else mlp_prev
        if wire is None:
            cohort, codecs = stacked, None
        else:
            codecs = ([wire] * len(clients) if wire != "mixed" else
                      [("int8", "bf16", "none")[i % 3]
                       for i in range(len(clients))])
            cohort = [codec.encode_adapters(c, k)
                      for c, k in zip(clients, codecs)]

        def round_for(kind):
            if codecs is None:
                spec = plan.build_cohort_spec(cohort, kind=kind, r_max=64,
                                              client_ranks=ranks,
                                              prev_tree=prev)
            else:
                spec = plan.build_encoded_cohort_spec(
                    cohort, codecs, kind=kind, r_max=64, client_ranks=ranks,
                    prev_tree=prev)
            return strat.plan(None, spec)
        round_ = round_for("kernel")

        def call():
            return round_(cohort, w, prev)
        before = dict(runtime.LAUNCHES)
        got = call()
        launches = {k: runtime.LAUNCHES[k] - before[k] for k in before
                    if runtime.LAUNCHES[k] != before[k]}
        want = round_for("ref")(cohort, w, prev)
        err, scale = _rel_err(got, want)
        try:
            graph_ms = time_ms_graph(call)
        except RuntimeError as e:       # a round that cannot be captured
            graph_ms = None
            emit({"phase": "agg_rounds", "case": f"{name} {wire or 'fp32'}",
                  "graph": f"not captured: {e}"})
        kernels, copies = _device_events(call)
        kernels.update(copies)      # a round moves nothing: any copy counts
        row = {"phase": "agg_rounds", "strategy": name,
               "codec": wire or "fp32", "plan_kind": round_.kind,
               "plan_launches": round_.n_kernel_launches,
               "launches": launches, "ms": time_ms(call),
               "back_to_back_ms": time_ms_back_to_back(call),
               "graph_ms": graph_ms, "device_kernels": kernels,
               "n_device_kernels": sum(c for c, _ in kernels.values()),
               "device_ms": sum(m for _, m in kernels.values()),
               "max_abs_err": err, "tol": 2e-5 * max(scale, 1.0)}
        emit(row)
        rows.append(row)
        if not err <= 2e-5 * max(scale, 1.0):
            raise AssertionError(f"agg_rounds {name} {wire}: the kernel round "
                                 "disagrees with the plain round")
        if ENFORCE_DESIGN and (sum(launches.values()) != 1
                               or row["n_device_kernels"] != 1):
            raise AssertionError(f"agg_rounds {name} {wire}: {launches} "
                                 f"launches, device kernels {kernels}: one "
                                 "grouped launch and nothing else expected")
    return rows


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
    # one grouped launch a round (one per (width, dtype) bucket before)
    if buckets != [1]:
        raise AssertionError(f"expected 1 launch per round, got {buckets}")
    if launches["packed_agg"] != MAIN_CFG["rounds"]:
        raise AssertionError(f"packed_agg launched {launches['packed_agg']} "
                             f"times, expected {MAIN_CFG['rounds']}")
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
    if launches["packed_agg"] or plain["packed_agg"] != MAIN_CFG["rounds"]:
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
        if launches["packed_agg"] != 1 or any(plain.values()):
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


def _stack_round_events(rec) -> tuple[dict, dict]:
    """The device kernels and copies of one planned stacking round: the
    recorded last flora round's cohort through its ``CompiledRound``."""
    import torch
    from repro_torch.core import plan as tplan
    from repro_torch.core.strategy import stack_trees
    prev_state, updates, _ = rec.last
    stacked = stack_trees([u.adapters for u in updates])
    w = torch.tensor([float(u.n_examples) for u in updates], device="cuda")
    round_ = rec.strategy.plan(None, tplan.build_cohort_spec(
        stacked, kind="kernel", r_max=MAIN_CFG["r_max"],
        prev_tree=prev_state.adapters))
    return _device_events(lambda: round_(stacked, w, prev_state.adapters))


def phase_flora():
    hist, launches, plain, last, secs, rec = drive(FLORA_CFG)
    per_round = [(r["launches"].get("packed_stack", 0), r["fallback_pairs"])
                 for r in rec.rounds]
    live = sorted({int(p["rank"]) for p in last[2].adapters.values()})
    # round 3 stacks: one planned stacking round's device events
    kernels, copies = _stack_round_events(rec)
    emit({"phase": "flora", "config": FLORA_CFG, "test_acc": hist.test_acc,
          "round_time_s": hist.round_time_s, "seconds": secs,
          "launches": launches, "plain_calls": plain,
          "rounds": rec.rounds, "live_rank": live,
          "stack_round_kernels": kernels, "stack_round_copies": copies})
    if per_round != [(1, 0), (0, 3), (1, 0)]:
        raise AssertionError(f"flora rounds (packed_stack launches, "
                             f"re-projected pairs): {per_round}")
    if launches["packed_stack"] != 2 or any(plain.values()) or live != [416]:
        raise AssertionError(f"flora: launches {launches}, plain {plain}, "
                             f"live rank {live}")
    if sum(c for c, _ in kernels.values()) != 1 or copies:
        raise AssertionError(f"flora: a stacking round ran {kernels}, "
                             f"{copies}: one grouped kernel and nothing "
                             "else expected")
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
        if launches["packed_robust"] != 1 or any(plain.values()):
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
    if launches["packed_robust"] != 1 or any(plain.values()):
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


#: ``_device_kernels``' names of memory copies and sets, not kernels
COPIES = ("DtoH", "HtoD", "DtoD", "HtoH", "Memset")


def _device_events(fn, tries: int = 6) -> tuple[dict, dict]:
    """``_device_kernels`` of ``fn`` split into kernels and memory copies,
    profiled again (up to ``tries`` times) where the profiler lost records
    (no event at all, or a count a call that is not whole: at 4096³ a
    launch of the five has been lost three times in a row)."""
    for _ in range(tries):
        events = _device_kernels(fn)
        if events and all(float(c).is_integer() for c, _ in events.values()):
            break
    copies = {k: v for k, v in events.items() if k in COPIES}
    return {k: v for k, v in events.items() if k not in copies}, copies


def phase_per_pair(rec, kernel, want_launches, tol_rel, phase,
                   one_kernel=False):
    """The recorded last cohort of ``rec`` through the strategy's per-pair
    kernel path (``use_plan=False``), held against the plan's result.  With
    ``one_kernel`` the round's device events (``aggregate_tree_kernel`` on
    the stacked cohort, torch.profiler) must hold one kernel, the grouped
    one, and no other; copies are reported (flora reads the live ranks its
    host-side offsets need)."""
    import torch
    from repro_torch.core.strategy import stack_trees
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
    row = {"phase": phase, "launches": launches, "plain_calls": plain,
           "max_abs_err": err, "tol": tol_rel * scale}
    if one_kernel:
        stacked = stack_trees([u.adapters for u in updates])
        w = torch.tensor([float(u.n_examples) for u in updates],
                         device="cuda")
        row["round_kernels"], row["round_copies"] = _device_events(
            lambda: rec.strategy.aggregate_tree_kernel(
                stacked, w, ranks, prev_state.adapters,
                r_max=MAIN_CFG["r_max"]))
    emit(row)
    if launches[kernel] != want_launches or any(plain.values()):
        raise AssertionError(f"{phase}: launches {launches}, plain {plain}")
    if not err <= tol_rel * scale:
        raise AssertionError(f"{phase}: the per-pair kernel path disagrees "
                             "with the plan")
    if one_kernel and sum(c for c, _ in row["round_kernels"].values()) != 1:
        raise AssertionError(f"{phase}: a per-pair round ran "
                             f"{row['round_kernels']}: one grouped kernel "
                             "and nothing else expected")
    _leaves_on_card(got)
    return launches


#: the per-pair rounds per_pair_rounds times: strategy, options
PER_PAIR_ROUNDS = (("rbla", {}), ("zeropad", {}), ("rbla_ranked", {}),
                   ("flora", dict(stack_r_cap=512)))


def phase_per_pair_rounds() -> list:
    """``aggregate_tree_kernel`` -- the per-pair round, the fallback of
    every mean strategy without a plan and flora's per-pair stacking -- on
    the main-path cohort (rbla, zeropad, rbla_ranked: the MLP's three pairs,
    10 staircase clients, r_max 64, fp32, with prev) and on the flora
    cohort within the cap (the same clients, a global at storage 512 and
    live rank 64 first): wall, back-to-back and graph ms (None where the
    round reads ranks to the host and cannot be captured) and the device
    events of one call, each result against the strategy's plain path.
    Uses only APIs every version of the port has, so ``--src`` times an
    older port in the same run."""
    import torch
    from repro_torch.core import strategy
    clients, prev, w = _mlp_cohort(12)
    ranks = torch.tensor(STAIRCASE, dtype=torch.int32, device="cuda")
    stacked = strategy.stack_trees(clients)
    flora_prev = _flora_prev(prev)
    rows = []
    for name, opts in PER_PAIR_ROUNDS:
        strat = strategy.get_strategy(name).with_options(**opts)
        pv = flora_prev if name == "flora" else prev

        def call():
            return strat.aggregate_tree_kernel(stacked, w, ranks, pv,
                                               r_max=64)
        got = call()
        want = strat.aggregate_adapters(
            clients, w, r_max=64,
            client_ranks=ranks, prev_global=pv, backend="ref",
            use_plan=False)
        if name == "flora":
            err, scale = _product_err(got, want)
            tol = 1e-5 * scale
        else:
            err, scale = _rel_err({k: {s: p[s] for s in "AB"}
                                   for k, p in got.items()},
                                  {k: {s: p[s] for s in "AB"}
                                   for k, p in want.items()})
            tol = 2e-5 * max(scale, 1.0)
        try:
            graph_ms = time_ms_graph(call)
        except RuntimeError as e:       # a round that reads to the host
            graph_ms = None
            emit({"phase": "per_pair_rounds", "strategy": name,
                  "graph": f"not captured: {str(e)[:200]}"})
        kernels, copies = _device_events(call)
        row = {"phase": "per_pair_rounds", "strategy": name,
               "ms": time_ms(call),
               "back_to_back_ms": time_ms_back_to_back(call),
               "graph_ms": graph_ms, "device_kernels": kernels,
               "device_copies": copies,
               "n_device_kernels": sum(c for c, _ in kernels.values()),
               "device_ms": sum(m for _, m in kernels.values()),
               "max_abs_err": err, "tol": tol}
        emit(row)
        rows.append(row)
        if not err <= tol:
            raise AssertionError(f"per_pair_rounds {name}: the kernel round "
                                 "disagrees with the plain path")
        if ENFORCE_DESIGN and name in ("rbla", "zeropad", "flora") and \
                row["n_device_kernels"] != 1:
            raise AssertionError(f"per_pair_rounds {name}: device kernels "
                                 f"{kernels}: one grouped launch expected")
    return rows


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
    # every leaf of an fp32 fold shares one dtype triple: one launch a fold
    if folds != ASYNC_CFG["total_updates"] or per_fold != 1:
        raise AssertionError(f"async_main: {launches['axpy_fold']} axpy_fold "
                             f"launches over {folds} folds, expected one a "
                             "fold")
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
            launches["packed_agg"] != flushes or any(plain.values()):
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
        if launches["packed_agg"] != 1 or any(plain.values()) or \
                ref_plain["packed_agg"] != 1:
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
    round, then one grouped axpy_fold over every float leaf), flora its
    streaming stack (the base leaves in one grouped axpy_fold) and
    rbla_norm the replay path (packed_agg with norm_restore over the
    updates since the anchor)."""
    n = ASYNC_CFG["n_clients"]
    per_fold = {"zeropad": {"packed_agg": 1, "axpy_fold": 1},
                "fedavg": {"packed_agg": 1, "axpy_fold": 1},
                "flora": {"axpy_fold": 1},
                "rbla_norm": {"packed_agg": 1}}
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
    async_main state, through the fold plan and with the plan declined
    (rates built pair by pair)."""
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
    emit({"phase": "per_pair_fold",
          "packed_launches": counts[0][0]["axpy_fold"],
          "per_pair_launches": counts[1][0]["axpy_fold"],
          "plain_calls": sum(sum(c[1].values()) for c in counts),
          "bit_identical": same})
    # either way one grouped launch folds every leaf
    if (counts[0][0]["axpy_fold"] != 1 or counts[1][0]["axpy_fold"] != 1
            or any(sum(c[1].values()) for c in counts) or not same):
        raise AssertionError("per_pair_fold: the per-pair fold does not "
                             "reproduce the planned fold")


# ------------------------------------------------------ durable service --
#: the durable service's chaos plan at ASYNC_CFG's full width: every
#: transport fault; the crash points (received uploads, none a multiple of
#: the buffer of 5) are given per run
DURABLE_PLAN = dict(seed=1, p_drop=0.1, p_duplicate=0.1, p_reorder=0.1,
                    p_corrupt=0.05, p_truncate=0.05, p_stale_pull=0.1)
DURABLE_CRASHES = (13, 29, 47)
DURABLE_EVERY = 16


class DurableRecorder:
    """Wraps ``DurableAggregator``'s construction, journal, checkpoint and
    recovery for one run: every service built, each WAL append's seconds,
    each checkpoint's seconds and bytes, and each restart's recovery: the
    records it replayed, its milliseconds and kernel launches (the
    replay's own counts)."""

    def __init__(self):
        import os
        import torch
        from repro_torch.fl import DurableAggregator, WriteAheadLog
        from repro_torch.kernels import runtime
        self.aggs, self.journal_s, self.ckpt_s, self.ckpt_bytes = \
            [], [], [], []
        self.recoveries = []
        self._undo = []

        def patch(cls, name, wrap):
            orig = getattr(cls, name)
            setattr(cls, name, wrap(orig))
            self._undo.append((cls, name, orig))

        def init(orig):
            def f(agg, *a, **k):
                self.aggs.append(agg)
                orig(agg, *a, **k)
            return f

        def append(orig):
            def f(wal, *a, **k):
                t0 = time.perf_counter()
                seq = orig(wal, *a, **k)
                self.journal_s.append(time.perf_counter() - t0)
                return seq
            return f

        def checkpoint(orig):
            def f(agg):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = orig(agg)
                self.ckpt_s.append(time.perf_counter() - t0)
                self.ckpt_bytes.append(os.path.getsize(path))
                return path
            return f

        def recover(orig):
            def f(agg):
                torch.cuda.synchronize()
                launches = dict(runtime.LAUNCHES)
                plain = dict(runtime.PLAIN_CALLS)
                t0 = time.perf_counter()
                n = orig(agg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                # the first service of a run finds an empty directory
                if len(self.aggs) > 1:
                    self.recoveries.append({
                        "records": n, "ms": ms,
                        "launches": {k: v - launches.get(k, 0) for k, v in
                                     runtime.LAUNCHES.items()
                                     if v - launches.get(k, 0)},
                        "plain_calls": sum(runtime.PLAIN_CALLS.values())
                        - sum(plain.values())})
                return n
            return f
        patch(DurableAggregator, "__init__", init)
        patch(WriteAheadLog, "append", append)
        patch(DurableAggregator, "checkpoint", checkpoint)
        patch(DurableAggregator, "recover", recover)

    def close(self):
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)


def drive_durable(cfg_kw: dict, crash_at=None):
    """One ``run_async_simulation`` on the card under ``DURABLE_PLAN``:
    with a WAL and checkpoints in a temporary directory and crash-restarts
    at ``crash_at``, or without a WAL (``crash_at=None``).  Returns the
    history, the run's launch and plain-call counts, the final service,
    the recorder and the seconds."""
    import tempfile
    import torch
    from repro_torch.fl import AsyncFLConfig, FaultPlan, run_async_simulation
    from repro_torch.kernels import runtime
    plan = FaultPlan(**DURABLE_PLAN, crash_at=crash_at or ())
    rec, last = DurableRecorder(), AsyncRecorder()    # last: the final one
    try:
        with tempfile.TemporaryDirectory() as d:
            cfg = AsyncFLConfig(**cfg_kw)
            if crash_at is not None:
                cfg = AsyncFLConfig(**cfg_kw, wal_dir=d,
                                    checkpoint_every=DURABLE_EVERY)
            runtime.reset_counts()
            t0 = time.perf_counter()
            hist = run_async_simulation(cfg, fault_plan=plan, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    finally:
        last.close()
        rec.close()
    return hist, launches, plain, last.agg, rec, seconds


def _same_bits(a, b) -> bool:
    import torch
    from repro_torch.tree import tree_leaves
    la = tree_leaves((a.state.adapters, a.state.base_trainable))
    lb = tree_leaves((b.state.adapters, b.state.base_trainable))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _durable_case(label, cfg_kw, crash_at, replay_kernel, want=None):
    """The crashed run and its uncrashed twin (same plan, a fresh WAL):
    bit-identical unless ``want`` is given (then it is held to ``want``'s
    final state within 2e-5 of max|want|); the replays launch
    ``replay_kernel`` and no plain version."""
    hist, launches, plain, agg, rec, secs = drive_durable(cfg_kw, crash_at)
    ref = want or drive_durable(cfg_kw, ())
    ref_hist, ref_agg = ref[0], ref[3]
    replay = {}
    for r in rec.recoveries:
        for k, v in r["launches"].items():
            replay[k] = replay.get(k, 0) + v
    replay_plain = sum(r["plain_calls"] for r in rec.recoveries)
    bits = _same_bits(agg, ref_agg)
    err, scale = _rel_err(agg.state.adapters, ref_agg.state.adapters)
    line = {"phase": "async_durable", "case": label,
            "crash_at": list(crash_at), "seconds": secs,
            # the restarts that recovered, and the service's own counter,
            # which carries what the last checkpoint saw (a restart that
            # found no checkpoint starts it again from 0)
            "recovered_restarts": len(rec.recoveries),
            "n_recoveries": agg.n_recoveries, "services": len(rec.aggs),
            "n_replayed": agg.n_replayed, "n_checkpoints": len(rec.ckpt_s),
            "recoveries": rec.recoveries, "replay_launches": replay,
            "replay_plain_calls": replay_plain,
            "launches": {k: v for k, v in launches.items() if v},
            "plain_calls": {k: v for k, v in plain.items() if v},
            "test_acc": hist.test_acc, "ref_test_acc": ref_hist.test_acc,
            "mean_staleness": hist.mean_staleness,
            "n_received": agg.n_received, "version": agg.version,
            "bit_identical": bits, "max_abs_err": err, "tol": 2e-5 * scale}
    emit(line)
    if len(rec.recoveries) != len(crash_at) or len(rec.aggs) != \
            len(crash_at) + 1:
        raise AssertionError(f"async_durable {label}: {rec.recoveries} "
                             f"recoveries over {len(rec.aggs)} services")
    if replay_kernel is None:          # the plain versions on the card
        if any(launches.values()) or not replay_plain:
            raise AssertionError(f"async_durable {label}: launches "
                                 f"{launches}, replay plain {replay_plain}")
    elif (replay.get(replay_kernel, 0) < 1 or replay_plain
          or any(plain.values())):
        raise AssertionError(f"async_durable {label}: the replays launched "
                             f"{replay} and {replay_plain} plain calls, "
                             f"the run plain {plain}")
    if want is None:
        if not (bits and hist.test_acc == ref_hist.test_acc
                and hist.mean_staleness == ref_hist.mean_staleness):
            raise AssertionError(f"async_durable {label}: the recovered run "
                                 "is not the uninterrupted one bit for bit")
    elif not err <= 2e-5 * scale:
        raise AssertionError(f"async_durable {label}: {err} from its twin")
    _leaves_on_card(agg.state.adapters)
    _leaves_on_card(agg.state.base_trainable)
    return hist, launches, plain, agg, rec, secs, ref


def phase_async_durable(smi: str) -> dict:
    """The durable service at ASYNC_CFG's full width under DURABLE_PLAN:
    (a) the streaming fold with three crash-restarts against the same plan
    uncrashed, and the same plan without a WAL (the journal's cost);
    (b) a buffer of 5; (c) bf16 accumulators; (d) (a) with the plain
    versions on the card against (a); (e) rbla_median over 10 uploads with
    one crash, replayed from the anchor.  Returns the replays' launches."""
    import statistics as stats
    a = _durable_case("a_streaming", ASYNC_CFG, DURABLE_CRASHES, "axpy_fold")
    hist, launches, plain, agg, rec, secs, ref = a
    nowal = drive_durable(ASYNC_CFG, None)
    if not (_same_bits(nowal[3], ref[3]) and nowal[0].test_acc
            == ref[0].test_acc):
        raise AssertionError("async_durable: journaling changed the run")
    uploads = len(rec.journal_s)
    wal_bytes = sum(s.wal.bytes_written for s in rec.aggs)
    emit({"phase": "async_durable", "case": "figures", "card": smi,
          "checkpoint_ms": [1e3 * t for t in rec.ckpt_s],
          "checkpoint_ms_median": 1e3 * stats.median(rec.ckpt_s),
          "checkpoint_bytes": rec.ckpt_bytes,
          "restore_replay_ms": [r["ms"] for r in rec.recoveries],
          "records_replayed": [r["records"] for r in rec.recoveries],
          "wal_records": uploads, "wal_bytes": wal_bytes,
          "wal_bytes_per_record": wal_bytes / max(uploads, 1),
          "journal_ms_per_record": 1e3 * stats.mean(rec.journal_s),
          "journal_ms_median": 1e3 * stats.median(rec.journal_s),
          "run_s_crashed": secs, "run_s_wal": ref[5],
          "run_s_no_wal": nowal[5],
          "wal_over_no_wal": ref[5] / nowal[5]})
    replays = {"axpy_fold": sum(r["launches"].get("axpy_fold", 0)
                                for r in rec.recoveries)}
    b = _durable_case("b_buffered", dict(ASYNC_CFG, buffer_size=5),
                      DURABLE_CRASHES, "packed_agg")
    replays["packed_agg"] = sum(r["launches"].get("packed_agg", 0)
                                for r in b[4].recoveries)
    c = _durable_case("c_bf16_accum", dict(ASYNC_CFG,
                                           accum_dtype="bfloat16"),
                      DURABLE_CRASHES, "axpy_fold")
    if str(c[3].state.adapters["fc1"]["A"].dtype) != "torch.bfloat16":
        raise AssertionError("async_durable: the accumulators are not bf16")
    _durable_case("d_plain_twin", dict(ASYNC_CFG, agg_backend="ref"),
                  DURABLE_CRASHES, None, want=ref)
    median = dict(ASYNC_CFG, method="rbla_median", total_updates=10,
                  eval_every=10)
    e = _durable_case("e_median_anchor", median, (5,), "packed_robust",
                      want=drive_durable(median, ()))
    replays["packed_robust"] = sum(r["launches"].get("packed_robust", 0)
                                   for r in e[4].recoveries)
    return replays


# ------------------------------------------------------------ serving slice --
#: the MLP's serving paths (name, fan_in, fan_out) at full width
MLP_LAYERS = (("fc1", 784, 200), ("fc2", 200, 200), ("out", 200, 10))
#: MAIN_CFG's test set: 50 per class, 10 classes
MLP_TEST_ROWS = 10 * MAIN_CFG["n_test_per_class"]
#: benchmarks/bench_serve.py's full case (its build_rig / make_batches /
#: publish_loop defaults outside --smoke)
SERVE_CFG = dict(n_tenants=128, width=512, r_max=8, batch=512, n_batches=8,
                 iters=3, rounds=4)
SERVE_PATH = "proj"
#: how long a stream is held back in serve_streams (about 0.15 s)
SLEEP_CYCLES = 300_000_000


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _lora_inputs(m, k, n, slots, r_max, dtype, gen, all_rank_0=False):
    """``slots`` pages of ``r_max`` packed rows on the card: slot 0 (the
    null adapter) and slot 3 (an evicted one) at rank 0 (every slot with
    ``all_rank_0``), the last slot named by no request, and NaN/Inf in
    every row outside the live segments.  Returns the operands, the
    tables and the live row count."""
    import torch
    dev = "cuda"
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    r_tot = slots * r_max
    a_rows = torch.randn(r_tot, k, generator=gen, device=dev)
    b_rows = torch.randn(r_tot, n, generator=gen, device=dev)
    off = torch.arange(slots, device=dev, dtype=torch.int32) * r_max
    rank = torch.randint(1, r_max + 1, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    rank[0] = rank[3] = 0
    if all_rank_0:
        rank.zero_()
    scale = 16.0 / rank.clamp(min=1).float()
    ids = torch.randint(0, slots - 1, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    p = torch.arange(r_tot, device=dev)
    live = torch.zeros(r_tot, dtype=torch.bool, device=dev)
    for t in ids.long().unique().tolist():
        live[int(off[t]):int(off[t] + rank[t])] = True
    a_rows[~live] = float("nan")
    b_rows[~live] = float("inf")
    b_rows[~live & (p % 2 == 0)] = float("nan")
    return (x.to(dtype), w.to(dtype), a_rows.to(dtype), b_rows.to(dtype),
            ids, off, rank, scale, int(live.sum()))


def _lora_case(kernel, label, shape, dtype, got, want, bytes_moved, flops,
               times, extra=None):
    import torch
    finite = bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = (2e-2 if dtype == torch.bfloat16 else 2e-5) * scale
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    bms, by = bound(bytes_moved, flops, peak)
    # the same work at the rate of the tensor cores the kernel runs on
    # (bf16, or TF32 for fp32 operands: three TF32 products a product)
    tc = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else TF32_FLOPS_PER_S
    tc_ms, tc_by = bound(bytes_moved, flops, tc)
    case = {"kernel": kernel, "case": label, "shape": shape,
            "dtype": _dtype_name(dtype), **(extra or {}),
            "max_abs_err": err, "tol": tol, "finite": finite, **times,
            "bound_ms": bms, "bound_by": by, "bound_tc_ms": tc_ms,
            "bound_tc_by": tc_by, "library_ms": None,
            "bytes": bytes_moved, "flops": flops, "peak_flops_per_s": peak,
            "tc_flops_per_s": tc}
    emit(case)
    if not (finite and err <= tol):
        raise AssertionError(f"{kernel} disagrees with its plain version: "
                             f"{case}")
    return case


def _lora_times(kernel, plain, x, w, split=False) -> dict:
    """The wrapper's time, its plain version's, the base product's
    ``torch.matmul(x, W)`` (context only: no single PyTorch call computes
    the function, so library_ms is null), the wrapper issued back to back,
    and the device's time alone (``graph_ms``: a CUDA graph of 20 calls),
    so that ``ms`` minus ``graph_ms`` is host work.  With ``split`` also
    the device kernels of one call from ``torch.profiler``."""
    import torch
    times = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
             "matmul_ms": time_ms(lambda: torch.matmul(x, w)),
             "back_to_back_ms": time_ms_back_to_back(kernel),
             "graph_ms": time_ms_graph(kernel)}
    if split:
        kernels, copies = _device_events(kernel)
        times["device_kernels"] = {**kernels, **copies}
    return times


def check_batched_case(label, m, k, n, slots, r_max, dtype, seed,
                       all_rank_0=False):
    """batched_lora_matmul on the card against the segment lowering on the
    same inputs (``ms``: the wrapper and its launch, ids and tenant tables
    passed as they are; ``plain_ms``: the segment lowering on segments
    gathered beforehand).  At the serve and large shapes the device
    kernels of one call are listed, and at the serve shape they must be
    the kernel's two alone: no clamp, gather or cast."""
    import torch
    from repro_torch.kernels.lora_matmul import (
        batched_lora_matmul, batched_lora_matmul_segments)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, w, a, b, ids, off, rank, sc, live = _lora_inputs(
        m, k, n, slots, r_max, dtype, gen, all_rank_0)
    idx = ids.long()                    # every id names a table entry here
    seg = (off[idx], rank[idx], sc[idx])

    def kernel():
        return batched_lora_matmul(x, w, a, b, ids, off, rank, sc)

    def plain():
        return batched_lora_matmul_segments(x, w, a, b, *seg)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    times = _lora_times(kernel, plain, x, w,
                        split=label.startswith(("serve", "large")))
    dk = times.get("device_kernels")
    if ENFORCE_DESIGN and label == "serve" and dk and (
            set(dk) != {"down_kernel", "gemm_kernel"}
            or any(v[0] != 1 for v in dk.values())):
        raise AssertionError(f"batched_lora_matmul at the serve shape runs "
                             f"{dk}, not its two kernels once each")
    s = x.element_size()
    cnt_sum = int(seg[1].sum())
    # each input read once: x, W, the live rows of a_rows and b_rows, the
    # ids and the tenant tables; y written once
    bytes_moved = (m * k + k * n + live * (k + n) + m * n) * s + 4 * m \
        + 12 * slots
    flops = 2 * m * n * k + 2 * cnt_sum * (k + n)
    return _lora_case("batched_lora_matmul", label,
                      [m, k, n, slots * r_max], dtype, got, want, bytes_moved,
                      flops, times,
                      {"live_rows": live, "rank_rows_used": cnt_sum})


def check_single_case(label, m, k, n, r, dtype, seed):
    """lora_matmul on the card against lora_matmul_ref, with the device
    kernels of one call (``torch.profiler``)."""
    import torch
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(dtype)
    a = torch.randn(r, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, r, generator=gen, device="cuda").to(dtype)
    scale = torch.tensor(16.0 / r, device="cuda")

    def kernel():
        return lora_matmul(x, w, a, b, scale)

    def plain():
        return lora_matmul_ref(x, w, a, b, scale)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    times = _lora_times(kernel, plain, x, w, split=True)
    dk = times["device_kernels"]
    if ENFORCE_DESIGN and dk and (
            set(dk) != {"down_gemm_kernel", "gemm_kernel"}
            or any(v[0] != 1 for v in dk.values())):
        raise AssertionError(f"lora_matmul {label} runs {dk}, not its two "
                             "kernels once each")
    s = x.element_size()
    bytes_moved = (m * k + k * n + r * k + n * r + m * n) * s + 4
    flops = 2 * m * n * k + 2 * m * r * (k + n)
    return _lora_case("lora_matmul", label, [m, k, n, r], dtype, got, want,
                      bytes_moved, flops, times)


def phase_lora_kernels() -> dict:
    """Both lora kernels at the MLP's serving paths, bench_serve's full case
    and one large case; returns their summary rows: batched_lora_matmul
    at one serve_main apply (fp32), lora_matmul summed over one
    serve_dense pass (the MLP's three layers, fp32)."""
    import torch
    batched, single = [], []
    seed = 100
    w = SERVE_CFG["width"]
    for dtype in (torch.float32, torch.bfloat16):
        for name, k, n in MLP_LAYERS:
            seed += 1
            batched.append(check_batched_case(
                f"mlp {name}", MLP_TEST_ROWS, k, n, 11, 64, dtype, seed))
            single.append(check_single_case(
                f"mlp {name}", MLP_TEST_ROWS, k, n, 64, dtype, seed))
        batched.append(check_batched_case(
            "serve", SERVE_CFG["batch"], w, w, SERVE_CFG["n_tenants"],
            SERVE_CFG["r_max"], dtype, seed + 10))
        single.append(check_single_case("serve", SERVE_CFG["batch"], w, w,
                                        SERVE_CFG["r_max"], dtype, seed + 10))
        batched.append(check_batched_case("large", 4096, 4096, 4096, 32, 64,
                                          dtype, seed + 20))
        # the base product alone: every tenant at rank 0
        batched.append(check_batched_case("large rank 0", 4096, 4096, 4096,
                                          32, 64, dtype, seed + 20,
                                          all_rank_0=True))
        single.append(check_single_case("large", 4096, 4096, 4096, 64, dtype,
                                        seed + 20))

    def row(name, cases, picked):
        return {"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": sum(c["ms"] for c in picked),
                "plain_ms": sum(c["plain_ms"] for c in picked),
                "bound_ms": sum(c["bound_ms"] for c in picked),
                "bound_by": max(picked, key=lambda c: c["bound_ms"])[
                    "bound_by"],
                "library_ms": None,
                "matmul_ms": sum(c["matmul_ms"] for c in picked),
                "back_to_back_ms": sum(c["back_to_back_ms"] for c in picked),
                "graph_ms": sum(c["graph_ms"] for c in picked),
                "bound_tc_ms": sum(c["bound_tc_ms"] for c in picked)}
    serve = [c for c in batched if c["case"] == "serve"
             and c["dtype"] == "float32"]
    mlp = [c for c in single if c["case"].startswith("mlp")
           and c["dtype"] == "float32"]
    return {"batched_lora_matmul": row("batched_lora_matmul", batched, serve),
            "lora_matmul": row("lora_matmul", single, mlp)}


def _pow2(v: int) -> int:
    return 1 << max(math.ceil(math.log2(max(v, 1))), 0)


def _noisy(tree, rng, sigma):
    """``tree`` with numpy normal noise of ``sigma`` added to each pair's A
    then B (sorted paths), as bench_serve perturbs its globals; factors on
    the card, rank leaves on the host."""
    import torch
    out = {}
    for path in sorted(tree):
        pair = tree[path]
        out[path] = {side: (pair[side] + torch.as_tensor(
            rng.normal(size=tuple(pair[side].shape)) * sigma,
            dtype=torch.float32)).cuda() for side in ("A", "B")}
        out[path]["rank"] = pair["rank"].cpu()
    return out


def _serve_rig(seed: int = 0):
    """bench_serve.build_rig on the card: 128 tenants at numpy-drawn ranks
    1..8 over one 512-wide projection, all serving re-slices of one
    global (its A from the port's seeded init, plus bench_serve's numpy
    noise).  The store is full: the next registration grows it."""
    import numpy as np
    import torch
    from repro_torch.lora import init_adapters
    from repro_torch.serving import AdapterStore, ServingEngine
    c = SERVE_CFG
    rng = np.random.default_rng(seed)
    specs = {SERVE_PATH: (c["width"], c["width"])}
    w = torch.as_tensor(rng.normal(size=(c["width"], c["width"])) * 0.05,
                        dtype=torch.float32).cuda()
    store = AdapterStore(specs, r_max=c["r_max"],
                         init_pages=_pow2(c["n_tenants"]),
                         init_tenant_capacity=_pow2(c["n_tenants"] + 1))
    engine = ServingEngine({SERVE_PATH: w}, store)
    ranks = rng.integers(1, c["r_max"] + 1, c["n_tenants"])
    for t in range(c["n_tenants"]):
        store.register(f"tenant-{t}", rank=int(ranks[t]))
    glob = _noisy(init_adapters(torch.Generator().manual_seed(seed), specs,
                                c["r_max"], c["r_max"]), rng, 0.1)
    engine.publish(glob)
    return store, engine, glob, specs


def _serve_batches(seed: int = 1):
    """bench_serve.make_batches: every batch a different tenant mix (ids
    are slots 1..n_tenants; slot 0 is the null adapter)."""
    import numpy as np
    import torch
    c = SERVE_CFG
    rng = np.random.default_rng(seed)
    xs = [torch.as_tensor(rng.normal(size=(c["batch"], c["width"])),
                          dtype=torch.float32).cuda()
          for _ in range(c["n_batches"])]
    ids = [torch.as_tensor(rng.integers(1, c["n_tenants"] + 1, c["batch"]),
                           dtype=torch.int32).cuda()
           for _ in range(c["n_batches"])]
    return xs, ids


def _rel(got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    return err / max(1.0, float(want.float().abs().max()))


def phase_serve_main():
    import numpy as np
    import torch
    from repro_torch.core.strategy import ClientUpdate, ServerState
    from repro_torch.fl import AsyncAggregator
    from repro_torch.kernels import runtime
    from repro_torch.lora import init_adapters, set_ranks
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import merged_reference
    c = SERVE_CFG
    store, engine, glob, specs = _serve_rig()
    xs, ids = _serve_batches()
    runtime.reset_counts()
    applies = 0
    t_start = time.perf_counter()
    # parity with the per-tenant reference before anything is timed
    got = engine.apply(SERVE_PATH, xs[0], ids[0])
    applies += 1
    parity = _rel(got, merged_reference(engine, SERVE_PATH, xs[0], ids[0]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    for _ in range(c["iters"]):
        for x, i in zip(xs, ids):
            engine.apply(SERVE_PATH, x, i)
            applies += 1
            done += x.shape[0]
    torch.cuda.synchronize()
    rps = done / (time.perf_counter() - t0)

    # aggregate -> publish -> serve: fold client updates through the async
    # service, whose on_publish hook hot-swaps the live store
    state = ServerState(adapters={p: {"A": q["A"], "B": q["B"],
                                      "rank": q["rank"].cuda()}
                                  for p, q in glob.items()},
                        base_trainable={}, r_max=c["r_max"])
    # its own registry: the obs phase then reports this service alone
    agg = AsyncAggregator("rbla", state, on_publish=engine.publisher(),
                          registry=MetricsRegistry())
    rng = np.random.default_rng(5)
    v0 = store.version
    t_pub = 0.0
    for rnd in range(c["rounds"]):
        r = int(rng.integers(1, c["r_max"] + 1))
        upd = _noisy(init_adapters(torch.Generator().manual_seed(100 + rnd),
                                   specs, c["r_max"], r), rng, 0.05)
        upd = set_ranks({p: {**q, "rank": q["rank"].cuda()}
                         for p, q in upd.items()}, r)
        t0 = time.perf_counter()
        agg.submit(ClientUpdate(adapters=upd, base_trainable={},
                                n_examples=1.0, rank=r))
        torch.cuda.synchronize()
        t_pub += time.perf_counter() - t0
        engine.apply(SERVE_PATH, xs[rnd % len(xs)], ids[rnd % len(ids)])
        applies += 1
        torch.cuda.synchronize()
    versions = store.version - v0
    got = engine.apply(SERVE_PATH, xs[0], ids[0])
    applies += 1
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    post = _rel(got, merged_reference(engine, SERVE_PATH, xs[0], ids[0]))
    emit({"phase": "serve_main", "config": SERVE_CFG,
          "requests_per_s": rps, "publish_ms": t_pub / c["rounds"] * 1e3,
          "versions_advanced": versions, "applies": applies,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v},
          "parity_rel_err": parity, "post_publish_rel_err": post,
          "tol": 2e-5, "seconds": time.perf_counter() - t_start,
          "finite": bool(torch.isfinite(got).all())})
    if not (parity <= 2e-5 and post <= 2e-5):
        raise AssertionError("serve_main disagrees with merged_reference")
    if launches["batched_lora_matmul"] != applies or any(plain.values()):
        raise AssertionError(f"serve_main: {applies} applies, launches "
                             f"{launches}, plain {plain}")
    if versions != c["rounds"] or agg.n_published != c["rounds"]:
        raise AssertionError(f"serve_main: {versions} versions over "
                             f"{c['rounds']} publishes")
    return launches, engine, agg


def _mlp_rig(last):
    """The main path's frozen base (re-drawn from its seed, as the simulator
    draws it), its final biases and global adapters, the test set and the
    last cohort's ranks."""
    import torch
    from repro_torch.data import make_dataset
    from repro_torch.fl.client import merge_base_params, split_base_params
    from repro_torch.models.paper_nets import PAPER_MODELS
    from repro_torch.tree import tree_map
    model = PAPER_MODELS["mlp"]()
    params0 = model.init(torch.Generator().manual_seed(MAIN_CFG["seed"]))
    frozen, _ = split_base_params(params0, model.lora_specs)
    state = last[2]
    params = merge_base_params(tree_map(lambda t: t.cuda(), frozen),
                               state.base_trainable)
    test = make_dataset(MAIN_CFG["dataset"], MAIN_CFG["n_test_per_class"],
                        MAIN_CFG["seed"], "test")
    x = torch.as_tensor(test.x).cuda().reshape(len(test.x), -1)
    y = torch.as_tensor(test.y).cuda().long()
    ranks = [u.rank for u in last[1]]
    return model, params, state.adapters, x, y, ranks


def phase_serve_mlp(last, main_acc):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import runtime
    from repro_torch.lora import set_ranks
    from repro_torch.serving import (AdapterStore, ServingEngine,
                                     merged_reference)
    model, params, glob, x, y_true, ranks = _mlp_rig(last)
    store = AdapterStore(model.lora_specs, r_max=MAIN_CFG["r_max"],
                         init_pages=16, init_tenant_capacity=16)
    engine = ServingEngine({p: params[p]["w"].T for p in model.lora_specs},
                           store)
    slots = [store.register(f"client-{i}", rank=r)
             for i, r in enumerate(ranks)]
    engine.publish(glob)
    choice = np.random.default_rng(3).integers(0, len(ranks) + 1, len(x))
    ids = torch.as_tensor([0 if c == 0 else slots[c - 1] for c in choice],
                          dtype=torch.int32).cuda()
    snap = engine.snapshot()
    runtime.reset_counts()
    h, layer_err = x, {}
    for name, _, _ in MLP_LAYERS:
        out = engine.apply(name, h, ids, snapshot=snap)
        layer_err[name] = _rel(out, merged_reference(engine, name, h, ids,
                                                     snapshot=snap))
        h = out + params[name]["b"]
        if name != "out":
            h = F.relu(h)
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    want = torch.empty_like(h)
    for c in range(len(ranks) + 1):
        rows = torch.as_tensor(choice == c).cuda()
        lora = None if c == 0 else set_ranks(glob, ranks[c - 1])
        want[rows] = model.apply(params, lora, x[rows])
    forward_err = _rel(h, want)
    acc = float((h.argmax(-1) == y_true).float().mean())
    # a publish while the batch's snapshot is pinned: its bytes stay
    pinned = engine.apply("fc1", x, ids, snapshot=snap)
    engine.publish({p: {"A": 2.0 * q["A"], "B": q["B"], "rank": q["rank"]}
                    for p, q in glob.items()})
    again = engine.apply("fc1", x, ids, snapshot=snap)
    fresh = engine.apply("fc1", x, ids)
    torch.cuda.synchronize()
    same, moved = torch.equal(again, pinned), not torch.equal(fresh, pinned)
    emit({"phase": "serve_mlp", "tenants": len(ranks), "ranks": ranks,
          "rows": len(x), "layer_rel_err_vs_merged_reference": layer_err,
          "forward_rel_err_vs_model": forward_err, "tol": 2e-5,
          "forward_tol": 1e-4, "served_accuracy": acc,
          "main_path_final_accuracy": main_acc,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v},
          "pinned_batch_unchanged": same, "fresh_batch_moved": moved,
          "occupancy": store.occupancy()})
    # the forward chains three fp32 layers, each summed in another order
    # than the model's cuBLAS products: 1e-4 of max|logit|
    if not (max(layer_err.values()) <= 2e-5 and forward_err <= 1e-4):
        raise AssertionError("serve_mlp disagrees with its references")
    if launches["batched_lora_matmul"] != 3 or any(plain.values()):
        raise AssertionError(f"serve_mlp: launches {launches}, plain {plain}")
    if not (same and moved):
        raise AssertionError("serve_mlp: the pinned batch moved under a "
                             "publish, or the fresh one did not")


def _hazard(name, ok, **detail):
    emit({"phase": "serve_streams", "hazard": name, "ok": ok, **detail})
    if not ok:
        raise AssertionError(f"serve_streams {name} failed: {detail}")


def _buffer_ptr(store) -> int:
    return store.snapshot().pair_buffers(SERVE_PATH)[0].data_ptr()


def _held_batch(engine, x, i):
    """``engine.apply`` on a fresh side stream held back by a sleep; the
    batch's snapshot is dropped when apply returns."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        return engine.apply(SERVE_PATH, x, i)


def phase_serve_streams():
    """Each hazard on a fresh serve_main rig, the earlier operation held
    back by ``torch.cuda._sleep`` on its stream so that, without the
    store's stream rule, the later one would overtake it.  The published
    globals carry host rank leaves, so publishing reads nothing back."""
    import numpy as np
    import torch
    from repro_torch.serving import merged_reference
    xs, ids = _serve_batches()
    x, i = xs[0], ids[0]

    def new_global(seed):
        rng = np.random.default_rng(seed)
        r, w = SERVE_CFG["r_max"], SERVE_CFG["width"]
        return {SERVE_PATH: {
            "A": torch.as_tensor(rng.normal(size=(r, w)) * 0.1,
                                 dtype=torch.float32).cuda(),
            "B": torch.as_tensor(rng.normal(size=(w, r)) * 0.1,
                                 dtype=torch.float32).cuda(),
            "rank": torch.tensor(r, dtype=torch.int32)}}

    # 1. write after read: a held side-stream batch, then an in-place
    #    publish on the default stream
    store, engine, _, _ = _serve_rig()
    ref = engine.apply(SERVE_PATH, x, i)
    torch.cuda.synchronize()
    y = _held_batch(engine, x, i)
    ptr, pins = _buffer_ptr(store), store.pinned_snapshots
    engine.publish(new_global(7))
    in_place = _buffer_ptr(store) == ptr
    torch.cuda.synchronize()
    same = torch.equal(y, ref)
    _hazard("write_after_read", pins == 0 and in_place and same,
            pinned_snapshots=pins, in_place=in_place, bit_identical=same)

    # 2. read after write: a publish held back on the default stream, then
    #    a side-stream batch with a fresh snapshot
    store, engine, _, _ = _serve_rig()
    old = engine.apply(SERVE_PATH, x, i)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    engine.publish(new_global(8))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = engine.apply(SERVE_PATH, x, i)
    torch.cuda.synchronize()
    err = _rel(y, merged_reference(engine, SERVE_PATH, x, i))
    changed = not torch.allclose(y, old)
    _hazard("read_after_write", err <= 2e-5 and changed, rel_err=err,
            tol=2e-5, sees_new_version=changed)

    # 3. free while read: a held side-stream batch, then capacity growth
    #    replaces its buffers and new allocations of their size on the
    #    default stream are filled with NaN
    store, engine, _, _ = _serve_rig()
    ref = engine.apply(SERVE_PATH, x, i)
    torch.cuda.synchronize()
    y = _held_batch(engine, x, i)
    shape = tuple(store.snapshot().pair_buffers(SERVE_PATH)[0].shape)
    ptr = _buffer_ptr(store)
    store.register("grows", rank=4)
    grew = _buffer_ptr(store) != ptr
    junk = [torch.full(shape, float("nan"), device="cuda") for _ in range(8)]
    engine.publish(new_global(9))
    torch.cuda.synchronize()
    same = torch.equal(y, ref)
    _hazard("free_while_read", grew and same, grew=grew,
            rows_before=shape[0], bit_identical=same)
    del junk


def phase_serve_dense(last):
    """lora_dense_apply, the single-adapter kernel's caller, on each MLP
    layer of the final global at its full rank, against the plain dense
    layer; the activations flow layer to layer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import runtime
    from repro_torch.kernels.lora_matmul import lora_dense_apply
    from repro_torch.models.paper_nets import dense_apply
    _, params, glob, x, _, _ = _mlp_rig(last)
    layers = {name: {"w": params[name]["w"].T.contiguous(),
                     "b": params[name]["b"]} for name, _, _ in MLP_LAYERS}
    runtime.reset_counts()
    h, outs = x, []
    for name, _, _ in MLP_LAYERS:
        outs.append((name, h, lora_dense_apply(layers[name], h, glob[name])))
        h = F.relu(outs[-1][2])
    torch.cuda.synchronize()
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    err = {name: _rel(got, dense_apply(params[name], inp, glob[name]))
           for name, inp, got in outs}
    emit({"phase": "serve_dense", "rel_err": err, "tol": 2e-5,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v}})
    if max(err.values()) > 2e-5:
        raise AssertionError("serve_dense disagrees with dense_apply")
    if launches["lora_matmul"] != 3 or any(plain.values()):
        raise AssertionError(f"serve_dense: launches {launches}, plain "
                             f"{plain}")
    return launches


def phase_obs(agg, engine):
    from repro_torch.obs import ServiceHealth
    health = ServiceHealth(aggregator=agg, engine=engine).snapshot()
    emit({"phase": "obs", "health": health})
    if health["store"]["version"] < SERVE_CFG["rounds"]:
        raise AssertionError(f"obs: store view {health['store']}")


# ------------------------------------------------------------------ mamba2 --
#: mamba2-1.3b's serving path as chip_smoke drives it: the full config (48
#: layers, d_model 2048, 64 heads x 64, state 128, chunk 256, bf16), batch
#: 4, a 2048-token prompt, 16 new tokens, adapters at rank 8 of r_max 64
MAMBA_CFG = dict(arch="mamba2-1.3b", batch=4, prompt_len=2048, new=16,
                 rank=8, r_max=64)
#: the serve invariant at full width, at a smaller batch and prompt
MAMBA_CONSISTENCY = dict(batch=1, prompt_len=512, decode=8)
#: One bf16 layer's mixer output on the kernel path against the same layer
#: with the plain scan on fp32-upcast operands (its outputs rounded back to
#: bf16, as the kernel rounds them), from the same input: the kernel's bf16
#: tolerance.  Two bf16 paths are not compared end to end: at random init
#: the 48-layer stack amplifies one rounding's difference, and the bf16
#: model's last logits land 20-30% of max|logit| away from the same weights
#: run in fp32 whichever scan is used (PERF.md §6)
MAMBA_BF16_TOL = 2e-2
#: The same stack in fp32 at full width and full depth: last logits of
#: two paths within the ssd_scan reference's 2e-3 of max|want|
MAMBA_FP32_TOL = 2e-3
#: (label, b, l, h, p, n, chunk, |dta| scale): tests/test_kernels.py's
#: SSD_SHAPES, one mamba2-1.3b layer at batch 1 and 4 (|dta| near what its
#: prefill gives: softplus of a unit normal at A = -1), L = 2000 (Q 250), a
#: prime L (Q 1), one jamba-1.5-large-398b mamba layer as moe_zoo's prefill
#: gives it (batch 2, L 1024, h 256)
#: and a decay that takes a_cs past -100 within a chunk
SSD_CASES = (
    ("ssd_shape_1", 1, 32, 2, 8, 16, 8, 0.5),
    ("ssd_shape_2", 2, 64, 4, 16, 32, 16, 0.5),
    ("ssd_shape_3", 1, 128, 2, 64, 128, 32, 0.5),
    ("ssd_shape_4", 2, 48, 3, 8, 8, 16, 0.5),
    ("mamba_layer_b1", 1, 2048, 64, 64, 128, 256, 0.7),
    ("mamba_layer_b4", 4, 2048, 64, 64, 128, 256, 0.7),
    ("l2000_q250", 1, 2000, 64, 64, 128, 256, 0.7),
    ("prime_l127_q1", 2, 127, 4, 16, 32, 32, 0.5),
    ("jamba_layer", 2, 1024, 256, 64, 128, 256, 0.7),
    ("large_decay", 1, 512, 8, 64, 128, 256, 8.0),
)


def _ssd_work(b, l, h, p, n, q, s) -> tuple[int, int]:
    """(bytes, flops) of one scan: each operand read once and each output
    written once (operands of s bytes, dta fp32); C B^T once per (b,
    chunk) as ssd_chunked counts it, and per (b, h, chunk) y_diag, and y_off
    and the state 2 Q N P each.  The causal mask leaves C B^T and y_diag
    their lower triangle with the diagonal, Q (Q + 1) / 2 of the Q^2 pairs:
    Q (Q + 1) N and Q (Q + 1) P."""
    nc = l // q
    bytes_moved = (2 * b * l * h * p + 2 * b * l * n + b * h * p * n) * s \
        + 4 * b * l * h
    flops = b * nc * q * (q + 1) * n \
        + b * h * nc * (q * (q + 1) * p + 4 * q * n * p)
    return bytes_moved, flops


def _phase_ms(fn, calls: int = 5) -> dict:
    """Device time per call of each of the scan's kernels (its phases), by
    name; empty where the profiler reports no device time."""
    return {name[4:]: ms for name, (_, ms) in _device_kernels(fn, calls).items()
            if name.startswith("ssd_")}


def check_ssd_case(label, b, l, h, p, n, chunk, scale, dtype, seed) -> dict:
    """ssd_scan on the card against ssd_scan_ref on the same inputs: fp32
    within the reference's 2e-3 of max|want|; bf16 operands against the
    plain version on their fp32 upcast within 2e-2.  Every output finite."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd_scan import (chunk_len, ssd_scan,
                                              ssd_scan_ref)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xdt = torch.randn(b, l, h, p, generator=gen, device="cuda") * 0.5
    dta = -torch.randn(b, l, h, generator=gen, device="cuda").abs() * scale
    bm = torch.randn(b, l, n, generator=gen, device="cuda") * 0.5
    cm = torch.randn(b, l, n, generator=gen, device="cuda") * 0.5
    xdt, bm, cm = xdt.to(dtype), bm.to(dtype), cm.to(dtype)
    q = chunk_len(l, chunk)
    a_cs_min = float(dta.reshape(b, l // q, q, h).cumsum(2).min())
    before = runtime.LAUNCHES["ssd_scan"]
    y, hl = ssd_scan(xdt, dta, bm, cm, chunk)
    launches = runtime.LAUNCHES["ssd_scan"] - before
    want_y, want_h = ssd_scan_ref(xdt.float(), dta, bm.float(), cm.float(),
                                  chunk)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(y.float()).all()
                  and torch.isfinite(hl.float()).all())
    err = max(float((y.float() - want_y).abs().max()),
              float((hl.float() - want_h).abs().max()))
    big = max(1.0, float(want_y.abs().max()), float(want_h.abs().max()))
    tol = (2e-2 if dtype == torch.bfloat16 else 2e-3) * big

    def kernel():
        return ssd_scan(xdt, dta, bm, cm, chunk)

    def plain():
        return ssd_scan_ref(xdt, dta, bm, cm, chunk)
    reps = 25 if b * l * h < 2 ** 20 else 10
    times = {"ms": time_ms(kernel, reps), "plain_ms": time_ms(plain, reps),
             "back_to_back_ms": time_ms_back_to_back(kernel, 10, 3)}
    if label.startswith("mamba_layer"):
        times["phases_ms"] = _phase_ms(kernel)
    bytes_moved, flops = _ssd_work(b, l, h, p, n, q, xdt.element_size())
    bms, by = bound(bytes_moved, flops)
    # the same work at the rate of the tensor cores the kernel runs on
    tc_ms, tc_by = bound(bytes_moved, flops, TF32_FLOPS_PER_S)
    case = {"kernel": "ssd_scan", "case": label, "shape": [b, l, h, p, n],
            "chunk": q, "dtype": _dtype_name(dtype), "a_cs_min": a_cs_min,
            "max_abs_err": err, "tol": tol, "finite": finite,
            "launches": launches, **times, "bound_ms": bms, "bound_by": by,
            "bound_tf32_ms": tc_ms, "bound_tf32_by": tc_by,
            "library_ms": None, "bytes": bytes_moved, "flops": flops}
    emit(case)
    if not (finite and err <= tol and launches == 1):
        raise AssertionError(f"ssd_scan disagrees with its plain version: "
                             f"{case}")
    return case


def phase_ssd_kernels() -> dict:
    """Every ssd_scan case in fp32 and in bf16; returns the summary row:
    one launch at mamba_main's shape and dtype (batch 4, L 2048, bf16)."""
    import torch
    cases = []
    for i, (label, *shape) in enumerate(SSD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(check_ssd_case(label, *shape, dtype, 200 + i))
    main = next(c for c in cases if c["case"] == "mamba_layer_b4"
                and c["dtype"] == "bfloat16")
    return {"name": "ssd_scan", "route": "cuda", "source": SOURCE["ssd_scan"],
            "replaces": REPLACES["ssd_scan"], "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per": "one launch (batch 4, L 2048, bf16)",
            "back_to_back_ms": main["back_to_back_ms"],
            "bound_tf32_ms": main["bound_tf32_ms"],
            "phases_ms": main.get("phases_ms")}


def _lm_rig(cfg, spec, dtype=None):
    """``cfg`` at full width on the card: Model.init and init_adapters
    (seeds 0 and 1) as repro_torch.launch.serve makes them (weights in
    ``dtype`` if given, else the config's), each pair's B then drawn
    nonzero on its live columns (seed 2) so the LoRA term of every dense is
    live (the encoder's and the front-end projector's too), and the batch
    dict of ``spec``'s prompt ``tokens`` (seed 3), with a front-end's
    frames or patches (:func:`_frontend_inputs`)."""
    import dataclasses
    import torch
    from repro_torch.lora import mask_pair, tree_map_pairs
    from repro_torch.models.model import make_model
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device="cuda").manual_seed(1),
        r_max=spec["r_max"], rank=spec["rank"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    adapters = tree_map_pairs(lambda pair: mask_pair(dict(pair, B=torch.randn(
        pair["B"].shape, generator=gen, device="cuda") * 0.02)), adapters)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (spec["batch"], spec["prompt_len"]),
        generator=torch.Generator(device="cuda").manual_seed(3),
        device="cuda")}
    if cfg.frontend != "none":
        batch.update(_frontend_inputs(cfg, spec["batch"]))
    return cfg, model, params, adapters, batch


def _frontend_inputs(cfg, b: int) -> dict:
    """A front-end arch's inputs on the card: whisper's frames (b,
    encoder_seq, frontend_dim) or phi's patches (b, n_prefix_tokens,
    frontend_dim), fp32 normal from seed 4."""
    import torch
    n = cfg.encoder_seq if cfg.is_encdec else cfg.n_prefix_tokens
    x = torch.randn((b, n, cfg.frontend_dim),
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    return {"frames" if cfg.is_encdec else "patches": x}


def _as_batch(batch: dict, b=None, s=None) -> dict:
    """A batch dict's first ``b`` rows, its tokens cut to ``s``."""
    out = {k: v[:b] for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :s]
    return out


def _mamba_rig():
    """mamba2-1.3b at full width on the card (MAMBA_CFG, :func:`_lm_rig`)."""
    from repro_torch.configs import get_config
    return _lm_rig(get_config(MAMBA_CFG["arch"]), MAMBA_CFG)


def _logit_err(got, want, tol) -> tuple[float, float]:
    """(max |got - want|, the tolerance tol * max(1, max|want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, tol * max(1.0, float(want.float().abs().max()))


def _fp32_rig(rig):
    """The same model, weights and adapters in fp32 (the bf16 weights
    upcast exactly), on the card."""
    import dataclasses
    from repro_torch.models.model import make_model
    from repro_torch.tree import tree_map
    cfg, _, params, adapters, batch = rig
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    return cfg32, make_model(cfg32, remat=False), p32, adapters, batch


def phase_mamba_main(rig) -> tuple[dict, "object"]:
    """repro_torch.launch.serve's path at full width: one prefill (48
    ssd_scan launches, no plain call) and 15 greedy decode steps."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import generate
    cfg, model, params, adapters, batch = rig
    generate(model, params, adapters, _as_batch(batch, s=256), 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    res = generate(model, params, adapters, batch, MAMBA_CFG["new"])
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(res["prefill_logits"].float()).all()
                  and torch.isfinite(res["logits"].float()).all())
    steps = MAMBA_CFG["new"] - 1
    emit({"phase": "mamba_main", "config": MAMBA_CFG,
          "layers": cfg.n_layers, "prefill_ms": res["prefill_s"] * 1e3,
          "decode_steps": steps,
          "decode_tok_per_s": steps * MAMBA_CFG["batch"] / res["decode_s"],
          "decode_ms_per_step": res["decode_s"] * 1e3 / steps,
          "peak_device_bytes": peak,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v},
          "finite": finite, "tokens": res["tokens"][0].tolist()})
    if launches["ssd_scan"] != cfg.n_layers or any(plain.values()):
        raise AssertionError(f"mamba_main: ssd_scan launched "
                             f"{launches['ssd_scan']} times (want "
                             f"{cfg.n_layers}), plain calls {plain}")
    if not finite or res["tokens"].shape != (MAMBA_CFG["batch"],
                                             MAMBA_CFG["new"]):
        raise AssertionError("mamba_main: logits not finite or tokens "
                             "misshapen")
    return launches, res["prefill_logits"]


def _plain_scan_in_fp32(xdt, dta, bm, cm, chunk):
    """The plain scan on fp32-upcast operands, its outputs rounded back to
    xdt's dtype, as the kernel computes and rounds."""
    from repro_torch.kernels.ssd_scan import ssd_scan_ref
    y, h = ssd_scan_ref(xdt.float(), dta, bm.float(), cm.float(), chunk)
    return y.to(xdt.dtype), h.to(xdt.dtype)


def _layer_walk(rig) -> tuple[list, list]:
    """The kernel path's bf16 prefill layer by layer: each of the 48 mixers
    runs from the kernel path's residual stream with the kernel, with the
    plain scan on fp32-upcast operands (checked, MAMBA_BF16_TOL) and with
    the plain scan in bf16 (recorded); returns each layer's (error,
    tolerance) of the two plain runs' mixer outputs.  The outputs are
    compared before the residual add, whose bf16 rounding at the stream's
    magnitude would swamp them."""
    from repro_torch.models.common import embed
    from repro_torch.models.mamba import mamba_forward
    from repro_torch.tree import tree_map
    cfg, _, params, adapters, batch = rig
    mix = params["stages"][0]["b0"]["mix"]
    pairs = adapters["stages"][0]["b0"]          # {"mix/in_proj": pair, ..}
    x = embed(params["embed"], batch["tokens"])
    upcast, bf16 = [], []
    for i in range(cfg.stages[0].repeat):
        p = tree_map(lambda t: t[i], mix)
        lora = {k.split("/", 1)[1]: tree_map(lambda t: t[i], v)
                for k, v in pairs.items()}

        def mixer(backend, **plain):
            return mamba_forward(p, lora, x, cfg, mode="full",
                                 scan_backend=backend, **plain)[0]
        got = mixer("auto")
        upcast.append(_logit_err(
            got, mixer("ref", plain_scan=_plain_scan_in_fp32),
            MAMBA_BF16_TOL))
        bf16.append(_logit_err(got, mixer("ref"), 1.0))
        x = x + got
    return upcast, bf16


def phase_mamba_plain(rig, rig32, kernel_logits):
    """The same prefill with the plain scan (Model(scan_backend="ref")) on
    the card: 0 launches and 48 plain calls; its bf16 logits' distance from
    mamba_main's is recorded.  The checks: every layer's bf16 mixer output,
    from the kernel path's input, within MAMBA_BF16_TOL of the same layer
    with the plain scan on fp32-upcast operands, and the whole 48-layer
    prefill in fp32 within MAMBA_FP32_TOL of its plain twin's logits."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models.model import make_model
    cfg, _, params, adapters, batch = rig
    ref = make_model(cfg, remat=False, scan_backend="ref")
    runtime.reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = ref.prefill(params, adapters, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = dict(runtime.LAUNCHES), dict(runtime.PLAIN_CALLS)
    bf16_err, bf16_scale = _logit_err(kernel_logits, logits, 1.0)
    with torch.inference_mode():
        layers, layers_bf16 = _layer_walk(rig)
        cfg32, m32, p32, _, _ = rig32
        ref32 = make_model(cfg32, remat=False, scan_backend="ref")
        k32, _ = m32.prefill(p32, adapters, batch)
        r32, _ = ref32.prefill(p32, adapters, batch)
    err32, tol32 = _logit_err(k32, r32, MAMBA_FP32_TOL)
    worst = max(layers, key=lambda e: e[0] / e[1])
    emit({"phase": "mamba_plain", "prefill_ms": secs * 1e3,
          "launches": {k: v for k, v in launches.items() if v},
          "plain_calls": {k: v for k, v in plain.items() if v},
          "bf16_logits_max_abs_err": bf16_err,
          "bf16_logits_max_abs": bf16_scale,
          "bf16_argmax_agree": float((kernel_logits.argmax(-1)
                                      == logits.argmax(-1)).float().mean()),
          "layer_worst_err": worst[0], "layer_tol": worst[1],
          "layer_rel_err": [e / t * MAMBA_BF16_TOL for e, t in layers],
          "layer_rel_err_bf16_plain": [e / t for e, t in layers_bf16],
          "fp32_logits_max_abs_err": err32, "fp32_tol": tol32})
    if any(launches.values()) or plain["ssd_scan"] != cfg.n_layers:
        raise AssertionError(f"mamba_plain: launches {launches}, plain "
                             f"{plain}")
    if not all(e <= t for e, t in layers):
        raise AssertionError(f"mamba_plain: a bf16 layer's kernel and plain "
                             f"outputs disagree: {worst}")
    if not err32 <= tol32:
        raise AssertionError(f"mamba_plain: fp32 kernel and plain prefill "
                             f"disagree ({err32} > {tol32})")


def _consistency(model, params, adapters, batch, pre, tol):
    """Prefill ``pre`` tokens of ``batch`` (with a front-end's inputs) into
    caches of as many slots as it has tokens (with a VLM's prefix; an
    attention layer's, a mamba layer has none), decode the rest, and hold
    each position's logits against forward(mode="full") over ``batch``."""
    tokens = batch["tokens"]
    npf = model.n_prefix
    errs = []
    full, _ = model.forward(params, adapters, batch)
    last, caches = model.prefill(params, adapters,
                                 _as_batch(batch, s=pre),
                                 capacity=tokens.shape[1] + npf)
    errs.append(_logit_err(last, full[:, pre - 1], tol))
    for t in range(pre, tokens.shape[1]):
        logits, caches = model.decode_step(params, adapters, caches,
                                           tokens[:, t], t + npf)
        errs.append(_logit_err(logits, full[:, t], tol))
    return errs


def phase_mamba_consistency(rig, rig32):
    """The serve invariant at full width and depth: prefill P tokens,
    decode k, and each position's logits match forward(mode="full") over
    P + k (whose chunks are another length: Q 130 for 520 tokens, 256 for
    512).  Checked in fp32 within MAMBA_FP32_TOL; the bf16 run's distance
    is recorded (see MAMBA_BF16_TOL)."""
    import torch
    from repro_torch.kernels import runtime
    cfg, model, params, adapters, batch = rig
    b, pre, k = (MAMBA_CONSISTENCY[key] for key in
                 ("batch", "prompt_len", "decode"))
    seq = _as_batch(batch, b, pre + k)
    _, m32, p32, _, _ = rig32
    runtime.reset_counts()
    with torch.inference_mode():
        errs = _consistency(m32, p32, adapters, seq, pre, MAMBA_FP32_TOL)
        bf16 = _consistency(model, params, adapters, seq, pre, 1.0)
    torch.cuda.synchronize()
    launches = runtime.LAUNCHES["ssd_scan"]
    emit({"phase": "mamba_consistency", **MAMBA_CONSISTENCY,
          "fp32_max_abs_err": [e for e, _ in errs],
          "fp32_tol": [t for _, t in errs],
          "bf16_max_abs_err": [e for e, _ in bf16],
          "bf16_max_abs": [t for _, t in bf16], "launches": launches,
          "plain_calls": runtime.PLAIN_CALLS["ssd_scan"]})
    if launches != 4 * cfg.n_layers or runtime.PLAIN_CALLS["ssd_scan"]:
        raise AssertionError(f"mamba_consistency: {launches} launches")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"mamba_consistency: decode diverges from the "
                             f"full forward: {errs}")


# --------------------------------------------------------------- attention --
#: h2o-danube-3-4b's serving path as chip_smoke drives it: the full config
#: (24 layers, d_model 3840, 32 query and 8 KV heads x 120, d_ff 10240,
#: vocab 32000, SWA window 4096 on every layer, bf16), batch 4, a
#: 2048-token prompt, 16 new tokens, adapters at rank 8 of r_max 64
ATTN_CFG = dict(arch="h2o-danube-3-4b", batch=4, prompt_len=2048, new=16,
                rank=8, r_max=64)
#: Model.loss once on the card, in bf16
ATTN_LOSS = dict(batch=1, seq=512)
#: the serve invariant at full width and depth, in fp32
ATTN_CONSISTENCY = dict(batch=1, prompt_len=512, decode=8)
#: prefill + decode against the full forward in fp32: mamba_consistency's
#: tolerance, 2e-3 of max|want|
ATTN_FP32_TOL = 2e-3
#: (arch, SWA window override or None, prefill, decode steps): each at full
#: width in fp32, its depth cut to one repeat of its unit; h2o-danube with
#: a 256-token window wraps its ring inside the window (320 prefilled, 64
#: decoded); yi-34b's bf16 weights alone are about 69 GB at full depth
ATTN_ZOO = (("h2o-danube-3-4b", 256, 320, 64), ("yi-34b", None, 256, 8),
            ("chatglm3-6b", None, 256, 8), ("gemma2-9b", None, 256, 8))


def _attn_rig(dtype=None):
    """h2o-danube-3-4b at full width and depth on the card (ATTN_CFG,
    :func:`_lm_rig`)."""
    from repro_torch.configs import get_config
    return _lm_rig(get_config(ATTN_CFG["arch"]), ATTN_CFG, dtype)


def _param_count(tree) -> tuple[int, int]:
    """(elements, bytes) of every leaf of ``tree``."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def _device_split(fn) -> dict:
    """One call of ``fn`` on the device (``torch.profiler``): its kernels'
    launches and ms in all, by kind (GEMMs, the softmax, the rest), and
    the five longest kernels by name."""
    kernels = _device_kernels(fn, calls=1)

    def kind(name):
        low = name.lower()
        if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90",
                                  "nvjet")):
            return "gemm"
        return "softmax" if "softmax" in low else "other"
    split = {}
    for name, (n, ms) in kernels.items():
        agg = split.setdefault(kind(name), [0.0, 0.0])
        agg[0] += n
        agg[1] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return {"launches": sum(n for n, _ in kernels.values()),
            "ms": sum(ms for _, ms in kernels.values()), "by_kind": split,
            "top": {name: v for name, v in top}}


def _serve_run(rig, spec) -> dict:
    """repro_torch.launch.serve's ``generate`` after a warm-up: prefill
    ``spec``'s prompt into caches of prompt + new slots, then new - 1
    greedy steps; the counts start at 0 after the warm-up."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import generate
    cfg, model, params, adapters, batch = rig
    generate(model, params, adapters, _as_batch(batch, s=256), 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    res = generate(model, params, adapters, batch, spec["new"])
    res["peak"] = torch.cuda.max_memory_allocated()
    res["launches"] = {k: v for k, v in runtime.LAUNCHES.items() if v}
    res["plain_calls"] = {k: v for k, v in runtime.PLAIN_CALLS.items() if v}
    res["finite"] = bool(torch.isfinite(res["prefill_logits"].float()).all()
                         and torch.isfinite(res["logits"].float()).all())
    res["in_vocab"] = bool(((res["tokens"] >= 0)
                            & (res["tokens"] < cfg.vocab_size)).all())
    steps = spec["new"] - 1
    res["line"] = {"prefill_ms": res["prefill_s"] * 1e3,
                   "decode_steps": steps,
                   "decode_ms_per_step": res["decode_s"] * 1e3 / steps,
                   "decode_tok_per_s": steps * spec["batch"]
                   / res["decode_s"], "peak_device_bytes": res["peak"],
                   "finite": res["finite"], "tokens_in_vocab":
                   res["in_vocab"], "tokens": res["tokens"][0].tolist()}
    if not (res["finite"] and res["in_vocab"]) or res["tokens"].shape != (
            spec["batch"], spec["new"]):
        raise AssertionError(f"{cfg.name}: logits not finite or tokens "
                             "misshapen or outside the vocab")
    return res


def _loss_and_grad(rig, b, s, calls: int = 2) -> dict:
    """Model.loss over ``tokens[:b, :s]`` and its gradient with respect to
    every adapter factor, ``calls`` times (the first meets autograd's first
    use); the loss, each call's ms and whether the gradient is finite."""
    import torch
    from repro_torch.lora import attach_ranks, strip_ranks
    from repro_torch.tree import tree_leaves, tree_map
    cfg, model, params, adapters, batch = rig
    factors, ranks = strip_ranks(adapters)
    factors = tree_map(lambda t: t.detach().requires_grad_(True), factors)
    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(params, attach_ranks(factors, ranks),
                          _as_batch(batch, b, s))
        grads = torch.autograd.grad(loss, tree_leaves(factors))
        loss = float(loss.detach())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
    del grads, factors
    if not (math.isfinite(loss) and finite):
        raise AssertionError(f"{cfg.name}: Model.loss {loss} or its "
                             "gradient is not finite")
    return {"loss": loss, "loss_and_grad_ms": ms, "loss_shape": [b, s],
            "grads_finite": finite}


def _lm_main(phase, rig, spec, loss_spec, smi, **extra) -> dict:
    """repro_torch.launch.serve's path at full width: one prefill into KV
    caches of prompt + new slots and new - 1 greedy decode steps, the
    device split of a prefill and of a decode step, then Model.loss (in
    the weights' dtype) and its gradient with respect to the adapters.
    No kernel and no plain twin lies on the attention, MLP or MoE path:
    every count stays 0 from generate's start to the end."""
    import torch
    from repro_torch.kernels import runtime
    cfg, model, params, adapters, batch = rig
    capacity = batch["tokens"].shape[1] + spec["new"] + model.n_prefix
    res = _serve_run(rig, spec)
    # where the device time goes: one prefill and one decode step
    with torch.inference_mode():
        prefill_dev = _device_split(lambda: model.prefill(
            params, adapters, batch, capacity=capacity))
        step_pos = capacity - 2
        decode_dev = _device_split(lambda: model.decode_step(
            params, adapters, res["caches"], res["tokens"][:, -1],
            step_pos))
    loss = _loss_and_grad(rig, loss_spec["batch"], loss_spec["seq"])
    launches = sum(runtime.LAUNCHES.values())
    plain = sum(runtime.PLAIN_CALLS.values())
    n_params, param_bytes = _param_count(params)
    line = {"phase": phase, "config": spec, "card": smi,
            "layers": cfg.n_layers, "d_model": cfg.d_model, **extra,
            **res["line"], "params": n_params, "param_bytes": param_bytes,
            "kv_cache_shape": list(res["caches"][0]["b0"]["k"].shape),
            "prefill_device": prefill_dev, "decode_step_device": decode_dev,
            **loss, "launches": launches, "plain_calls": plain}
    emit(line)
    if launches or plain:
        raise AssertionError(f"{phase}: a kernel or plain twin ran on the "
                             f"path: {dict(runtime.LAUNCHES)} "
                             f"{dict(runtime.PLAIN_CALLS)}")
    return line


def phase_attn_main(rig, smi: str) -> dict:
    """:func:`_lm_main` for h2o-danube-3-4b at full width and depth
    (ATTN_CFG, ATTN_LOSS), its KV caches checked."""
    cfg = rig[0]
    line = _lm_main("attn_main", rig, ATTN_CFG, ATTN_LOSS, smi,
                    window=cfg.stages[0].unit[0].window)
    if line["kv_cache_shape"] != [cfg.n_layers, ATTN_CFG["batch"],
                                  ATTN_CFG["prompt_len"] + ATTN_CFG["new"],
                                  cfg.n_kv_heads, cfg.head_dim]:
        raise AssertionError(f"attn_main: KV cache {line['kv_cache_shape']}")
    return line


def phase_attn_consistency(rig, rig32):
    """The serve invariant at full width and depth: prefill P tokens into
    caches of P + k slots, decode k, and each position's logits match
    forward(mode="full") over P + k, in fp32 (the bf16 weights upcast)
    within ATTN_FP32_TOL with TF32 off; the bf16 run's distance is
    recorded."""
    import torch
    from repro_torch.kernels import runtime
    cfg, model, params, adapters, batch = rig
    b, pre, k = (ATTN_CONSISTENCY[key] for key in
                 ("batch", "prompt_len", "decode"))
    seq = _as_batch(batch, b, pre + k)
    _, m32, p32, _, _ = rig32
    runtime.full_fp32()
    runtime.reset_counts()
    with torch.inference_mode():
        errs = _consistency(m32, p32, adapters, seq, pre, ATTN_FP32_TOL)
        bf16 = _consistency(model, params, adapters, seq, pre, 1.0)
    torch.cuda.synchronize()
    launches = sum(runtime.LAUNCHES.values())
    plain = sum(runtime.PLAIN_CALLS.values())
    emit({"phase": "attn_consistency", "arch": cfg.name,
          "layers": cfg.n_layers, **ATTN_CONSISTENCY,
          "fp32_max_abs_err": [e for e, _ in errs],
          "fp32_tol": [t for _, t in errs],
          "bf16_max_abs_err": [e for e, _ in bf16],
          "bf16_max_abs": [t for _, t in bf16], "launches": launches,
          "plain_calls": plain})
    if launches or plain:
        raise AssertionError(f"attn_consistency: {launches} launches, "
                             f"{plain} plain calls")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"attn_consistency: decode diverges from the "
                             f"full forward: {errs}")


def _zoo_config(arch, window):
    """``arch`` at full width in fp32, its depth cut to one repeat of its
    unit (and its SWA windows set to ``window`` where given); returns the
    config and what was cut."""
    import dataclasses
    from repro_torch.configs import Stage, get_config
    cfg = get_config(arch)
    cut = [f"depth {cfg.n_layers} -> {sum(len(s.unit) for s in cfg.stages)} "
           f"layers (one repeat of the unit)"]
    stages = []
    for st in cfg.stages:
        unit = st.unit
        if window is not None:
            unit = tuple(dataclasses.replace(b, window=window) if b.window
                         else b for b in unit)
            cut.append(f"SWA window {st.unit[0].window} -> {window}")
        stages.append(Stage(unit=unit, repeat=1))
    cut.append("dtype bfloat16 -> float32")
    return dataclasses.replace(cfg, stages=tuple(stages),
                               dtype="float32"), cut


def phase_attn_zoo() -> list:
    """Each ATTN_ZOO arch at full width in fp32 with one repeat of its
    unit: prefill, then decode, each position against the full forward
    within ATTN_FP32_TOL (TF32 off), no kernel and no plain twin."""
    import torch
    from repro_torch.kernels import runtime
    runtime.full_fp32()
    lines = []
    for arch, window, pre, k in ATTN_ZOO:
        cfg, cut = _zoo_config(arch, window)
        spec = dict(batch=1, prompt_len=pre + k, rank=8, r_max=64)
        _, model, params, adapters, batch = _lm_rig(cfg, spec)
        runtime.reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            errs = _consistency(model, params, adapters, batch, pre,
                                ATTN_FP32_TOL)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = sum(runtime.LAUNCHES.values())
        plain = sum(runtime.PLAIN_CALLS.values())
        worst = max(errs, key=lambda e: e[0] / e[1])
        blocks = [dict(window=b.window) for b in cfg.stages[0].unit]
        line = {"phase": "attn_zoo", "arch": arch, "cut": cut,
                "layers": cfg.n_layers, "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                "vocab": cfg.vocab_size, "blocks": blocks,
                "rope_kind": cfg.rope_kind, "qkv_bias": cfg.qkv_bias,
                "softcaps": [cfg.attn_softcap, cfg.final_softcap],
                "post_block_norm": cfg.post_block_norm,
                "mlp_act": cfg.mlp_act, "tied": cfg.tie_embeddings,
                "prefill": pre, "decode": k,
                "params": _param_count(params)[0],
                "worst_err": worst[0], "worst_tol": worst[1],
                "rel_err": [e / t * ATTN_FP32_TOL for e, t in errs],
                "seconds": secs, "launches": launches, "plain_calls": plain}
        emit(line)
        lines.append(line)
        del model, params, adapters, batch
        torch.cuda.empty_cache()
        if launches or plain:
            raise AssertionError(f"attn_zoo {arch}: {launches} launches, "
                                 f"{plain} plain calls")
        if not all(e <= t for e, t in errs):
            raise AssertionError(f"attn_zoo {arch}: decode diverges from the "
                                 f"full forward: {worst}")
    return lines


# --------------------------------------------------------------------- MoE --
#: granite-moe-3b-a800m's serving path as chip_smoke drives it: the full
#: config (32 layers, d_model 1536, 24 query and 8 KV heads x 64, 40
#: experts top-8 of width 512 on every layer, vocab 49155, tied
#: embeddings, bf16), batch 4, a 2048-token prompt, 16 new tokens, adapters
#: at rank 8 of r_max 64; nothing cut
MOE_CFG = dict(arch="granite-moe-3b-a800m", batch=4, prompt_len=2048, new=16,
               rank=8, r_max=64)
#: Model.loss once on the card, in bf16
MOE_LOSS = dict(batch=1, seq=512)
#: the serve invariant at full width and depth, in fp32
MOE_CONSISTENCY = dict(batch=1, prompt_len=512, decode=8)
#: prefill + decode against the full forward in fp32, as attn_consistency
MOE_FP32_TOL = 2e-3
#: the expert-adapter rbla round: four clients' granite expert pairs at full
#: depth (leading (32, 40)), at these ranks of r_max 64, weighted 1..4
MOE_ROUND_RANKS = (8, 16, 32, 64)
#: jamba-1.5-large-398b at full width, cut to one unit of three blocks
#: (mamba + dense, mamba + MoE, gqa + dense): prefill and decode in bf16,
#: then the serve invariant in fp32 (check_pre + check_decode)
JAMBA_ZOO = dict(arch="jamba-1.5-large-398b", batch=2, prompt_len=1024,
                 new=8, rank=8, r_max=64, check_pre=256, check_decode=8)
#: deepseek-v3-671b at full width, cut to its two stages' first layers (MLA
#: + dense, MLA + MoE of 256 experts) and the MTP block: prefill, decode
#: and Model.loss (with its MTP term) in bf16; then with 32 routed experts
#: in fp32 the serve invariant and the absorbed decode against the naive
DEEPSEEK_ZOO = dict(arch="deepseek-v3-671b", batch=1, prompt_len=512, new=8,
                    loss_seq=256, rank=8, r_max=64, check_pre=256,
                    check_decode=8, fp32_experts=32)
#: the reference's absorbed-against-naive tolerance
ABSORBED_TOL = 2e-2
#: moe_ep: one granite MoE layer at full width in fp32 over batch x seq
#: tokens
MOE_EP = dict(batch=4, seq=512)
MOE_EP_TOL = 2e-5


def _no_drop(cfg):
    """``cfg`` at a capacity factor where no token drops (an expert takes
    at most one slot a token, so E / k makes cap >= the group's tokens),
    and the cut that says so."""
    import dataclasses
    e = cfg.n_experts + cfg.moe_pad_experts
    cf = e / cfg.experts_per_token
    return (dataclasses.replace(cfg, capacity_factor=cf),
            f"capacity_factor {cfg.capacity_factor} -> {cf} (no token "
            "drops, so decode and the full forward route alike)")


def _to_fp32_in_place(tree) -> None:
    """Every floating leaf of ``tree``'s dicts in fp32, replaced leaf by
    leaf so that each bf16 leaf is freed as its fp32 copy is made."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list, tuple)):
            _to_fp32_in_place(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def _moe_rig(dtype=None):
    """granite-moe-3b-a800m at full width and depth on the card (MOE_CFG,
    :func:`_lm_rig`)."""
    from repro_torch.configs import get_config
    return _lm_rig(get_config(MOE_CFG["arch"]), MOE_CFG, dtype)


def phase_moe_main(rig, smi: str) -> dict:
    """:func:`_lm_main` for granite-moe-3b-a800m at full width and depth
    (MOE_CFG, MOE_LOSS), with the dispatch tensor's shape in a prefill and
    a decode step."""
    from repro_torch.models.moe import dispatch_shape
    cfg = rig[0]
    return _lm_main(
        "moe_main", rig, MOE_CFG, MOE_LOSS, smi,
        experts=[cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff],
        capacity_factor=cfg.capacity_factor,
        dispatch_shape=list(dispatch_shape(
            cfg, MOE_CFG["batch"] * MOE_CFG["prompt_len"])),
        decode_dispatch_shape=list(dispatch_shape(cfg, MOE_CFG["batch"])))


def _moe_expert_round(cfg, smi: str) -> dict:
    """The paper's aggregation over the new family's expert pairs: four
    clients' granite expert adapters at full depth (leading (32, 40)) at
    MOE_ROUND_RANKS through :func:`_rbla_round`."""
    import torch
    from repro_torch.lora import mask_pair
    from repro_torch.models.model import make_model
    model = make_model(cfg, remat=False)
    clients = []
    for i, r in enumerate(MOE_ROUND_RANKS):
        gen = torch.Generator(device="cuda").manual_seed(40 + i)
        full = model.init_adapters(gen, r_max=64, rank=r)
        clients.append({"stages": tuple(
            {b: {path: mask_pair(dict(pair, B=torch.randn(
                pair["B"].shape, generator=gen, device="cuda") * 0.02))
                for path, pair in unit.items()
                if path.startswith("ffn/experts/")}
             for b, unit in stage.items()} for stage in full["stages"])})
        del full
    return _rbla_round("moe_round", clients, MOE_ROUND_RANKS, smi,
                       pairs="ffn/experts/*", leading=list(
                           clients[0]["stages"][0]["b0"]["ffn/experts/gate"]
                           ["A"].shape[:2]))


def _rbla_round(phase, clients, ranks, smi: str, **extra) -> dict:
    """``clients``' adapter trees (at ``ranks`` of r_max 64, weighted 1..n)
    through ``aggregate_adapters(method="rbla")`` on the card -- one
    packed_agg launch, enforced -- held against the plain round on the
    same inputs within 2e-5 of max|want|; the kernel round's and the plain
    round's ms and the HBM bound of the live rows, the weights and the
    output.  Frees the clients."""
    import torch
    from repro_torch.core import plan, strategy
    from repro_torch.kernels import runtime
    w = torch.arange(1.0, len(clients) + 1, device="cuda")
    # a copy: its cached plans go with it, not with the shared registry's
    strat = strategy.get_strategy("rbla").with_options()
    runtime.reset_counts()
    got = strat.aggregate_adapters(clients, w, r_max=64, backend="auto")
    torch.cuda.synchronize()
    launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
    plain = {k: v for k, v in runtime.PLAIN_CALLS.items() if v}
    stacked = strategy.stack_trees(clients)
    client_ranks = torch.tensor(ranks, dtype=torch.int32, device="cuda")
    rounds = {kind: strat.plan(None, plan.build_cohort_spec(
        stacked, kind=kind, r_max=64, client_ranks=client_ranks))
        for kind in ("kernel", "ref")}
    want = rounds["ref"](stacked, w, None)
    err, scale = _rel_err(got, want)
    client_bytes = _live_pair_bytes(clients, ranks, 64)
    # the global's rank is the largest client's, r_max: every row written
    out_bytes = sum(t.numel() * t.element_size()
                    for t in _float_leaves(got))
    bytes_moved = client_bytes + out_bytes + w.numel() * w.element_size()
    ms = time_ms(lambda: rounds["kernel"](stacked, w, None), reps=10)
    plain_ms = time_ms(lambda: rounds["ref"](stacked, w, None), reps=5)
    bound_ms, bound_by = bound(bytes_moved, 0.0)
    row = {"phase": phase, "card": smi, "clients": len(clients),
           "ranks": list(ranks), **extra, "launches": launches,
           "plain_calls": plain, "max_abs_err": err,
           "tol": 2e-5 * max(scale, 1.0), "ms": ms, "plain_ms": plain_ms,
           "bytes": bytes_moved, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    clients.clear()
    del stacked, got, want, rounds, strat
    torch.cuda.empty_cache()
    if launches != {"packed_agg": 1} or plain:
        raise AssertionError(f"{phase}: launches {launches}, plain "
                             f"{plain}: one packed_agg launch expected")
    if not err <= 2e-5 * max(scale, 1.0):
        raise AssertionError(f"{phase}: the kernel round disagrees with "
                             f"the plain round ({err})")
    return row


def _live_pair_bytes(clients, ranks, r_max) -> int:
    """Bytes of the clients' pairs that a round must read: each client's
    live A rows and B columns (rank / r_max of each factor; the rest are
    zero, and the plan is built with the client ranks) and its rank
    leaves."""
    from repro_torch.lora import tree_map_pairs
    total = 0

    def count(pair, r):
        nonlocal total
        total += sum(pair[f].numel() * pair[f].element_size()
                     for f in ("A", "B")) * r // r_max
        total += pair["rank"].numel() * pair["rank"].element_size()
        return pair
    for c, r in zip(clients, ranks):
        tree_map_pairs(lambda pair, r=r: count(pair, r), c)
    return total


def _float_leaves(tree) -> list:
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(tree) if t.is_floating_point()]


def phase_moe_consistency(rig) -> dict:
    """The serve invariant at full width and depth for granite: the bf16
    weights upcast to fp32 in place, the capacity factor raised so that no
    token drops (:func:`_no_drop`); prefill 512 tokens into caches of 520
    slots, decode 8, each position's logits against forward(mode="full")
    over 520 within MOE_FP32_TOL, TF32 off; no kernel and no plain twin."""
    import dataclasses
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models.model import make_model
    cfg, _, params, adapters, batch = rig
    _to_fp32_in_place(params)
    cfg32, cut = _no_drop(dataclasses.replace(cfg, dtype="float32"))
    model = make_model(cfg32, remat=False)
    b, pre, k = (MOE_CONSISTENCY[key] for key in
                 ("batch", "prompt_len", "decode"))
    runtime.full_fp32()
    runtime.reset_counts()
    with torch.inference_mode():
        errs = _consistency(model, params, adapters,
                            _as_batch(batch, b, pre + k), pre, MOE_FP32_TOL)
    torch.cuda.synchronize()
    launches = sum(runtime.LAUNCHES.values())
    plain = sum(runtime.PLAIN_CALLS.values())
    line = {"phase": "moe_consistency", "arch": cfg.name,
            "layers": cfg.n_layers, **MOE_CONSISTENCY, "cut": [cut],
            "fp32_max_abs_err": [e for e, _ in errs],
            "fp32_tol": [t for _, t in errs],
            "rel_err": [e / t * MOE_FP32_TOL for e, t in errs],
            "launches": launches, "plain_calls": plain}
    emit(line)
    if launches or plain:
        raise AssertionError(f"moe_consistency: {launches} launches, "
                             f"{plain} plain calls")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"moe_consistency: decode diverges from the "
                             f"full forward: {errs}")
    return line


def _moe_zoo_config(arch, **over):
    """``arch`` at full width with its depth cut as moe_zoo cuts it; returns
    the config and what was cut."""
    import dataclasses
    from repro_torch.configs import BlockSpec, Stage, get_config
    cfg = get_config(arch)
    if arch == JAMBA_ZOO["arch"]:
        unit = (BlockSpec(kind="mamba", ffn="dense"),
                BlockSpec(kind="mamba", ffn="moe"),
                BlockSpec(kind="gqa", ffn="dense"))
        stages = (Stage(unit=unit, repeat=1),)
        cut = [f"depth {cfg.n_layers} -> 3 layers: one unit of three blocks "
               "(mamba + dense, mamba + MoE, gqa + dense) of the 8-block "
               "unit"]
    else:
        stages = tuple(Stage(unit=s.unit, repeat=1) for s in cfg.stages)
        cut = [f"depth {cfg.n_layers} -> 2 layers (one of each stage: MLA + "
               "dense, MLA + MoE) + the MTP block"]
    cfg = dataclasses.replace(cfg, stages=stages, **over)
    for k, v in over.items():
        cut.append(f"{k} -> {v}")
    return cfg, cut


def _zoo_line(arch, cfg, cut, params, **extra) -> dict:
    return {"phase": "moe_zoo", "arch": arch, "cut": cut,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "blocks": [[b.kind, b.ffn] for s in cfg.stages for b in s.unit],
            "experts": [cfg.n_experts, cfg.n_shared_experts,
                        cfg.experts_per_token, cfg.moe_d_ff],
            "dtype": cfg.dtype, "params": _param_count(params)[0], **extra}


def _jamba_mixer_walk(cfg, params, adapters, tokens, tol) -> list:
    """jamba's unit block by block over the prompt from the kernel path's
    residual stream: each mamba mixer with the kernel and with the plain
    scan on fp32-upcast operands, the same layer's operands to both (the
    scan at the shape the prefill gives it); returns each mamba layer's
    (error, tolerance) at ``tol`` of max|plain|.  The walk stops at the
    last mamba mixer."""
    from repro_torch.models.common import embed
    from repro_torch.models.mamba import mamba_forward
    from repro_torch.models.transformer import block_forward
    from repro_torch.tree import tree_map
    unit = cfg.stages[0].unit
    last = max(i for i, b in enumerate(unit) if b.kind == "mamba")
    bp = tree_map(lambda t: t[0], params["stages"][0])
    pairs = tree_map(lambda t: t[0], adapters["stages"][0])
    x = embed(params["embed"], tokens)
    errs = []
    for i, spec in enumerate(unit[:last + 1]):
        flat = pairs.get(f"b{i}", {})
        bl = {part: {k.split("/", 1)[1]: v for k, v in flat.items()
                     if k.startswith(part + "/")} or None
              for part in ("mix", "ffn")}
        if spec.kind == "mamba":
            def mixer(backend, **plain):
                return mamba_forward(bp[f"b{i}"]["mix"], bl["mix"], x, cfg,
                                     mode="full", scan_backend=backend,
                                     **plain)[0]
            errs.append(_logit_err(
                mixer("auto"), mixer("ref", plain_scan=_plain_scan_in_fp32),
                tol))
        if i < last:
            x, _ = block_forward(bp[f"b{i}"], bl, x, cfg, spec, mode="full")
    return errs


def phase_moe_zoo(smi: str) -> list:
    """jamba and deepseek at full width (JAMBA_ZOO, DEEPSEEK_ZOO): jamba's
    bf16 prefill launches ssd_scan once a mamba layer, and each mamba
    mixer's kernel scan is held against the plain scan on the same
    operands (bf16 and fp32), then its fp32 serve invariant; deepseek's bf16 prefill, decode and Model.loss with the MTP
    term, then with 32 routed experts in fp32 the serve invariant and the
    absorbed decode against the naive decode."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models.model import make_model
    runtime.full_fp32()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe_zoo", "allocated_gb_at_start":
          torch.cuda.memory_allocated() / 1e9})
    lines = []
    # ---- jamba: bf16 serve, then the same weights in fp32
    spec = JAMBA_ZOO
    cfg, cut = _moe_zoo_config(spec["arch"])
    rig = _lm_rig(cfg, spec)
    res = _serve_run(rig, spec)
    n_mamba = sum(b.kind == "mamba" for s in cfg.stages for b in s.unit)
    line = _zoo_line(spec["arch"], cfg, cut, rig[2], card=smi,
                     config={k: spec[k] for k in ("batch", "prompt_len",
                                                  "new")},
                     **res["line"], launches=res["launches"],
                     plain_calls=res["plain_calls"])
    emit(line)
    lines.append(line)
    if res["launches"] != {"ssd_scan": n_mamba} or res["plain_calls"]:
        raise AssertionError(f"moe_zoo jamba: launches {res['launches']}, "
                             f"plain {res['plain_calls']}: one ssd_scan a "
                             "mamba layer expected in the prefill")
    del res
    _, _, params, adapters, batch = rig
    del rig
    cfg32, drop_cut = _no_drop(dataclasses.replace(cfg, dtype="float32"))
    walk = {}
    for dtype, tol in (("bfloat16", MAMBA_BF16_TOL),
                       ("float32", MAMBA_FP32_TOL)):
        if dtype == "float32":
            _to_fp32_in_place(params)
        with torch.inference_mode():
            walk[dtype] = _jamba_mixer_walk(
                cfg32 if dtype == "float32" else cfg, params, adapters,
                batch["tokens"], tol)
    line = {"phase": "moe_zoo", "arch": spec["arch"], "card": smi,
            "check": "ssd_scan against the plain scan, each mamba mixer",
            "scan_shape": [spec["batch"], spec["prompt_len"],
                           cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
                           cfg.ssm_head_dim, cfg.ssm_state],
            **{f"{d}_rel_err": [e / t * tol for e, t in errs]
               for (d, errs), tol in zip(walk.items(), (MAMBA_BF16_TOL,
                                                        MAMBA_FP32_TOL))}}
    emit(line)
    lines.append(line)
    if not all(e <= t for errs in walk.values() for e, t in errs) or \
            [len(errs) for errs in walk.values()] != [n_mamba, n_mamba]:
        raise AssertionError(f"moe_zoo jamba: a mamba mixer's kernel scan "
                             f"disagrees with the plain scan: {walk}")
    pre, k = spec["check_pre"], spec["check_decode"]
    runtime.reset_counts()
    with torch.inference_mode():
        errs = _consistency(make_model(cfg32, remat=False), params,
                            adapters, _as_batch(batch, 1, pre + k), pre,
                            MOE_FP32_TOL)
    torch.cuda.synchronize()
    launches = {k_: v for k_, v in runtime.LAUNCHES.items() if v}
    line = _zoo_line(spec["arch"], cfg32, cut + [drop_cut,
                                                 "dtype bfloat16 -> float32"],
                     params, check="serve invariant", prefill=pre,
                     decode=k, rel_err=[e / t * MOE_FP32_TOL
                                        for e, t in errs],
                     worst_err=max(errs, key=lambda e: e[0] / e[1]),
                     launches=launches)
    emit(line)
    lines.append(line)
    del params, adapters, batch
    torch.cuda.empty_cache()
    # the full forward's and the prefill's mamba layers, none in decode
    if launches != {"ssd_scan": 2 * n_mamba}:
        raise AssertionError(f"moe_zoo jamba fp32: launches {launches}")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"moe_zoo jamba: decode diverges from the full "
                             f"forward: {errs}")
    # ---- deepseek: bf16 serve and loss with MTP, 256 experts
    spec = DEEPSEEK_ZOO
    cfg, cut = _moe_zoo_config(spec["arch"])
    rig = _lm_rig(cfg, spec)
    res = _serve_run(rig, spec)
    loss = _loss_and_grad(rig, 1, spec["loss_seq"])
    launches = sum(runtime.LAUNCHES.values()) + sum(
        runtime.PLAIN_CALLS.values())
    line = _zoo_line(spec["arch"], cfg, cut, rig[2], card=smi,
                     config={k: spec[k] for k in ("batch", "prompt_len",
                                                  "new")},
                     mtp_depth=cfg.mtp_depth, **res["line"], **loss,
                     launches=launches)
    emit(line)
    lines.append(line)
    del res, rig
    torch.cuda.empty_cache()
    if launches:
        raise AssertionError(f"moe_zoo deepseek: {launches} launches")
    # ---- deepseek in fp32 with 32 routed experts
    cfg, cut = _moe_zoo_config(spec["arch"], dtype="float32",
                               n_experts=spec["fp32_experts"])
    cfg, drop_cut = _no_drop(cfg)
    rig = _lm_rig(cfg, spec)
    _, model, params, adapters, batch = rig
    pre, k = spec["check_pre"], spec["check_decode"]
    seq = batch["tokens"][:1, :pre + k]
    absorbed = make_model(cfg, remat=False, mla_absorbed=True)
    # the absorbed form folds kv_b's weight and skips its adapter, as the
    # reference: both decodes run without that one pair
    no_kv_b = {"stages": tuple(
        {b: {path: pair for path, pair in unit.items()
             if path != "mix/kv_b"} for b, unit in stage.items()}
        for stage in adapters["stages"])}
    runtime.reset_counts()
    with torch.inference_mode():
        errs = _consistency(model, params, adapters, {"tokens": seq}, pre,
                            MOE_FP32_TOL)
        _, caches = model.prefill(params, no_kv_b, {"tokens": seq[:, :pre]},
                                  capacity=pre + k)
        abs_caches = caches
        abs_errs = []
        for t in range(pre, pre + k):
            naive, caches = model.decode_step(params, no_kv_b, caches,
                                              seq[:, t], t)
            got, abs_caches = absorbed.decode_step(params, no_kv_b,
                                                   abs_caches, seq[:, t], t)
            abs_errs.append(_logit_err(got, naive, ABSORBED_TOL))
    torch.cuda.synchronize()
    launches = sum(runtime.LAUNCHES.values())
    line = _zoo_line(spec["arch"], cfg, cut + [drop_cut], params,
                     check="serve invariant, absorbed decode", prefill=pre,
                     decode=k, rel_err=[e / t * MOE_FP32_TOL
                                        for e, t in errs],
                     absorbed_rel_err=[e / t * ABSORBED_TOL
                                       for e, t in abs_errs],
                     launches=launches)
    emit(line)
    lines.append(line)
    del rig, model, params, adapters, no_kv_b, batch, caches, abs_caches
    torch.cuda.empty_cache()
    if launches:
        raise AssertionError(f"moe_zoo deepseek fp32: {launches} launches")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"moe_zoo deepseek: decode diverges from the "
                             f"full forward: {errs}")
    if not all(e <= t for e, t in abs_errs):
        raise AssertionError(f"moe_zoo deepseek: the absorbed decode "
                             f"diverges from the naive one: {abs_errs}")
    return lines


def _ep_inputs():
    """One granite MoE layer at full width in fp32 (seed 5) and MOE_EP's
    tokens (seed 6) on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_init
    cfg = dataclasses.replace(get_config(MOE_CFG["arch"]), dtype="float32")
    p = moe_init(torch.Generator(device="cuda").manual_seed(5), cfg)
    x = torch.randn((MOE_EP["batch"], MOE_EP["seq"], cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    return cfg, p, x


def _ep_rank(rank, world, store, data_path, out_path, src):
    """One rank of moe_ep's gloo world on cuda:0: the expert-parallel
    wrapper over the default model mesh, its result against the sort path
    with ``world`` groups saved beside the inputs, and a dispatch round's
    wall.  Writes its row as JSON to ``out_path``; raises on a
    disagreement."""
    sys.path.insert(0, src)
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models.moe_ep import moe_forward_ep_wrapped
    runtime.full_fp32()
    torch.cuda.set_device(0)
    data = torch.load(data_path, map_location="cuda:0")
    cfg = dataclasses.replace(get_config(MOE_CFG["arch"]), dtype="float32")
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        runtime.reset_counts()
        with torch.inference_mode():
            y = moe_forward_ep_wrapped(data["p"], None, data["x"], cfg)
        collectives = dict(runtime.COLLECTIVES)
        err = float((y - data["want"]).abs().max())
        tol = MOE_EP_TOL * max(1.0, float(data["want"].abs().max()))
        walls = []
        with torch.inference_mode():
            for _ in range(8):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                moe_forward_ep_wrapped(data["p"], None, data["x"], cfg)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    row = {"rank": rank, "world": world, "max_abs_err": err, "tol": tol,
           "collectives": collectives, "on_card": bool(y.is_cuda),
           "dispatch_round_wall_ms": statistics.median(walls[2:])}
    with open(out_path, "w") as f:
        json.dump(row, f)
    if not (err <= tol and y.is_cuda):
        raise AssertionError(f"moe_ep rank {rank}: {err} > {tol}")


def phase_moe_ep(smi: str) -> dict:
    """The expert-parallel MoE (``moe_mode="ep_a2a"``) on the card: under a
    one-rank NCCL group the wrapper equals the sort path with one group
    (the same group count) within MOE_EP_TOL of max|want| in fp32, with one
    all_to_all each way and one all_gather; a dispatch round's wall against
    the sort path's; then 2 gloo ranks on cuda:0 (spawned), each rank's
    tokens against the sort path with 2 groups."""
    import multiprocessing
    import tempfile
    import torch
    import torch.distributed as dist
    import repro_torch
    from repro_torch.kernels import runtime
    from repro_torch.models.moe import moe_forward
    from repro_torch.models.moe_ep import moe_forward_ep_wrapped
    runtime.full_fp32()
    cfg, p, x = _ep_inputs()
    with torch.inference_mode():
        want1 = moe_forward(p, None, x, cfg, n_groups=1)
        want2 = moe_forward(p, None, x, cfg, n_groups=2)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            runtime.reset_counts()
            with torch.inference_mode():
                got = moe_forward_ep_wrapped(p, None, x, cfg)
            torch.cuda.synchronize()
            collectives = dict(runtime.COLLECTIVES)
            err, tol = _logit_err(got, want1, MOE_EP_TOL)

            def ep():
                return moe_forward_ep_wrapped(p, None, x, cfg)

            def sort():
                return moe_forward(p, None, x, cfg, n_groups=1)
            with torch.inference_mode():
                ep_ms, sort_ms = time_ms(ep, reps=10), time_ms(sort, reps=10)
                ep_dev, _ = _device_events(ep)
        finally:
            dist.destroy_process_group()
        out = {"phase": "moe_ep", "leg": "one_rank_nccl", "card": smi,
               "tokens": list(x.shape[:2]), "experts": cfg.n_experts,
               "max_abs_err": err, "tol": tol, "collectives": collectives,
               "ep_ms": ep_ms, "sort_ms": sort_ms,
               "ep_device_kernels": sum(c for c, _ in ep_dev.values()),
               "nccl_device_ms": sum(m for k, (_, m) in ep_dev.items()
                                     if "nccl" in k.lower())}
        emit(out)
        if collectives != {"all_reduce": 0, "all_gather": 1,
                           "all_to_all": 2}:
            raise AssertionError(f"moe_ep: collectives {collectives}: one "
                                 "all_to_all each way and one all_gather "
                                 "expected")
        if not err <= tol:
            raise AssertionError(f"moe_ep: the expert-parallel path "
                                 f"disagrees with the sort path ({err})")
        # two gloo ranks on the one card
        data = str(Path(tmp) / "ep.pt")
        torch.save({"p": p, "x": x, "want": want2}, data)
        ctx = multiprocessing.get_context("spawn")
        outs = [str(Path(tmp) / f"ep{k}.json") for k in range(2)]
        procs = [ctx.Process(target=_ep_rank, args=(
            k, 2, str(Path(tmp) / "gloo_store"), data, outs[k],
            str(Path(repro_torch.__file__).resolve().parents[1])))
            for k in range(2)]
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(DIST_CHILD_TIMEOUT)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        ranks = []
        for k, proc in enumerate(procs):
            if proc.exitcode != 0:
                raise AssertionError(f"moe_ep: gloo rank {k} exited "
                                     f"{proc.exitcode}")
            with open(outs[k]) as f:
                ranks.append(json.load(f))
            emit({"phase": "moe_ep", "leg": "two_gloo_ranks", "card": smi,
                  **ranks[-1]})
    return {**out, "two_rank_wall_ms": [r["dispatch_round_wall_ms"]
                                        for r in ranks]}


# ---------------------------------------------- front-ends and training --
#: phi-3-vision-4.2b's serving path as chip_smoke drives it: the full config
#: (32 layers, d_model 3072, 32 heads x 96, d_ff 8192, vocab 32064, bf16),
#: 576 patches of width 1024 before a 2048-token prompt, batch 4, 16 new
#: tokens, adapters at rank 8 of r_max 64 (the projector's too); nothing cut
VLM_CFG = dict(arch="phi-3-vision-4.2b", batch=4, prompt_len=2048, new=16,
               rank=8, r_max=64)
#: Model.loss and its adapter gradient once on the card, in bf16, after the
#: 576 patches
VLM_LOSS = dict(batch=1, seq=512)
#: whisper-large-v3's: the full config (32 encoder and 32 decoder layers,
#: d_model 1280, 20 heads x 64, d_ff 5120, vocab 51866, bf16), 1500 frames
#: of width 1280, a 432-token prompt and 16 new tokens (448, whisper's text
#: context), batch 4; nothing cut
ENCDEC_CFG = dict(arch="whisper-large-v3", batch=4, prompt_len=432, new=16,
                  rank=8, r_max=64)
#: Model.loss and its adapter gradient at 1 x 1500 frames x 256 tokens
ENCDEC_LOSS = dict(batch=1, seq=256)
#: the serve invariant at full width and depth in fp32, the bf16 weights
#: upcast in place: (batch, prompt, decode steps) per arch
FRONTEND_CONSISTENCY = {
    "phi-3-vision-4.2b": dict(batch=1, prompt_len=512, decode=8),
    "whisper-large-v3": dict(batch=1, prompt_len=256, decode=8)}
#: prefill + decode against the full forward in fp32, as moe_consistency
FRONTEND_FP32_TOL = 2e-3
#: the front-end rbla round: four clients' whole whisper adapter trees
#: (``enc``, ``frontend``, ``stages``) at full depth, at these ranks of
#: r_max 64, weighted 1..4
FRONTEND_ROUND_RANKS = (8, 16, 32, 64)
#: repro_torch.launch.train's arguments for each run of train_main, a
#: temporary ``--ckpt`` added: h2o-danube-3-4b (the default arch), then
#: mamba2-1.3b, whose mamba layers train through the plain scan
TRAIN_RUNS = (("--preset", "full", "--steps", "20"),
              ("--arch", "mamba2-1.3b", "--preset", "full", "--steps", "3"))


def _frontend_rig(spec, dtype=None):
    """``spec``'s front-end arch at full width and depth on the card
    (:func:`_lm_rig`: its batch is the tokens and the frames or
    patches)."""
    from repro_torch.configs import get_config
    return _lm_rig(get_config(spec["arch"]), spec, dtype)


def _check_kv(phase, line, model, spec) -> None:
    """The decoder's self-attention cache: prompt + new (+ the VLM's
    prefix) slots a layer."""
    cfg = model.cfg
    want = [cfg.n_layers, spec["batch"],
            spec["prompt_len"] + spec["new"] + model.n_prefix,
            cfg.n_kv_heads, cfg.head_dim]
    if line["kv_cache_shape"] != want:
        raise AssertionError(f"{phase}: KV cache {line['kv_cache_shape']}, "
                             f"want {want}")


def phase_vlm_main(rig, smi: str) -> dict:
    """:func:`_lm_main` for phi-3-vision-4.2b at full width and depth
    (VLM_CFG, VLM_LOSS): the projected patches before every prompt, the
    decode positions after them."""
    cfg = rig[0]
    line = _lm_main("vlm_main", rig, VLM_CFG, VLM_LOSS, smi,
                    n_prefix=cfg.n_prefix_tokens,
                    frontend_dim=cfg.frontend_dim)
    _check_kv("vlm_main", line, rig[1], VLM_CFG)
    return line


def phase_encdec_main(rig, smi: str) -> dict:
    """:func:`_lm_main` for whisper-large-v3 at full width and depth
    (ENCDEC_CFG, ENCDEC_LOSS): the encoder once a prefill over the
    frames, every decoder layer's cross-attention keys and values cached,
    decode reading them back; then the loss and its adapter gradient
    through the decoder and the encoder."""
    cfg = rig[0]
    line = _lm_main("encdec_main", rig, ENCDEC_CFG, ENCDEC_LOSS, smi,
                    encoder_layers=sum(s.n_layers
                                       for s in cfg.encoder_stages),
                    encoder_seq=cfg.encoder_seq,
                    frontend_dim=cfg.frontend_dim)
    _check_kv("encdec_main", line, rig[1], ENCDEC_CFG)
    return line


def phase_frontend_consistency(rig) -> dict:
    """The serve invariant at full width and depth for a front-end arch:
    the rig's bf16 weights upcast to fp32 in place, FRONTEND_CONSISTENCY's
    prompt prefilled (after phi's patches; whisper's encoder over its 1500
    frames) and decoded, each position's logits against forward(mode=
    "full") within FRONTEND_FP32_TOL, TF32 off; no kernel and no plain
    twin.  The rig's bf16 model is spent."""
    import dataclasses
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models.model import make_model
    cfg, _, params, adapters, batch = rig
    _to_fp32_in_place(params)
    model = make_model(dataclasses.replace(cfg, dtype="float32"),
                       remat=False)
    spec = FRONTEND_CONSISTENCY[cfg.name]
    b, pre, k = (spec[key] for key in ("batch", "prompt_len", "decode"))
    runtime.full_fp32()
    runtime.reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        errs = _consistency(model, params, adapters,
                            _as_batch(batch, b, pre + k), pre,
                            FRONTEND_FP32_TOL)
    torch.cuda.synchronize()
    launches = sum(runtime.LAUNCHES.values())
    plain = sum(runtime.PLAIN_CALLS.values())
    line = {"phase": "frontend_consistency", "arch": cfg.name,
            "layers": cfg.n_layers, **spec, "cut": ["dtype bfloat16 -> "
                                                    "float32"],
            "n_prefix": model.n_prefix, "encoder_seq": cfg.encoder_seq,
            "fp32_max_abs_err": [e for e, _ in errs],
            "fp32_tol": [t for _, t in errs],
            "rel_err": [e / t * FRONTEND_FP32_TOL for e, t in errs],
            "seconds": time.perf_counter() - t0, "launches": launches,
            "plain_calls": plain}
    emit(line)
    if launches or plain:
        raise AssertionError(f"frontend_consistency {cfg.name}: {launches} "
                             f"launches, {plain} plain calls")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"frontend_consistency {cfg.name}: decode "
                             f"diverges from the full forward: {errs}")
    return line


def phase_frontend_round(smi: str) -> dict:
    """The paper's aggregation over an encoder-decoder's whole adapter
    tree: four clients' whisper adapters at full depth (the encoder's and
    the decoder's 32 layers each and the front-end projector's pair) at
    FRONTEND_ROUND_RANKS, each B live on its rank, through
    :func:`_rbla_round` (one packed_agg launch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.lora import mask_pair, tree_map_pairs
    from repro_torch.models.model import make_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(ENCDEC_CFG["arch"])
    model = make_model(cfg, remat=False)
    clients = []
    for i, r in enumerate(FRONTEND_ROUND_RANKS):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        clients.append(tree_map_pairs(
            lambda pair, gen=gen: mask_pair(dict(pair, B=torch.randn(
                pair["B"].shape, generator=gen, device="cuda") * 0.02)),
            model.init_adapters(gen, r_max=64, rank=r)))
    n_pairs = len(tree_leaves(tree_map_pairs(lambda p: p["rank"],
                                             clients[0])))
    return _rbla_round("frontend_round", clients, FRONTEND_ROUND_RANKS, smi,
                       arch=cfg.name, subtrees=sorted(clients[0]),
                       pair_leaves=n_pairs)


def _train_run(argv, smi: str) -> dict:
    """``repro_torch.launch.train.main(argv)`` with a temporary ``--ckpt``:
    the losses finite, the ms a step, the cohort upload one packed_agg
    launch (enforced: nothing else launches; the only plain calls are a
    mamba layer's scan, one a layer a step), held against the plain round
    (``backend="ref"``) on the same trained adapters and, a cohort of one
    at r_max = rank, against those adapters themselves, each within 2e-5
    of max|want|; and the saved adapters restored equal to the aggregate,
    bit for bit."""
    import gc
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.core.strategy import get_strategy
    from repro_torch.kernels import runtime
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "adapters")
        runtime.reset_counts()
        t0 = time.perf_counter()
        res = train.main([*argv, "--ckpt", ckpt])
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        plain = {k: v for k, v in runtime.PLAIN_CALLS.items() if v}
        back = restore(ckpt, res["adapters"])
        same = all(torch.equal(g, w) for g, w in zip(
            tree_leaves(back), tree_leaves(res["adapters"]), strict=True))
    step_ms = [t * 1e3 for t in res["step_s"]]
    cfg = res["cfg"]
    rank = res["rank"]
    want = get_strategy("rbla").with_options().aggregate_adapters(
        [res["trained"]], torch.ones(1, device="cuda"), r_max=rank,
        client_ranks=torch.tensor([rank], dtype=torch.int32, device="cuda"),
        backend="ref")
    err, scale = _rel_err(res["adapters"], want)
    err_trained, scale_trained = _rel_err(res["adapters"], res["trained"])
    tol = 2e-5 * max(scale, 1.0)
    tol_trained = 2e-5 * max(scale_trained, 1.0)
    n_mamba = sum(st.repeat * sum(b.kind == "mamba" for b in st.unit)
                  for st in cfg.stages)
    want_plain = {"ssd_scan": n_mamba * len(step_ms)} if n_mamba else {}
    line = {"phase": "train_main", "card": smi, "argv": list(argv),
            "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "losses": res["losses"], "step_ms": step_ms,
            "ms_per_step": statistics.median(step_ms[1:]),
            "seconds": secs, "peak_device_bytes":
            torch.cuda.max_memory_allocated(), "launches": launches,
            "plain_calls": plain, "max_abs_err": err, "tol": tol,
            "max_abs_err_vs_trained": err_trained,
            "tol_vs_trained": tol_trained, "restored_equal": same}
    emit(line)
    del res, back, want
    gc.collect()
    torch.cuda.empty_cache()
    if launches != {"packed_agg": 1} or plain != want_plain:
        raise AssertionError(f"train_main {cfg.name}: launches {launches}, "
                             f"plain {plain}: the cohort upload is one "
                             f"packed_agg launch, the plain calls "
                             f"{want_plain}")
    if not (err <= tol and err_trained <= tol_trained):
        raise AssertionError(f"train_main {cfg.name}: the cohort upload "
                             f"disagrees with the plain round ({err}, "
                             f"tolerance {tol}) or with the trained "
                             f"adapters ({err_trained}, tolerance "
                             f"{tol_trained})")
    if not (all(math.isfinite(v) for v in line["losses"]) and same):
        raise AssertionError(f"train_main {cfg.name}: a loss is not finite "
                             "or the restored adapters differ from the "
                             "aggregate")
    return line


def phase_train_main(smi: str) -> list:
    """:func:`_train_run` for each of TRAIN_RUNS: h2o-danube-3-4b at full
    width and depth in bf16, 20 Adam steps of its adapters through
    autograd (batch 4 x 128 tokens), then mamba2-1.3b's 48 layers for 3
    steps through the plain scan (the ssd_scan kernel has no backward)."""
    return [_train_run(argv, smi) for argv in TRAIN_RUNS]


def phase_frontends(smi: str) -> dict:
    """vlm_main and phi's frontend_consistency on one rig, then encdec_main
    and whisper's on another, then frontend_round and train_main; each rig
    freed before the next."""
    import gc
    import torch
    out = {}
    for spec, run in ((VLM_CFG, phase_vlm_main),
                      (ENCDEC_CFG, phase_encdec_main)):
        rig = _frontend_rig(spec)
        out[spec["arch"]] = run(rig, smi)
        phase_frontend_consistency(rig)      # upcasts the weights in place
        del rig
        gc.collect()
        torch.cuda.empty_cache()
    out["round"] = phase_frontend_round(smi)
    out["train"] = phase_train_main(smi)
    return out


# ------------------------------------------------------------- distributed --
#: (d)'s strategies through aggregate_adapters(backend="distributed")
DIST_METHODS = ("fedavg", "zeropad", "rbla", "rbla_ranked")
#: one rank of (d) reaches the chip in about 8 s and builds nothing
DIST_CHILD_TIMEOUT = 300


def _dist_counts(launches, plain) -> dict:
    from repro_torch.kernels import runtime
    return {"collectives": dict(runtime.COLLECTIVES),
            "launches": {k: v for k, v in launches.items() if v},
            "plain_calls": {k: v for k, v in plain.items() if v}}


def _mlp_wire_floats() -> tuple[int, int]:
    """The distributed rbla round's buffer at the MLP's shapes: every pair
    side's numerator (its leaf) and denominator (its rank rows)."""
    nums = sum(64 * fi + fo * 64 for _, fo, fi in MLP_PAIRS)
    return nums, 2 * 64 * len(MLP_PAIRS)


def _dist_round_times(smi) -> dict:
    """A distributed rbla ``CompiledRound`` call against the planned kernel
    round on the agg_rounds cohort, under the one-rank group: wall ms, the
    device kernels and copies of one call (the all_reduce's among them)."""
    import torch
    from repro_torch.core import plan, strategy
    clients, prev, w = _mlp_cohort(11)
    ranks = torch.tensor(STAIRCASE, dtype=torch.int32, device="cuda")
    stacked = strategy.stack_trees(clients)
    strat = strategy.get_strategy("rbla")
    rounds = {kind: strat.plan(None, plan.build_cohort_spec(
        stacked, kind=kind, r_max=64, client_ranks=ranks, prev_tree=prev))
        for kind in ("kernel", "distributed")}
    err, scale = _rel_err(rounds["distributed"](stacked, w, prev),
                          rounds["kernel"](stacked, w, prev))
    nums, dens = _mlp_wire_floats()
    row = {"phase": "distributed", "leg": "round",
           "nvidia_smi": smi, "max_abs_err": err, "tol": 2e-5 * scale,
           "wire_floats": {"numerator": nums, "denominator": dens},
           "buffer_bytes": 4 * (nums + dens)}
    for kind, round_ in rounds.items():
        def call(round_=round_):
            return round_(stacked, w, prev)
        kernels, copies = _device_events(call)
        row[kind] = {"plan_kind": round_.kind, "ms": time_ms(call),
                     "back_to_back_ms": time_ms_back_to_back(call),
                     "device_kernels": kernels, "copies": copies,
                     "device_ms": sum(m for _, m in kernels.values())}
    row["all_reduce_device_ms"] = sum(
        m for k, (_, m) in row["distributed"]["device_kernels"].items()
        if "nccl" in k.lower())
    emit(row)
    if not err <= 2e-5 * scale:
        raise AssertionError("distributed: the collective round disagrees "
                             "with the kernel round")
    return row


def _dist_rank(rank, world, store, cohort_path, out_path, src):
    """One rank of (d): a gloo group of ``world`` ranks on cuda:0, the
    quickstart's last cohort through every distributed path, each result
    against the single-process kernel round saved beside the cohort.
    Writes its rows as JSON to ``out_path``; raises on a disagreement."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.core import compat, get_strategy
    from repro_torch.core.distributed import make_distributed_aggregator
    from repro_torch.core.strategy import stack_trees
    from repro_torch.kernels import runtime
    from repro_torch.lora import adapter_masks
    from repro_torch.tree import tree_map
    runtime.full_fp32()
    torch.cuda.set_device(0)
    data = torch.load(cohort_path, map_location="cuda:0")
    clients, w, ranks = data["clients"], data["weights"], data["ranks"]
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    rows, bad = [], []

    def check(label, got, want, tol_rel, products=False):
        err = scale = 0.0
        for k in want:
            if products:
                pairs = [(got[k]["B"].float() @ got[k]["A"].float(),
                          want[k]["B"].float() @ want[k]["A"].float())]
            else:
                pairs = [(got[k][f].float(), want[k][f].float())
                         for f in ("A", "B")]
            for g, t in pairs:
                err = max(err, float((g - t).abs().max()))
                scale = max(scale, float(t.abs().max()))
        row = {"case": label, "max_abs_err": err, "tol": tol_rel * scale,
               "on_card": all(got[k][f].is_cuda for k in want
                              for f in ("A", "B")),
               "collectives": dict(runtime.COLLECTIVES),
               "launches": {k: v for k, v in runtime.LAUNCHES.items() if v}}
        rows.append(row)
        if not (err <= tol_rel * scale and row["on_card"]):
            bad.append(label)

    def agg(method, **options):
        return get_strategy(method).with_options(**options).aggregate_adapters(
            clients, w, r_max=64, client_ranks=ranks,
            prev_global=data["prev"] if method != "flora" else None,
            backend="distributed")
    try:
        for method in DIST_METHODS:
            runtime.reset_counts()
            check(method, agg(method), data["want"][method], 2e-5)
        # make_distributed_aggregator on this rank's slice only
        stacked = stack_trees(clients)
        loc = compat.local_slice(len(clients), dist.group.WORLD)
        masks = adapter_masks(stacked)
        runtime.reset_counts()
        got = make_distributed_aggregator(None, "clients", "rbla")(
            tree_map(lambda t: t[loc], stacked),
            tree_map(lambda m: m if m.ndim == 0 else m[loc], masks), w[loc])
        check(f"local_aggregator[{loc.start}:{loc.stop}]", got,
              data["want"]["local"], 2e-5)
        walls = []
        for _ in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agg("rbla")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        probe = [torch.empty(4, device="cuda") for _ in range(world)]
        try:
            dist.all_gather(probe, torch.ones(4, device="cuda"))
            gather = "ran"
        except RuntimeError as e:     # reported, and the legs not run
            gather = f"refused: {e}"
        if gather == "ran":
            runtime.reset_counts()
            check("svd", agg("svd"), data["want"]["svd"], 1e-4, True)
            runtime.reset_counts()
            check("flora", agg("flora", stack_r_cap=512),
                  data["want"]["flora"], 1e-4, True)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "rows": rows, "gather": gather,
                   "rbla_round_wall_ms": statistics.median(walls[3:])}, f)
    if bad:
        raise AssertionError(f"rank {rank}: {bad} disagree with the kernel "
                             "round")


def _two_ranks(last, smi, tmp) -> list:
    """(d): 2 gloo ranks on cuda:0 over the quickstart's last cohort."""
    import multiprocessing
    import torch
    import repro_torch
    from repro_torch.core import get_strategy
    prev_state, updates, _ = last
    clients = [u.adapters for u in updates]
    w = torch.tensor([float(u.n_examples) for u in updates], device="cuda")
    ranks = torch.tensor([u.rank for u in updates], dtype=torch.int32,
                         device="cuda")

    def want(method, prev, **options):
        return get_strategy(method).with_options(**options).aggregate_adapters(
            clients, w, r_max=64, client_ranks=ranks, prev_global=prev,
            backend="kernel")
    data = {"clients": clients, "weights": w, "ranks": ranks,
            "prev": prev_state.adapters,
            "want": {m: want(m, prev_state.adapters) for m in DIST_METHODS}}
    data["want"]["local"] = want("rbla", None)
    data["want"]["svd"] = want("svd", None)
    data["want"]["flora"] = want("flora", None, stack_r_cap=512)
    cohort = str(Path(tmp) / "cohort.pt")
    torch.save(data, cohort)
    ctx = multiprocessing.get_context("spawn")
    outs = [str(Path(tmp) / f"rank{k}.json") for k in range(2)]
    procs = [ctx.Process(target=_dist_rank, args=(
        k, 2, str(Path(tmp) / "gloo_store"), cohort, outs[k],
        str(Path(repro_torch.__file__).resolve().parents[1])))
        for k in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(DIST_CHILD_TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for k, p in enumerate(procs):
        if p.exitcode != 0:
            raise AssertionError(f"distributed (d): rank {k} exited "
                                 f"{p.exitcode}")
        with open(outs[k]) as f:
            results.append(json.load(f))
        emit({"phase": "distributed", "leg": "two_gloo_ranks",
              "nvidia_smi": smi, **results[-1]})
    return results


def phase_distributed(smi: str) -> dict:
    """backend="distributed" on the card, each leg against its kernel-path
    twin run first in this phase: (a) the main path under a one-rank NCCL
    group, (b) one flora and one svd round, (c) the async service
    streaming and buffered, then (d) two gloo ranks on cuda:0."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import runtime
    dist_cfg = dict(MAIN_CFG, agg_backend="distributed")
    flora_cfg = dict(FLORA_CFG, rounds=1)
    svd_cfg = dict(MAIN_CFG, method="svd", rounds=1)
    semi_cfg = dict(ASYNC_CFG, buffer_size=5)
    twin = {"main": drive(MAIN_CFG), "flora": drive(flora_cfg),
            "svd": drive(svd_cfg), "stream": drive_async(ASYNC_CFG),
            "semi": drive_async(semi_cfg)}
    launches_on_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            # (a) the main path
            hist, launches, plain, last, secs, _ = drive(dist_cfg)
            counts = _dist_counts(launches, plain)
            k_hist, _, _, k_last, k_secs, _ = twin["main"]
            err, scale = _rel_err(last[2].adapters, k_last[2].adapters)
            gap = max(abs(a - b) for a, b in zip(hist.test_acc,
                                                 k_hist.test_acc))
            emit({"phase": "distributed", "leg": "main_path",
                  "test_acc": hist.test_acc, "kernel_test_acc":
                  k_hist.test_acc, "round_time_s": hist.round_time_s,
                  "seconds": secs, "kernel_seconds": k_secs, **counts,
                  "max_acc_gap": gap, "adapters_max_abs_err": err,
                  "adapters_tol": 1e-3 * scale})
            if counts["collectives"] != {"all_reduce": MAIN_CFG["rounds"],
                                         "all_gather": 0, "all_to_all": 0} \
                    or counts["launches"] or counts["plain_calls"]:
                raise AssertionError(f"distributed (a): {counts}: one "
                                     "all_reduce a round and no kernel "
                                     "expected")
            if not (gap <= 0.01 and err <= 1e-3 * scale):
                raise AssertionError("distributed (a): the collective rounds "
                                     "disagree with the kernel rounds")
            _leaves_on_card(last[2].adapters)
            _leaves_on_card(last[2].base_trainable)
            round_row = _dist_round_times(smi)
            # (b) flora and svd, one round each
            for name, cfg in (("flora", flora_cfg), ("svd", svd_cfg)):
                hist, launches, plain, last, secs, _ = drive(
                    dict(cfg, agg_backend="distributed"))
                counts = _dist_counts(launches, plain)
                k_hist, _, _, k_last, _, _ = twin[name]
                err, scale = _product_err(last[2].adapters,
                                          k_last[2].adapters)
                gap = abs(hist.test_acc[-1] - k_hist.test_acc[-1])
                emit({"phase": "distributed", "leg": name,
                      "test_acc": hist.test_acc, "seconds": secs, **counts,
                      "acc_gap": gap, "product_max_abs_err": err,
                      "tol": 1e-4 * scale})
                want = {"flora_stack": 1} if name == "flora" else {}
                if counts["launches"] != want or counts["plain_calls"] or \
                        counts["collectives"] != {"all_reduce": 0,
                                                  "all_gather": 1,
                                                  "all_to_all": 0}:
                    raise AssertionError(f"distributed (b) {name}: {counts}")
                if not (gap <= 0.01 and err <= 1e-4 * scale):
                    raise AssertionError(f"distributed (b) {name}: the "
                                         "gathered round disagrees with "
                                         "the kernel round")
                _leaves_on_card(last[2].adapters)
                launches_on_path.update(counts["launches"])
            # (c) the async service: streaming, then a buffer of 5
            hist, launches, plain, rec, secs = drive_async(
                dict(ASYNC_CFG, agg_backend="distributed"))
            counts = _dist_counts(launches, plain)
            k_hist, k_launches, _, k_rec, _ = twin["stream"]
            same = _same_bits(rec.agg, k_rec.agg)
            emit({"phase": "distributed", "leg": "async_stream",
                  "test_acc": hist.test_acc, "seconds": secs, **counts,
                  "bit_identical": same})
            folds = {"axpy_fold": ASYNC_CFG["total_updates"]}
            if (counts["launches"] != folds or counts["plain_calls"]
                    or any(counts["collectives"].values()) or not same
                    or hist.test_acc != k_hist.test_acc):
                raise AssertionError(f"distributed (c) streaming: {counts}, "
                                     f"bit identical {same}")
            launches_on_path.update(counts["launches"])
            hist, launches, plain, rec, secs = drive_async(
                dict(semi_cfg, agg_backend="distributed"))
            counts = _dist_counts(launches, plain)
            k_hist, _, _, k_rec, _ = twin["semi"]
            err, scale = _rel_err(rec.agg.state.adapters,
                                  k_rec.agg.state.adapters)
            gap = max(abs(a - b) for a, b in zip(hist.test_acc,
                                                 k_hist.test_acc))
            flushes = rec.agg.n_flushes
            emit({"phase": "distributed", "leg": "async_buffered",
                  "test_acc": hist.test_acc, "seconds": secs, **counts,
                  "n_flushes": flushes, "max_acc_gap": gap,
                  "adapters_max_abs_err": err, "adapters_tol": 1e-3 * scale})
            if counts["collectives"] != {"all_reduce": flushes,
                                         "all_gather": 0, "all_to_all": 0} \
                    or counts["launches"] or counts["plain_calls"] \
                    or flushes != semi_cfg["total_updates"] // 5:
                raise AssertionError(f"distributed (c) buffered: {counts}, "
                                     f"{flushes} flushes")
            if not (gap <= 0.01 and err <= 1e-3 * scale):
                raise AssertionError("distributed (c) buffered: the "
                                     "collective flushes disagree with the "
                                     "kernel flushes")
        finally:
            dist.destroy_process_group()
        # (d) two gloo ranks on one card, over the quickstart's last cohort
        ranks = _two_ranks(twin["main"][3], smi, tmp)
    return {"launches": launches_on_path, "round": round_row,
            "two_rank_wall_ms": [r["rbla_round_wall_ms"] for r in ranks],
            "gather": ranks[0]["gather"]}


def _args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of " + ", ".join(SELECTABLE)
                    + ": run only these; default every phase")
    ap.add_argument("--src", default=str(SRC),
                    help="the source root whose repro_torch runs (default "
                    "this checkout's src/)")
    args = ap.parse_args(argv)
    if args.phases is not None:
        args.phases = [n for n in args.phases.split(",") if n]
        unknown = sorted(set(args.phases) - set(SELECTABLE))
        if unknown:
            ap.error(f"--phases: unknown {unknown}; options {SELECTABLE}")
    return args


def run_selected(names, smi: str) -> dict:
    """The independent phases in ``names``, in that order; returns their
    kernels' summary rows."""
    import torch
    summary = {}
    for name in names:
        if name == "kernels":
            summary.update(phase_kernels())
        elif name == "agg_rounds":
            phase_agg_rounds()
        elif name == "robust_large":
            phase_robust_large()
        elif name == "per_pair_rounds":
            phase_per_pair_rounds()
        elif name == "lora_kernels":
            summary.update(phase_lora_kernels())
        elif name == "serve_main":
            phase_serve_main()
        elif name == "serve_streams":
            phase_serve_streams()
        elif name == "ssd_kernels":
            summary["ssd_scan"] = phase_ssd_kernels()
        elif name == "async_durable":
            phase_async_durable(smi)
        elif name == "distributed":
            phase_distributed(smi)
        elif name == "attn_main":
            phase_attn_main(_attn_rig(), smi)
        elif name == "attn_consistency":
            rig = _attn_rig()
            phase_attn_consistency(rig, _fp32_rig(rig))
        elif name == "attn_zoo":
            phase_attn_zoo()
        elif name == "moe_main":
            rig = _moe_rig()
            phase_moe_main(rig, smi)
            summary["packed_agg"] = {"moe_round": _moe_expert_round(
                rig[0], smi)}
            del rig
            torch.cuda.empty_cache()
        elif name == "moe_consistency":
            phase_moe_consistency(_moe_rig())
        elif name == "moe_zoo":
            phase_moe_zoo(smi)
        elif name == "moe_ep":
            phase_moe_ep(smi)
        elif name in ("vlm_main", "encdec_main"):
            spec = VLM_CFG if name == "vlm_main" else ENCDEC_CFG
            rig = _frontend_rig(spec)
            (phase_vlm_main if name == "vlm_main" else phase_encdec_main)(
                rig, smi)
            del rig
            torch.cuda.empty_cache()
        elif name == "frontend_consistency":
            for spec in (VLM_CFG, ENCDEC_CFG):
                rig = _frontend_rig(spec)
                phase_frontend_consistency(rig)
                del rig
                torch.cuda.empty_cache()
        elif name == "frontend_round":
            summary["packed_agg"] = {"frontend_round":
                                     phase_frontend_round(smi)}
        elif name == "train_main":
            phase_train_main(smi)
        emit({"phase": name, "ok": True})
    return summary


def main(argv=None) -> int:
    global ENFORCE_DESIGN
    args = _args(argv)
    src = Path(args.src).resolve()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({src})",
              file=sys.stderr)
        return 2
    ENFORCE_DESIGN = src == SRC.resolve()
    t_start = time.perf_counter()
    sys.path.insert(0, str(src))
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
          "per_source_s": per_source, "src": str(src)})

    if args.phases is not None:
        summary = run_selected(args.phases, smi)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        emit({"kernels": list(summary.values())})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    summary = phase_kernels()
    emit({"phase": "kernels", "ok": True})
    rounds = phase_agg_rounds()
    summary["packed_agg"]["round_ms"] = rounds[0]["ms"]
    summary["packed_stack"]["round_ms"] = next(
        r["ms"] for r in rounds if r["strategy"] == "flora")
    emit({"phase": "agg_rounds", "ok": True})
    pair_rounds = {r["strategy"]: r for r in phase_per_pair_rounds()}
    summary["rbla_agg"]["round_ms"] = pair_rounds["rbla"]["ms"]
    summary["flora_stack"]["round_ms"] = pair_rounds["flora"]["ms"]
    emit({"phase": "per_pair_rounds", "ok": True})

    hist, main_launches, last, main_rec = phase_main_path()
    phase_plain_reference(hist, last)
    phase_other_methods()
    flora_launches, flora_rec = phase_flora()
    robust = phase_robust()
    phase_robust_clip(robust["rbla_clipped"][1])
    phase_svd()
    # the per-pair paths on each phase's last cohort: one grouped launch a
    # round (rbla_agg, flora_stack), one grouped launch a pair (packed_robust)
    pair_launches = phase_per_pair(main_rec, "rbla_agg", 1, 2e-5, "per_pair",
                                   one_kernel=True)
    # the last flora cohort is round 3's, within the cap: pure copies with
    # the plan's scale arithmetic up to its order (a few ulp of B)
    stack_launches = phase_per_pair(flora_rec, "flora_stack", 1, 1e-6,
                                    "per_pair_flora", one_kernel=True)
    phase_per_pair(robust["rbla_median"][1], "packed_robust", 3, 2e-5,
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
    durable = phase_async_durable(smi)
    emit({"phase": "async_durable", "ok": True, "replay_launches": durable})

    summary.update(phase_lora_kernels())
    emit({"phase": "lora_kernels", "ok": True})
    serve_launches, engine, agg = phase_serve_main()
    phase_serve_mlp(last, hist.test_acc[-1])
    phase_serve_streams()
    dense_launches = phase_serve_dense(last)
    phase_obs(agg, engine)
    summary["batched_lora_matmul"]["launches"] = \
        serve_launches["batched_lora_matmul"]
    summary["lora_matmul"]["launches"] = dense_launches["lora_matmul"]

    summary["ssd_scan"] = phase_ssd_kernels()
    emit({"phase": "ssd_kernels", "ok": True})
    rig = _mamba_rig()
    mamba_launches, kernel_logits = phase_mamba_main(rig)
    rig32 = _fp32_rig(rig)
    phase_mamba_plain(rig, rig32, kernel_logits)
    phase_mamba_consistency(rig, rig32)
    summary["ssd_scan"]["launches"] = mamba_launches["ssd_scan"]
    del rig, rig32, kernel_logits
    torch.cuda.empty_cache()

    attn = _attn_rig()
    phase_attn_main(attn, smi)
    attn32 = _fp32_rig(attn)
    phase_attn_consistency(attn, attn32)
    del attn, attn32
    torch.cuda.empty_cache()
    phase_attn_zoo()
    emit({"phase": "attention", "ok": True})

    moe = _moe_rig()
    phase_moe_main(moe, smi)
    moe_round = _moe_expert_round(moe[0], smi)
    phase_moe_consistency(moe)      # upcasts moe's weights in place
    del moe
    torch.cuda.empty_cache()
    zoo = phase_moe_zoo(smi)
    ep = phase_moe_ep(smi)
    summary["packed_agg"]["moe_round"] = {
        k: moe_round[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "max_abs_err", "bytes")}
    summary["ssd_scan"]["jamba_prefill_launches"] = \
        zoo[0]["launches"]["ssd_scan"]
    emit({"phase": "moe", "ok": True, "ep_ms": ep["ep_ms"],
          "sort_ms": ep["sort_ms"],
          "two_rank_wall_ms": ep["two_rank_wall_ms"]})

    fe = phase_frontends(smi)
    summary["packed_agg"]["frontend_round"] = {
        k: fe["round"][k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "bytes")}
    summary["packed_agg"]["train_upload_launches"] = {
        t["arch"]: t["launches"]["packed_agg"] for t in fe["train"]}
    emit({"phase": "frontends", "ok": True, "train_ms_per_step": {
        t["arch"]: t["ms_per_step"] for t in fe["train"]}})

    dist_path = phase_distributed(smi)
    emit({"phase": "distributed", "ok": True, **dist_path})
    for name in ("axpy_fold", "flora_stack"):
        summary[name]["distributed_launches"] = dist_path["launches"][name]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    emit({"kernels": list(summary.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
