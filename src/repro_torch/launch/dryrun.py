"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes and record its per-device flops, bytes, collectives and
roofline terms on the H100 constants.

    python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b \\
        --shape train_4k --mesh pod1
    python -m repro_torch.launch.dryrun            # every combination

The port's counterpart of the JAX package's ``repro.launch.dryrun``, which
lowers and compiles each step on 256 or 512 fake host devices.  Here the
world is a fake process group (``torch.testing``'s ``FakeStore``, backend
``"fake"``) of 256 (``pod1``, the ``(16, 16)`` mesh) or 512 (``pod2``,
``(2, 16, 16)``) ranks in this one process, and the mesh a
``DeviceMesh`` over it: no card and no memory are needed.  Params,
adapters, Adam state, batch and caches are DTensors over fake local shards
(the mesh and the fakes on the CPU device, which every build of PyTorch
has), placed as :func:`model_state_specs`, :func:`input_specs` and
:func:`decode_input_specs` place them by ``repro_torch.sharding.rules``
(``rules.shaped``).  Each step (:func:`build_train_step`,
:func:`build_prefill_step`, :func:`build_decode_step`) is traced once
under ``FakeTensorMode`` and ``roofline.DeviceCounts``: rank 0's flops
(``torch.utils.flop_counter``'s formulas, the ``ssd_scan`` op's among
them), the bytes its ops read and write, and the output bytes of its
collectives by kind.  These are estimates from traced shapes, not times.

The train step's model takes ``scan_backend="ref"`` (the ``ssd_scan``
kernel has no backward, as in ``launch.train``); prefill and decode take
``"kernel"``, as on the card, and a fake tensor traces the kernel's
registered op through its fake implementation.
Records keep the reference's keys and go to ``build/dryrun/``: ``lower_s``
is the seconds to place the inputs and trace the step, ``compile_s`` is 0
(nothing is compiled), ``memory_analysis`` gives rank 0's argument and
output bytes (a fake trace allocates nothing, so no temp or peak figure),
and ``scan_correction`` is recorded for parity but applied as 1.0: the
trace sees every layer, where XLA's CPU cost analysis counts a scanned
layer stack once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.train import _like
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models.common import MetaGenerator
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.roofline.analysis import (DeviceCounts, Roofline,
                                           active_params,
                                           model_flops_estimate,
                                           scan_correction)
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_OUT = "build/dryrun"


# ------------------------------------------------------------- the world ---
@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, this process
    rank 0: collectives return at once and move nothing.  Destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- skip rules ---
def skip_reason(cfg, shape) -> str | None:
    if shape.kind == "decode" and shape.name == "long_500k" and \
            not cfg.subquadratic:
        return ("pure full-attention architecture: long_500k requires "
                "sub-quadratic attention (DESIGN.md long_500k rule)")
    return None


# -------------------------------------------------------------- input specs -
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, mesh):
    """DTensor stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.long)}
    if cfg.is_encdec:
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.frontend_dim),
                                torch.float32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = _meta((b, cfg.n_prefix_tokens, cfg.frontend_dim),
                                 torch.float32)
    return rules.shaped(batch, rules.batch_specs(batch, mesh), mesh,
                        device=mesh.device_type)


def decode_input_specs(cfg, shape, mesh, model, seq_shard_model=False):
    """The caches of ``seq_len`` (+ a VLM's prefix) slots, the token and
    the position (an int: the last slot) of one decode step."""
    b, s = shape.global_batch, shape.seq_len
    n_prefix = model.n_prefix
    cache = model.init_cache(b, s + n_prefix, device="meta")
    cspecs = rules.cache_specs(cache, mesh, b,
                               seq_shard_model=seq_shard_model)
    caches = rules.shaped(cache, cspecs, mesh, device=mesh.device_type)
    tok = _meta((b,), torch.long)
    token = rules.shaped(tok, rules.batch_specs(tok, mesh), mesh,
                         device=mesh.device_type)
    return caches, token, s + n_prefix - 1


def model_state_specs(cfg, mesh, model, fsdp=False):
    """Params placed by ``rules.param_specs`` and adapters at rank
    ``lora_r_max`` by ``rules.adapter_specs``, as DTensors over fake
    local shards; with their specs."""
    shapes = model.init(MetaGenerator())
    pspecs = rules.param_specs(shapes, mesh, fsdp=fsdp)
    params = rules.shaped(shapes, pspecs, mesh, device=mesh.device_type)
    ad_shapes = model.init_adapters(MetaGenerator(), rank=cfg.lora_r_max)
    aspecs = rules.adapter_specs(ad_shapes, mesh)
    adapters = rules.shaped(ad_shapes, aspecs, mesh,
                            device=mesh.device_type)
    return params, adapters, pspecs, aspecs


# ------------------------------------------------------------ step builders -
def build_train_step(model, cfg):
    """One LoRA step: the loss, the factors' gradient (in their placement),
    Adam's update.  Returns (step, opt)."""
    opt = adam(1e-4)

    def train_step(params, adapters, opt_state, batch):
        factors, ranks = strip_ranks(adapters)
        live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
        loss = model.loss(params, attach_ranks(live, ranks), batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda f: _like(next(grads), f), factors)
        updates, opt_state = opt.update(grads, opt_state, factors)
        factors = apply_updates(factors, updates)
        return attach_ranks(factors, ranks), opt_state, loss.detach()

    return train_step, opt


def build_prefill_step(model):
    def prefill_step(params, adapters, batch):
        return model.prefill(params, adapters, batch)
    return prefill_step


def build_decode_step(model):
    def serve_step(params, adapters, caches, token, pos):
        return model.decode_step(params, adapters, caches, token, pos)
    return serve_step


# ------------------------------------------------------------------ tracing -
def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def trace(cfg, shape, mesh, model, *, fsdp=False, seq_shard_model=False):
    """Place the inputs of ``shape``'s step on ``mesh`` and trace the step
    once under ``FakeTensorMode``.  Returns (counts, memory) -- rank 0's
    ``DeviceCounts`` and its argument and output bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode(), implicit_replication():
        params, adapters, _, _ = model_state_specs(cfg, mesh, model,
                                                   fsdp=fsdp)
        if shape.kind == "train":
            step, opt = build_train_step(model, cfg)
            factors, _ = strip_ranks(adapters)
            args = (params, adapters, opt.init(factors),
                    input_specs(cfg, shape, mesh))
        elif shape.kind == "prefill":
            step = build_prefill_step(model)
            args = (params, adapters, input_specs(cfg, shape, mesh))
        else:
            step = build_decode_step(model)
            args = (params, adapters) + decode_input_specs(
                cfg, shape, mesh, model, seq_shard_model=seq_shard_model)
        with DeviceCounts() as counts:
            out = step(*args)
        memory = {"argument_size_in_bytes": _local_bytes(args),
                  "output_size_in_bytes": _local_bytes(out),
                  "temp_size_in_bytes": None,
                  "note": "rank 0's local shards; a fake-tensor trace "
                          "allocates nothing, so no temp or peak figure"}
    return counts, memory


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device="cpu")
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    return make_test_mesh(tuple(mesh_shape), axes, device="cpu")


# ------------------------------------------------------------------ runner --
def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            remat=True, mla_absorbed: bool = False, fsdp: bool = False,
            tag: str = "", cfg_overrides: dict | None = None,
            seq_shard_model: bool = False, mesh_shape=None,
            shape=None, write: bool = True) -> dict:
    """One combination's record.  ``mesh_shape`` and ``shape`` (an
    ``InputShape``) stand in for the production mesh and the named shape,
    for small worlds; ``cfg_overrides`` may hold ``reduced=True``."""
    overrides = dict(cfg_overrides or {})
    cfg = get_config(arch)
    if overrides.pop("reduced", False):
        cfg = cfg.reduced(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or INPUT_SHAPES[shape_name]
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "pod2" if multi_pod else "pod1")
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "kind": shape.kind, "remat": remat, "fsdp": fsdp,
                 "mla_absorbed": mla_absorbed, "tag": tag,
                 "cfg_overrides": cfg_overrides or {}}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        if write:
            _write(out_dir, rec, tag)
        print(f"[skip] {arch} x {shape.name} x {mesh_name}: {reason}")
        return rec

    n = (int(torch.tensor(mesh_shape).prod()) if mesh_shape
         else 512 if multi_pod else 256)
    model = make_model(cfg, remat=remat, mla_absorbed=mla_absorbed,
                       scan_backend="ref" if shape.kind == "train"
                       else "kernel")
    rec["remat"] = str(remat)
    t0 = time.time()
    with fake_world(n):
        mesh = _mesh(multi_pod, mesh_shape)
        counts, memory = trace(cfg, shape, mesh, model, fsdp=fsdp,
                               seq_shard_model=seq_shard_model)
        chips = mesh.size()
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["compile_s"] = 0.0
    rec["flops_per_device"] = float(counts.flops)
    rec["flops_by_op"] = dict(counts.flops_by_op)
    rec["calls_by_op"] = dict(counts.calls_by_op)
    rec["bytes_per_device"] = float(counts.bytes)
    rec["memory_analysis"] = memory
    coll = dict(counts.collectives)
    rec["collectives"] = coll

    n_active = active_params(cfg)
    mf = model_flops_estimate(cfg, shape, n_active, shape.kind)
    rec["scan_correction"] = scan_correction(cfg)
    rec["scan_correction_applied"] = 1.0
    roof = Roofline(flops=rec["flops_per_device"],
                    hbm_bytes=rec["bytes_per_device"],
                    collective_bytes=float(sum(coll.values())),
                    chips=chips, model_flops=mf, collectives=coll)
    rec["roofline"] = roof.as_dict()
    if write:
        _write(out_dir, rec, tag)
    print(f"[ok]   {arch} x {shape.name} x {mesh_name}"
          f" lower={rec['lower_s']}s dominant={roof.dominant}")
    return rec


def _write(out_dir, rec, tag=""):
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (also accepts comma list)")
    ap.add_argument("--shape", default="all",
                    help="input shape or 'all' (comma list ok)")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2",
                                                       "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard frozen base over data axes too")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--set", default="", dest="overrides",
                    help="cfg overrides, e.g. capacity_factor=1.0,"
                         "n_experts=48")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in filter(None, args.overrides.split(",")):
        k, v = kv.split("=")
        overrides[k] = (float(v) if "." in v else int(v)) \
            if v.replace(".", "").lstrip("-").isdigit() else v

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]

    failures, records = [], []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                try:
                    records.append(run_one(
                        arch, shape, multi_pod, args.out,
                        remat=(False if args.no_remat
                               else args.remat_policy),
                        mla_absorbed=args.mla_absorbed, fsdp=args.fsdp,
                        tag=args.tag, cfg_overrides=overrides or None,
                        seq_shard_model=args.cache_seq_shard))
                except Exception:
                    failures.append((arch, shape, multi_pod))
                    print(f"[FAIL] {arch} x {shape} x "
                          f"{'pod2' if multi_pod else 'pod1'}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run combos failed: "
                         f"{failures}")
    print("all dry-run combos traced")
    return records


if __name__ == "__main__":
    main()
