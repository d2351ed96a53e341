"""One run of one cell: what a traffic driver is handed, and the small
timing helpers every driver shares."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Cell:
    """``params``: the workload's traffic parameters; ``config``: the
    configuration file; ``cfg``: its ``arch`` fields (the widths the
    reference reads); ``arch_overrides``: fields a test sets over them;
    ``t0``: the process's start on the host clock, from which ``setup_s``
    runs."""
    name: str
    workload: dict
    params: dict
    config: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    arch_overrides: dict = dataclasses.field(default_factory=dict)


def build(workload: str, seed: int, seconds: float, trace: bool, device,
          t0: float, overrides: dict | None = None, root=None) -> Cell:
    """The cell ``workload`` of the manifest under ``root`` (the
    checkout's), its files read by name; ``overrides`` (tests) sets
    ``{"arch": {...}, "params": {...}}`` over the configuration's widths
    and the workload's parameters."""
    from . import spec
    root = spec.ROOT if root is None else root
    overrides = overrides or {}
    manifest = spec.load_manifest(root)
    entry = next(w for w in manifest["workloads"] if w["name"] == workload)
    wl = spec.load_workload(workload, root)
    config = spec.load_config(entry["config"], root)
    arch_over = dict(overrides.get("arch", {}))
    cfg = {**config["arch"], **arch_over, **config.get("lora", {})}
    params = {**wl["params"], **overrides.get("params", {})}
    return Cell(name=workload, workload=wl, params=params, config=config,
                cfg=cfg, seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=device, t0=t0,
                arch_overrides=arch_over)


def syncer(device):
    """A function that waits for every queued operation on ``device``."""
    import torch
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def peak_reset(device) -> int:
    """The device's allocation peak so far, then reset (0 on the CPU)."""
    import torch
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def free(device) -> None:
    """Give the caching allocator's free blocks back before a reference
    runs."""
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
