"""One run of one cell, as ``gpubench/run.py`` prints it: the driver's run,
the cell's metrics read, ``correct`` decided, the result object built."""
from __future__ import annotations

import math
import time


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float | None = None, overrides: dict | None = None,
             root=None) -> dict:
    """One run of ``workload`` on ``device``; the result object.
    ``overrides`` (tests) sets ``{"arch": {...}, "params": {...}}`` over
    the configuration's widths and the workload's parameters; ``root``
    (tests) is the checkout whose manifest and files are read."""
    from . import cell as C
    from . import env, peaks, spec
    from .trace import device_ops
    t0 = time.perf_counter() if t0 is None else t0
    root = spec.ROOT if root is None else root
    manifest = spec.load_manifest(root)
    cell = C.build(workload, seed, seconds, trace, device, t0, overrides,
                   root)
    cfg, params = cell.cfg, cell.params
    out = spec.load_driver(cell.workload["driver"], root).run(cell)
    info = env.device_info(device)
    e2e, per_layer = spec.cell_metrics(manifest, workload)
    metrics = {}
    if not trace:
        for m in e2e:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = dict(out["ctx"])
        ctx.update(cfg=cfg, params=params,
                   peaks=peaks.for_device(info["kind"]))
        for m in per_layer:
            v = spec.load_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the workload's limits say which numbers are compared
    readings = out["readings"]
    checks = {k: (readings.get(k, math.inf), lim)
              for k, lim in cell.workload["limits"].items()}
    correct = out["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    dev = {"platform": info["platform"], "kind": info["kind"],
           "count": info["count"],
           "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit": info["power_limit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    reading = out.get("trace")
    if trace and reading is not None:
        dev["busy_s"] = reading["busy_s"]
        dev["window_s"] = reading["window_s"]
        result["breakdown"] = {"device_ops": device_ops(reading),
                               "idle_gaps": reading["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in checks.items()}
    return result
