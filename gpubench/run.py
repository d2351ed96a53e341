"""Run one benchmark cell once and print its result as the last line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, with nothing installed: the harness puts
``src`` on its own path.  The cell's entry in ``BENCHMARK.json`` names its
configuration; ``gpubench/workloads/<cell>.json`` names the traffic
driver (``gpubench/traffic/<driver>.py``) and every traffic parameter.
The run makes its weights and inputs on the device from ``--seed``,
warms the cell's shapes, measures for ``--seconds``, checks what the
timed path produced against the plain reference under
``gpubench/reference/``, and prints one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics instead, read by
``gpubench/layer_metrics/<metric>.py`` from a profiled sub-window),
``device`` and, last, ``compared`` (each number compared, with its
limit).  The compared numbers also close standard error.

It exits non-zero and prints no result without as many CUDA cards as the
cell asks for, or if JAX or the JAX package is loaded once the window
has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gpubench.lib import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from gpubench.lib import spec
    entry = next((w for w in spec.load_manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from gpubench.lib.runner import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0=T0)
    bad = env.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
