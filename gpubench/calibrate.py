"""Readings a check's limits are set from, many seeds in one process.

    python gpubench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --mode program --seconds 2
    python gpubench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --mode control

``program``: a whole run of the cell a seed (a short window), printing
the numbers it compared.  ``control``: the reference put in the program's
place at the precision below the configuration's, against the reference
(the driver's ``control``); ``half_batch`` (training cells): the
reference with half of each checked client's rows left out.  One JSON
line a seed, then the largest and smallest reading of each number.  The
benchmark's own runs never run this.
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


def readings(workload, seed, mode, seconds, device, overrides=None) -> dict:
    from gpubench.lib import cell as C
    from gpubench.lib import spec
    if mode == "program":
        from gpubench.lib.runner import run_cell
        res = run_cell(workload, seed, seconds, False, device,
                       overrides=overrides)
        out = {k: v["value"] for k, v in res["compared"].items()}
        out["correct"] = res["correct"]
        out["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
        return out
    cell = C.build(workload, seed, seconds, False, device,
                   time.perf_counter(), overrides)
    driver = spec.load_driver(cell.workload["driver"])
    return driver.control(cell, mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "half_batch"))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    from gpubench.lib.cell import free
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(args.workload, seed, args.mode, args.seconds, device)
        got.update(seed=seed, seconds=time.perf_counter() - t)
        rows.append(got)
        print(json.dumps(got), flush=True)
        free(device)
    keys = [k for k in rows[0]
            if k not in ("seed", "seconds", "correct", "metrics")]
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
