"""Where a run lives: the checkout's root, its fixed cache directories, the
import path of the program, and the checks a run makes of its process.

:func:`prepare` runs before ``torch`` is imported.  Every compile cache
the program or PyTorch may write goes into a fixed directory under
``build/`` in the checkout (``.gitignore`` lists it), never to a path
made from a temporary name, a process id or the time, so that only the
first run of a cell in a checkout builds.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"
CACHE = ROOT / "build" / "gpubench_cache"

#: whole top-level module names the harness's process may never hold:
#: JAX, its libraries and the JAX package of this repository
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    """Put the checkout and the program's sources on the import path and
    every compile cache into a fixed directory of the checkout.  Libraries
    that would load JAX by themselves are told not to."""
    for path in (str(SRC), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    caches = {"TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
              "TRITON_CACHE_DIR": CACHE / "triton",
              "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor",
              "CUDA_CACHE_PATH": CACHE / "nv"}
    for key, path in caches.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def device_info(device) -> dict:
    """The card's name, the number of cards the run uses and its power
    limit as ``nvidia-smi`` reads it (None where it cannot)."""
    import subprocess

    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1,
                "power_limit": None}
    limit = None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        limit = res.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": limit}
