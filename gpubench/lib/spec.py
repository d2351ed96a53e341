"""The manifest and the files it names, found by name.

``BENCHMARK.json`` at the checkout's root lists configurations, cells and
metrics.  Each configuration is ``gpubench/configs/<config>.json``, each
cell ``gpubench/workloads/<cell>.json`` (its configuration, its traffic
driver and every traffic parameter), each driver
``gpubench/traffic/<driver>.py`` and each per-layer metric's reader
``gpubench/layer_metrics/<metric>.py`` (or, for a metric named
``<family>.<cell kind>``, the family's one reader ``<family>.py``).  A
configuration names its plain reference ``gpubench/reference/<name>.py``
and its operation counts ``gpubench/counts/<name>.py``.  A later cell,
configuration or metric is a new file and a new entry: nothing here names
one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

from .env import ROOT


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_workload(name: str, root: Path = ROOT) -> dict:
    path = root / "gpubench" / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload file {path}")
    return load_json(path)


def load_config(name: str, root: Path = ROOT) -> dict:
    path = root / "gpubench" / "configs" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no configuration file {path}")
    return load_json(path)


def _load_file(kind: str, name: str, root: Path = ROOT):
    path = root / "gpubench" / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path}")
    mod_name = "gpubench_" + kind + "_" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, root: Path = ROOT):
    """The traffic driver ``gpubench/traffic/<name>.py``: a module with
    ``run(cell) -> dict`` and ``control(cell, kind) -> dict``."""
    return _load_file("traffic", name, root)


def load_reader(metric: str, root: Path = ROOT):
    """The reader of a per-layer metric, ``gpubench/layer_metrics/
    <metric>.py``, or else, for ``<family>.<suffix>``, the family's
    ``<family>.py``: a module with ``read(ctx) -> float | None``."""
    name = metric
    if not (root / "gpubench" / "layer_metrics" / f"{metric}.py").is_file():
        name = metric.split(".", 1)[0]
    return _load_file("layer_metrics", name, root)


def _load_package_module(kind: str, name: str):
    path = ROOT / "gpubench" / kind / f"{name}.py"
    if not path.is_file() or not name.isidentifier():
        raise KeyError(f"no {kind} module {path}")
    return importlib.import_module(f"gpubench.{kind}.{name}")


def load_reference(config: dict):
    """The plain reference the configuration names (``"reference"``):
    ``gpubench/reference/<name>.py``, with ``adapter_pairs(tree)``,
    ``loss_and_grad(...)`` and ``last_logits(...)``."""
    return _load_package_module("reference", config["reference"])


def load_count(config: dict, kind: str):
    """The operation count the configuration names for ``kind`` (its
    ``"counts"``, e.g. ``{"train": "lm_train", "prefill": "lm_prefill"}``):
    ``gpubench/counts/<name>.py``."""
    counts = config.get("counts", {})
    if kind not in counts:
        raise KeyError(f"{config['name']} names no {kind!r} count")
    return _load_package_module("counts", counts[kind])


def cell_metrics(manifest: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and the per-layer metrics ``cell`` reports: a metric
    with a ``workloads`` key in the cells it lists; a per-layer metric
    without one in every cell that reports the end-to-end metric it
    moves."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer
