"""BENCHMARK.json and the files it names: the contract's shape, and every
cross-reference (configurations, workloads, drivers, readers)."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from gpubench.lib import env, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = spec.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATHS.match(p) and not p.startswith("/") and ".." not in p
        assert (env.ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32
    for word in m["command"]:
        assert one_line(word) and not word.startswith("/")
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    check = 2 + 14 * 24
    assert check * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


def test_configs_files_and_widths():
    m = MANIFEST
    files = set()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("gpubench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((env.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_workload_cross_references(cell):
    m = MANIFEST
    entry = next(w for w in m["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert one_line(entry["why"])
    wl = spec.load_workload(cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    assert hasattr(spec.load_driver(wl["driver"]), "run")
    assert hasattr(spec.load_driver(wl["driver"]), "control")
    assert spec.load_config(entry["config"])["name"] == entry["config"]
    e2e, per_layer = spec.cell_metrics(m, cell)
    names = {x["name"] for x in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    assert all(x["moves"] in names for x in per_layer)
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())


def test_cells_unique_and_four_chip_share():
    m = MANIFEST
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(CELLS) == len(set(CELLS)) and 1 <= len(CELLS) <= 24
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_metrics_shape():
    m = MANIFEST
    seen = set()
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        for cell in x.get("workloads", []):
            assert cell in CELLS
    assert next(x for x in m["end_to_end"]
                if x["name"] == "setup_s")["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in seen
        seen.add(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
    e2e = {x["name"] for x in m["end_to_end"]}
    layers = {}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and one_line(x["layer"])
        assert hasattr(spec.load_reader(x["name"]), "read")
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
        layers.setdefault(x["layer"].lower(), x["layer"])
        for cell in x.get("workloads", []):
            assert cell in CELLS
            reported = {y["name"] for y in spec.cell_metrics(m, cell)[0]}
            assert x["moves"] in reported


def test_new_workload_is_found_by_name(tmp_path):
    """A later cell is a new workload file and a new manifest entry: the
    loaders find it by name, and no file already there changes."""
    shutil.copytree(env.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "gpubench").rglob("*") if p.is_file()}
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "agg.later-cell",
                           "config": "h2o-danube-3-4b",
                           "traffic": "fedbuff_k5", "chips": 1,
                           "why": "a later cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    wl = dict(spec.load_workload("agg.h2o-danube-3-4b"))
    wl.update(traffic="fedbuff_k5", params={**wl["params"],
                                            "buffer_size": 5})
    (tmp_path / "gpubench" / "workloads" / "agg.later-cell.json"
     ).write_text(json.dumps(wl))
    got = spec.load_workload("agg.later-cell", root=tmp_path)
    assert got["params"]["buffer_size"] == 5
    assert spec.load_driver(got["driver"], root=tmp_path).run
    manifest = spec.load_manifest(tmp_path)
    e2e, per_layer = spec.cell_metrics(manifest, "agg.later-cell")
    assert [x["name"] for x in e2e] == ["setup_s"]
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data
