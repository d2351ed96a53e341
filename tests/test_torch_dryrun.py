"""The port's dry run (``repro_torch.launch.dryrun``), the twin of
``tests/test_distributed.py::test_dryrun_small_mesh_lowers``.

Each case runs in a spawned ``tests/_dryrun_child.py`` (one spawn for the
module): the dry run starts a fake process group of its mesh's size, which
no pytest worker may.  On the CPU, no card:

* a reduced granite-moe (vocab 512, 4 experts top-2) on a (2, 2) fake
  world traces its train and decode steps, and its records hold the
  reference's keys;
* a reduced dense arch's per-device flops on a (1, 2) model mesh lie
  between half and all of its (1, 1) flops, and a (2, 2) mesh halves the
  (1, 2) flops (the batch split over "data"); (1, 1) records no collective
  and (1, 2) records some;
* a reduced mamba2 prefill's flops include the ``ssd_scan`` op's formula,
  once a layer on the rank's heads;
* the trace sees every layer: 1, 2 and 3 units of a reduced model add the
  same flops a unit (the reference's ``scan_correction`` is recorded and
  applied as 1.0);
* the long_500k skip rule holds.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


def _reference_skip_reason():
    """The reference's ``skip_reason``, read from its source: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices for the
    rest of the process, which would change every later JAX test in this
    worker."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "skip_reason")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["skip_reason"]


jax_skip_reason = _reference_skip_reason()
CHILD = ROOT / "tests" / "_dryrun_child.py"
CHILD_TIMEOUT = 300
CASES = ("granite_2x2", "dense_meshes", "mamba_prefill", "units", "skip")
#: the keys of the reference's records (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "kind", "remat", "fsdp",
            "mla_absorbed", "tag", "cfg_overrides", "lower_s", "compile_s",
            "flops_per_device", "bytes_per_device", "memory_analysis",
            "collectives", "scan_correction", "roofline"}
ROOF_KEYS = {"flops_per_device", "hbm_bytes_per_device",
             "collective_bytes_per_device", "collectives", "chips",
             "compute_s", "memory_s", "collective_s", "dominant",
             "model_flops", "useful_flops_ratio"}


def spawn_dryrun(tmp, cases):
    """Run ``cases`` in one ``tests/_dryrun_child.py`` process; their
    results."""
    out = tmp / "out.json"
    res = subprocess.run(
        [sys.executable, str(CHILD), str(out), *cases],
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return spawn_dryrun(tmp, CASES), tmp


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_small_mesh_traces(kind, runs):
    rec = runs[0]["granite_2x2"][kind]
    assert REF_KEYS <= set(rec), REF_KEYS - set(rec)
    assert set(rec["roofline"]) == ROOF_KEYS
    assert rec["mesh"] == "2x2" and rec["kind"] == kind
    assert rec["roofline"]["chips"] == 4
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collectives"], "a (2, 2) mesh moves data"
    assert rec["compile_s"] == 0.0 and rec["scan_correction_applied"] == 1.0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] \
        is None
    on_disk = runs[1] / "records" / f"granite-moe-3b-a800m_{rec['shape']}_2x2.json"
    with open(on_disk) as f:
        assert json.load(f) == rec


def test_dryrun_model_mesh_splits_the_flops(runs):
    recs = runs[0]["dense_meshes"]
    one, two, four = (recs[m]["flops_per_device"]
                      for m in ("1x1", "1x2", "2x2"))
    assert one / 2 <= two <= one
    assert four == pytest.approx(two / 2)
    assert recs["1x1"]["collectives"] == {}
    assert recs["1x2"]["collectives"] and all(
        v > 0 for v in recs["1x2"]["collectives"].values())
    assert set(recs["1x2"]["collectives"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_dryrun_mamba_prefill_counts_the_kernels_formula(runs):
    got = runs[0]["mamba_prefill"]
    by_op = got["rec"]["flops_by_op"]
    assert by_op["repro_torch.ssd_scan"] == (got["layers"]
                                             * got["formula_per_layer"])
    assert got["rec"]["flops_per_device"] > by_op["repro_torch.ssd_scan"]


def test_dryrun_sees_every_layer(runs):
    """The reference scales XLA CPU's flops by ``scan_correction`` (a
    scanned stack counted once); the port's trace counts each unit: the
    units' flops grow by one unit's each time and two units' layer term is
    twice one unit's."""
    f1, f2, f3 = runs[0]["units"]["flops"]
    assert f3 - f2 == f2 - f1 > 0
    head = f1 - (f2 - f1)
    assert f2 - head == 2 * (f1 - head)


def test_dryrun_skip_rule(runs):
    got = runs[0]["skip"]
    assert got["yi"]["skipped"] == jax_skip_reason(
        jax_get_config("yi-34b"), JAX_SHAPES["long_500k"])
    assert "roofline" not in got["yi"]
    assert got["mamba_reason"] is None


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skip_reason_matches_jax(arch, shape):
    assert dryrun.skip_reason(get_config(arch), INPUT_SHAPES[shape]) == \
        jax_skip_reason(jax_get_config(arch), JAX_SHAPES[shape])


def test_dryrun_cli_matches_the_reference(monkeypatch):
    """The reference's options, each accepted and handed to ``run_one``
    (parsing only)."""
    seen = {}

    def fake_run_one(*a, **kw):
        seen.update(kw, args=a)
        return {}
    monkeypatch.setattr(dryrun, "run_one", fake_run_one)
    dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--mesh",
                 "pod2", "--out", "/nonexistent", "--no-remat",
                 "--cache-seq-shard", "--mla-absorbed", "--fsdp", "--tag",
                 "x", "--set", "capacity_factor=1.0,n_experts=48"])
    assert seen["args"] == ("yi-34b", "train_4k", True, "/nonexistent")
    assert seen["remat"] is False and seen["fsdp"] and seen["mla_absorbed"]
    assert seen["seq_shard_model"] and seen["tag"] == "x"
    assert seen["cfg_overrides"] == {"capacity_factor": 1.0,
                                     "n_experts": 48}
