"""Each cell driven end to end on the CPU at tiny widths, past the run's
look for a card: a sound run comes out ``correct``; the timed path broken
underneath (a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced, an aggregation that
goes stale after the first round) and the reference put in the program's
place at the precision below the configuration's (the control) come out
not correct.  A cell of existing traffic on another configuration is
files alone."""
from __future__ import annotations

import json
import math
import shutil

import pytest
import torch

from gpubench.lib import cell as C
from gpubench.lib import env, spec
from gpubench.lib.runner import run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234567
# fp32 at tiny widths: the program then agrees with the reference far
# inside every limit, which the bf16 rounding of the cells' full depth sets
DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "dtype": "float32"}
TINY = {
    "agg.h2o-danube-3-4b": {
        "arch": DENSE,
        "params": {"ranks": [2, 4, 8], "clients_per_rank": 2, "r_max": 8,
                   "buffer_size": 4, "check_span": 6, "trace_flushes": 2,
                   "max_submits": 20000, "warm_flushes": 1}},
    "train.h2o-danube-3-4b": {
        "arch": {**DENSE, "window": 16},
        "params": {"ranks": [2, 4, 8], "r_max": 8, "batch": 2, "seq": 32,
                   "token_rounds": 4}},
    "train.mamba2-1.3b": {
        "arch": {"n_layers": 2, "d_model": 64, "vocab_size": 256,
                 "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": 16,
                 "dtype": "float32"},
        "params": {"ranks": [2, 4, 8], "r_max": 8, "batch": 2, "seq": 32,
                   "token_rounds": 4}},
    "prefill.mamba2-1.3b": {
        "arch": {"n_layers": 8, "d_model": 64, "vocab_size": 256,
                 "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": 16,
                 "dtype": "float32"},
        "params": {"batch": 2, "seq": 64, "r_max": 8, "adapter_rank": 8,
                   "check_span": 4, "trace_calls": 1, "warm_calls": 1}},
}
CELLS = sorted(TINY)


def run(cell, trace=False, seconds=0.3):
    return run_cell(cell, SEED, seconds, trace, CPU, overrides=TINY[cell])


def over_limit(cell, readings) -> bool:
    limits = spec.load_workload(cell)["limits"]
    return any(not math.isfinite(v) or v > limits[k]
               for k, v in readings.items() if k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = spec.cell_metrics(spec.load_manifest(), cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_host_metrics(cell):
    res = run(cell, trace=True)
    assert res["correct"]
    assert "window_s" in res["device"] and "breakdown" in res
    _, per_layer = spec.cell_metrics(spec.load_manifest(), cell)
    # a CPU run reads no device share: only spans and counters remain
    names = {m["name"] for m in per_layer}
    assert set(res["metrics"]) <= names
    for m in per_layer:
        if m["source"] == "device_trace" or "mfu" in m["name"]:
            assert m["name"] not in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    c = C.build(cell, SEED, 0.3, False, CPU, 0.0, TINY[cell])
    readings = spec.load_driver(c.workload["driver"]).control(c, "control")
    assert over_limit(cell, readings), readings


@pytest.mark.parametrize("cell", ["train.h2o-danube-3-4b",
                                  "train.mamba2-1.3b"])
def test_half_batch_reference_comes_out_not_correct(cell):
    c = C.build(cell, SEED, 0.3, False, CPU, 0.0, TINY[cell])
    readings = spec.load_driver("cohort_train").control(c, "half_batch")
    assert over_limit(cell, readings), readings


# ------------------------------------------------- faults in the program --
def _agg_fault(kind):
    from repro_torch.core.strategy import AggregationStrategy
    plain = AggregationStrategy.aggregate

    def broken(self, state, updates, weights=None, **kw):
        updates = list(updates)
        if kind == "unchanged":
            out = plain(self, state, updates, weights, **kw)
            out.adapters = state.adapters
            return out
        if kind == "half_batch":
            half = len(updates) // 2
            return plain(self, state, updates[:half],
                         None if weights is None else weights[:half], **kw)
        out = plain(self, state, updates, weights, **kw)
        leaf = next(iter(_pairs(out.adapters)))["A"]
        leaf.view(-1)[0] += 1e-2 * leaf.abs().max()
        return out
    return AggregationStrategy, "aggregate", broken


def _pairs(tree):
    if isinstance(tree, dict) and "A" in tree:
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _pairs(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _pairs(v)


def _train_fault(kind):
    import repro_torch.launch.train as train
    plain = train.make_step

    def make_step(model, params, ranks, opt):
        step = plain(model, params, ranks, opt)

        def broken(factors, opt_state, tokens):
            if kind == "half_batch":
                return step(factors, opt_state, tokens[: tokens.shape[0] // 2])
            new, st, loss = step(factors, opt_state, tokens)
            if kind == "unchanged":
                return factors, st, loss
            # the update altered where it is made: 5% too long
            from repro_torch.tree import tree_map
            return tree_map(lambda f, n: f + 1.05 * (n - f), factors,
                            new), st, loss
        return broken
    return train, "make_step", make_step


def _stale_round_fault(kind):
    """Every aggregation after the first hands back the global it was
    given: round 0, in set-up, is sound; the window's rounds are not."""
    from repro_torch.core.strategy import AggregationStrategy
    plain = AggregationStrategy.aggregate_adapters
    calls = [0]

    def broken(self, client_adapters, weights, **kw):
        calls[0] += 1
        out = plain(self, client_adapters, weights, **kw)
        return out if calls[0] == 1 else kw["prev_global"]
    return AggregationStrategy, "aggregate_adapters", broken


def _prefill_fault(kind):
    from repro_torch.models.model import Model
    plain = Model.prefill

    def prefill(self, params, adapters, batch, capacity=None):
        logits, caches = plain(self, params, adapters, batch, capacity)
        return torch.cat([logits[-1:], logits[1:]]), caches
    return Model, "prefill", prefill


FAULTS = [("agg.h2o-danube-3-4b", _agg_fault, k)
          for k in ("unchanged", "half_batch", "altered")] + \
         [(c, _train_fault, k)
          for c in ("train.h2o-danube-3-4b", "train.mamba2-1.3b")
          for k in ("unchanged", "half_batch", "altered")] + \
         [(c, _stale_round_fault, "stale_after_first_round")
          for c in ("train.h2o-danube-3-4b", "train.mamba2-1.3b")] + \
         [("prefill.mamba2-1.3b", _prefill_fault, "altered")]


@pytest.mark.parametrize("cell,fault,kind", FAULTS,
                         ids=[f"{c}-{k}" for c, _, k in FAULTS])
def test_broken_timed_path_comes_out_not_correct(monkeypatch, cell, fault,
                                                 kind):
    owner, name, broken = fault(kind)
    monkeypatch.setattr(owner, name, broken)
    res = run(cell)
    assert not res["correct"], res["compared"]


# ------------------------------------------- a later cell, files alone --
def test_prefill_cell_on_the_dense_config_is_files_alone(tmp_path,
                                                         monkeypatch):
    """A prefill cell on h2o-danube-3-4b is a workload file and manifest
    entries: the driver takes the reference and the count the
    configuration names, the run is correct, an altered answer is not, and
    no file already there changes."""
    shutil.copytree(env.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "gpubench").rglob("*") if p.is_file()}
    name = "prefill.h2o-danube-3-4b"
    m = spec.load_manifest()
    m["workloads"].append({"name": name, "config": "h2o-danube-3-4b",
                           "traffic": "prefill_8x2048_closed", "chips": 1,
                           "why": "a later cell"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "prefill.mamba2-1.3b" in x.get("workloads", []):
            x["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    wl = dict(spec.load_workload("prefill.mamba2-1.3b"),
              config="h2o-danube-3-4b")
    (tmp_path / "gpubench" / "workloads" / f"{name}.json").write_text(
        json.dumps(wl))
    over = {"arch": DENSE, "params": TINY["prefill.mamba2-1.3b"]["params"]}
    res = run_cell(name, SEED, 0.3, False, CPU, overrides=over,
                   root=tmp_path)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    traced = run_cell(name, SEED, 0.3, True, CPU, overrides=over,
                      root=tmp_path)
    assert traced["correct"] and "breakdown" in traced
    owner, attr, broken = _prefill_fault("altered")
    monkeypatch.setattr(owner, attr, broken)
    bad = run_cell(name, SEED, 0.3, False, CPU, overrides=over,
                   root=tmp_path)
    assert not bad["correct"], bad["compared"]
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data
