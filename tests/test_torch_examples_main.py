"""The main path's examples on the PyTorch port, on the CPU at their
smallest size: ``examples/quickstart_torch.py`` (the paper's MNIST MLP, 10
staircase clients at ranks 6-64, rbla) and ``examples/paper_repro_torch.py``
(rbla, zeropad and fft), each with ``--device cpu``.  The accuracies each
prints equal ``repro_torch.fl.run_simulation``'s for the same
configuration, and both configurations are the JAX examples' own."""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

from repro_torch.fl import FLConfig, run_simulation

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--rounds", "2", "--n-per-class", "20"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _round_accs(out: str, method: str) -> list[float]:
    return [float(a) for a in re.findall(
        rf"\[\s*{method}\] round\s+\d+ acc=([0-9.]+)", out)]


def _reference_cfg(path: str, name: str):
    """The module-level FLConfig of a JAX example, read without running
    it (its imports are the JAX package's)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.pop(name, None)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_run_simulations_accuracies(capsys):
    ex = _example("quickstart_torch")
    hist = ex.main(["--device", "cpu", *SMALL, "--n-test-per-class", "10"])
    out = capsys.readouterr().out
    want = run_simulation(ex.make_cfg(2, 20, 10), device="cpu")
    assert _round_accs(out, "rbla") == [round(a, 4) for a in want.test_acc]
    last = out.strip().splitlines()[-1]
    assert last == "per-round test accuracy: " + " ".join(
        f"{a:.3f}" for a in want.test_acc)
    assert hist.test_acc == want.test_acc


def test_quickstart_config_is_the_references():
    import dataclasses
    ref = _reference_cfg("examples/quickstart.py", "quickstart_ref").cfg
    got = _example("quickstart_torch").cfg
    assert dataclasses.asdict(got).items() >= {
        k: v for k, v in dataclasses.asdict(ref).items()
        if k in dataclasses.asdict(got)}.items()


@pytest.mark.parametrize("method", ["rbla", "zeropad", "fft"])
def test_paper_repro_prints_run_simulations_accuracies(method, capsys):
    ex = _example("paper_repro_torch")
    res = ex.main(["--device", "cpu", "--methods", method, *SMALL,
                   "--target", "0.05"])
    out = capsys.readouterr().out
    want = run_simulation(ex.make_cfg(method, rounds=2, n_per_class=20),
                          device="cpu")
    assert _round_accs(out, method) == [round(a, 4) for a in want.test_acc]
    assert res[method]["test_acc"] == want.test_acc
    assert res[method]["best"] == max(want.test_acc)
    assert res[method]["rounds_to_target"] == want.rounds_to_target(0.05)
    assert f"  {method:>10s}: {max(want.test_acc):.4f}" in out
    assert "rounds to reach 5% (mnist/mlp, participation=1.0):" in out


def test_paper_repro_config_is_the_references():
    ex = _example("paper_repro_torch")
    cfg = ex.make_cfg("rbla")
    assert isinstance(cfg, FLConfig)
    assert (cfg.rounds, cfg.n_per_class, cfg.n_test_per_class,
            cfg.local_epochs, cfg.optimizer, cfg.lr, cfg.seed) == (
        30, 400, 100, 2, "sgd", 0.05, 42)
    cifar = ex.make_cfg("rbla", dataset="cifar", model="cnn_cifar")
    assert (cifar.optimizer, cifar.lr) == ("adam", 1e-3)
