"""``repro_torch.launch.serve`` on the CPU: the reduced mamba2-1.3b preset
prefills, decodes greedily and prints the reference launcher's
``prefill:`` and ``decode:`` lines; the greedy tokens are the full
forward's argmax; ``--device cuda`` without a card raises; an unknown arch
raises; the MoE and the front-end archs serve.  The default arch, h2o-danube-3-4b, serves from KV
caches of ``prompt_len + new`` slots, its greedy tokens the full forward's
argmax too."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "mamba2-1.3b", "--preset", "reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "20", "--new", "5"]


def test_serve_reduced_on_the_cpu_prints_its_lines(capsys):
    res = serve.main(ARGS)
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill: \d+\.\d\ds", out[0]), out
    assert re.fullmatch(r"decode: 4 steps, \d+\.\d tok/s", out[1]), out
    assert res["tokens"].shape == (2, 5)
    assert res["prefill_logits"].shape == (2, 512)
    assert torch.isfinite(res["logits"]).all()
    ssm = res["caches"][0]["b0"]["ssm"]
    assert ssm.shape == (1, 2, 32, 16, 32) and ssm.device.type == "cpu"


def test_greedy_tokens_are_the_full_forward_argmax():
    """Each generated token is the argmax of the full forward over the
    prompt and the tokens generated before it."""
    res = serve.main(ARGS)
    cfg = get_config("mamba2-1.3b").reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=8)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)), dtype=torch.long)
    seq = torch.cat([prompt, res["tokens"][:, :-1]], 1)
    full, _ = model.forward(params, adapters, {"tokens": seq})
    assert torch.equal(full[:, 19:].argmax(-1), res["tokens"])


def test_serve_default_arch_serves_h2o_danube(capsys):
    res = serve.main(ARGS[2:])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and out[1].startswith(
        "decode: 4 steps, ")
    cfg = get_config("h2o-danube-3-4b").reduced()
    cache = res["caches"][0]["b0"]
    assert set(cache) == {"k", "v"}
    assert cache["k"].shape == (1, 2, 25, cfg.n_kv_heads, cfg.head_dim)
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=8)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)), dtype=torch.long)
    seq = torch.cat([prompt, res["tokens"][:, :-1]], 1)
    full, _ = model.forward(params, adapters, {"tokens": seq})
    assert torch.equal(full[:, 19:].argmax(-1), res["tokens"])


def test_serve_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--preset", "reduced"])


def test_serve_arch_not_ported_raises(capsys):
    """The front-end archs serve with item 19b-iii: phi-3-vision-4.2b's
    greedy tokens are the full forward's argmax over the same patches
    (positions after the 8-patch prefix); an arch the port does not know
    raises ``KeyError``."""
    res = serve.main(["--arch", "phi-3-vision-4.2b", *ARGS[2:]])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and out[1].startswith(
        "decode: 4 steps, ")
    cfg = get_config("phi-3-vision-4.2b").reduced()
    cache = res["caches"][0]["b0"]
    assert cache["k"].shape == (1, 2, 20 + 5 + cfg.n_prefix_tokens,
                                cfg.n_kv_heads, cfg.head_dim)
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=8)
    batch = serve.make_batch(cfg, 2, 20, "cpu")
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], 1)
    full, _ = model.forward(params, adapters, dict(batch, tokens=seq))
    assert torch.equal(full[:, 19:].argmax(-1), res["tokens"])
    with pytest.raises(KeyError):
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b",
                                  "deepseek-v3-671b"])
def test_serve_moe_archs(arch, capsys):
    """``--arch`` takes the three MoE archs: the reduced preset prefills
    and decodes, its greedy tokens the full forward's argmax."""
    res = serve.main(["--arch", arch, *ARGS[2:]])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and out[1].startswith(
        "decode: 4 steps, ")
    cfg = get_config(arch).reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=8)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)), dtype=torch.long)
    seq = torch.cat([prompt, res["tokens"][:, :-1]], 1)
    full, _ = model.forward(params, adapters, {"tokens": seq})
    assert torch.equal(full[:, 19:].argmax(-1), res["tokens"])


def test_serve_runs_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *ARGS],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("prefill: ") and lines[1].startswith(
        "decode: 4 steps, ")
