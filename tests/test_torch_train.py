"""The port's one-device training launcher and what it stands on, against
the JAX package on the CPU:

* ``data.make_lm_dataset`` and ``data.pipeline.epoch_batches`` element for
  element (the same numpy streams), ``device_batches``;
* ``optim.clip_by_global_norm`` and ``lora.policy`` against JAX's;
* one step of ``launch.train``'s loop (``make_step``: the loss, then
  Adam's update of the adapter factors through autograd) against JAX's
  jitted step on the same weights, at F32_TOL (2e-5 of max|want|);
* ``launch.train.main`` at the reduced preset: its lines, the cohort
  upload (one plain ``packed_agg`` call for rbla), the checkpoint restored
  equal to the aggregate, rbla_norm's "saving unaggregated adapters"
  branch, and its refusals;
* ``examples/finetune_lm_torch.py`` and ``examples/serve_lora_torch.py``
  at their smallest sizes.
"""
import importlib.util
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, port_tree

from repro.configs import get_config as jax_get_config
from repro.data import make_lm_dataset as jax_make_lm_dataset
from repro.data.pipeline import epoch_batches as jax_epoch_batches
from repro.lora import attach_ranks as jax_attach_ranks
from repro.lora import policy as jpolicy
from repro.lora import strip_ranks as jax_strip_ranks
from repro.models import transformer as jt
from repro.models.model import make_model as jax_make_model
from repro.optim import adam as jax_adam
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import sgd as jax_sgd
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.data import (device_batches, epoch_batches,
                              make_lm_dataset)
from repro_torch.kernels import runtime
from repro_torch.launch import train
from repro_torch.lora import (POLICIES, apply_policy, filter_specs,
                              strip_ranks)
from repro_torch.models import transformer as tt
from repro_torch.models.model import make_model
from repro_torch.optim import adam, clip_by_global_norm, sgd
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-3-4b"
MAIN = ["--preset", "reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16"]


def _trees_close(got, want, tol, msg):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tree_leaves(got)) == len(flat), msg
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        assert_close(g, w, tol, f"{msg} {jax.tree_util.keystr(path)}")


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("vocab,seq,n,seed,p", [
    (512, 17, 64, 42, 0.9), (32000, 129, 128, 42, 0.9), (7, 5, 3, 0, 0.5)])
def test_make_lm_dataset_matches_jax(vocab, seq, n, seed, p):
    got = make_lm_dataset(vocab, seq, n, seed=seed, p_follow=p)
    want = jax_make_lm_dataset(vocab, seq, n, seed=seed, p_follow=p)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch,seed", [(100, 8, 0), (64, 64, 3),
                                          (5, 2, 42)])
def test_epoch_batches_match_jax(n, batch, seed):
    got = epoch_batches(n, batch, seed)
    np.testing.assert_array_equal(got, jax_epoch_batches(n, batch, seed))
    assert got.shape == (n // batch, batch)


def test_device_batches_yield_the_epoch_on_the_device(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.arange(10, dtype=np.int32)
    got = list(device_batches(x, y, 4, seed=1, device="cpu"))
    order = epoch_batches(10, 4, 1)
    assert len(got) == 2
    for (bx, by), ix in zip(got, order):
        assert bx.device.type == "cpu"
        assert torch.equal(bx, torch.from_numpy(x[ix]))
        assert torch.equal(by, torch.from_numpy(y[ix]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        next(device_batches(x, y, 4, seed=1))


# ------------------------------------------------------------ optimizers --
@pytest.mark.parametrize("max_norm", [0.05, 1e6])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The fp32 global norm over every leaf and the scale min(1, max_norm /
    (norm + 1e-12)) ahead of the wrapped optimizer (clipping in the first
    case, not in the second), over three steps."""
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    jopt, opt = jax_clip(jax_adam(1e-2), max_norm), clip_by_global_norm(
        adam(1e-2), max_norm)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js_, ts_ = jopt.init(jp), opt.init(tp)
    for step in range(3):
        g = {"a": rng.normal(size=(4, 5)).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
        ju, js_ = jopt.update(jax.tree.map(jnp.asarray, g), js_, jp)
        tu, ts_ = opt.update(tree_map(torch.from_numpy, g), ts_, tp)
        jp, tp = jax_apply_updates(jp, ju), tree_map(
            lambda p, u: p + u, tp, tu)
        _trees_close(tu, ju, F32_TOL, f"updates at step {step}")
    sopt, jsopt = clip_by_global_norm(sgd(1.0), 0.5), jax_clip(
        jax_sgd(1.0), 0.5)
    g = tree_map(torch.from_numpy, params)
    u, _ = sopt.update(g, sopt.init(g), None)
    norm = float(torch.sqrt(sum(t.square().sum() for t in tree_leaves(u))))
    assert abs(norm - 0.5) < 1e-5
    ju, _ = jsopt.update(jax.tree.map(jnp.asarray, params),
                         jsopt.init(params), None)
    _trees_close(u, ju, F32_TOL, "sgd clipped")


# ---------------------------------------------------------------- policy --
def test_policies_match_jax():
    """Every named policy and a custom include/exclude over a whisper
    decoder block's LoRA specs, the MLP specs and the paper net's names."""
    cfg = get_config("whisper-large-v3").reduced()
    jcfg = jax_get_config("whisper-large-v3").reduced()
    spec = cfg.stages[0].unit[0]
    specs = {f"stages/0/b0/{k}": v[:2]
             for k, v in tt.block_lora_specs(cfg, spec).items()}
    assert specs == {f"stages/0/b0/{k}": v[:2] for k, v in
                     jt.block_lora_specs(jcfg, jcfg.stages[0].unit[0])
                     .items()}
    specs.update({"fc1": (200, 784), "fc2": (200, 200), "out": (10, 200),
                  "attention/q": (8, 8), "conv": (3, 3)})
    assert POLICIES == jpolicy.POLICIES
    for name in POLICIES:
        got = apply_policy(specs, name)
        assert got == jpolicy.apply_policy(specs, name), name
        assert list(got) == list(jpolicy.apply_policy(specs, name))
    assert apply_policy(specs)["stages/0/b0/mix/xq"] == specs[
        "stages/0/b0/mix/xq"]
    for inc, exc in ((r"mix/x", None), (r".*", r"ffn|fc"), (r"^fc", r"2$")):
        assert filter_specs(specs, inc, exc) == jpolicy.filter_specs(
            specs, inc, exc)
    with pytest.raises(KeyError):
        apply_policy(specs, "no-such-policy")


# ----------------------------------------------------------- the train step --
def test_train_step_matches_jax():
    """Two steps of ``launch.train``'s loop on JAX's weights and adapters
    (a live B) and the launcher's batches: each step's loss and the
    updated factors against JAX's jitted ``value_and_grad`` + Adam step."""
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(9)
    ja = {"stages": tuple(
        {b: {k: dict(v, B=jnp.asarray((rng.normal(size=v["B"].shape) * 0.05)
                                      .astype(np.float32)
                                      * (np.arange(v["B"].shape[-1]) < 4)))
             for k, v in unit.items()} for b, unit in st.items()}
        for st in ja["stages"])}
    jfactors, jranks = jax_strip_ranks(ja)
    jopt = jax_adam(1e-2)
    jstate = jopt.init(jfactors)

    @jax.jit
    def jstep(factors, opt_state, tokens):
        def loss_fn(f):
            return jmodel.loss(jp, jax_attach_ranks(f, jranks),
                               {"tokens": tokens})
        loss, grads = jax.value_and_grad(loss_fn)(factors)
        updates, opt_state = jopt.update(grads, opt_state, factors)
        return jax_apply_updates(factors, updates), opt_state, loss

    cfg = get_config(ARCH).reduced()
    model = make_model(cfg, remat=False)
    factors, ranks = strip_ranks(port_tree(ja))
    opt = adam(1e-2)
    state = opt.init(factors)
    step = train.make_step(model, port_tree(jp), ranks, opt)
    data = make_lm_dataset(cfg.vocab_size, 17, 64, seed=42)
    drng = np.random.default_rng(0)
    for i in range(2):
        tokens = data[drng.integers(0, len(data), 2)]
        jfactors, jstate, jloss = jstep(jfactors, jstate,
                                        jnp.asarray(tokens))
        factors, state, loss = step(factors, state,
                                    torch.as_tensor(tokens).long())
        assert not loss.requires_grad
        assert_close(loss, np.float32(jloss), F32_TOL, f"loss at {i}")
        _trees_close(factors, jax.tree.map(np.asarray, jfactors), F32_TOL,
                     f"factors after step {i}")
    assert all(not t.requires_grad for t in tree_leaves(factors))


# ------------------------------------------------------------ the launcher --
def test_train_main_prints_its_lines_and_saves_the_aggregate(tmp_path,
                                                             capsys):
    ckpt = str(tmp_path / "ckpt")
    runtime.reset_counts()
    res = train.main([*MAIN, "--ckpt", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"step    0 loss \d+\.\d{4} \(\d+\.\d\ds/step\)",
                        out[0]), out
    assert out[1].startswith("step    1 loss ")
    assert out[2] == "aggregated cohort upload via strategy=rbla " \
        "backend=auto"
    assert out[3] == f"saved aggregated adapters to {ckpt}"
    # the cohort upload is one planned round: one plain packed_agg call
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    assert sum(runtime.LAUNCHES.values()) == 0
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    agg, trained = res["adapters"], res["trained"]
    back = restore(ckpt, agg)
    for g, w in zip(tree_leaves(back), tree_leaves(agg), strict=True):
        assert torch.equal(g, w)
    # a cohort of one at r_max = rank: the trained pairs, live rank 8
    for a, t in zip(agg["stages"][0]["b0"].values(),
                    trained["stages"][0]["b0"].values()):
        assert torch.equal(a["rank"], torch.full_like(t["rank"], 8))
        assert_close(a["A"][..., :8, :], t["A"][..., :8, :], F32_TOL, "A")
        assert_close(a["B"][..., :8], t["B"][..., :8], F32_TOL, "B")
        assert float(t["B"].abs().max()) > 0.0


def test_train_main_keeps_unaggregated_adapters_when_rbla_norm_refuses(
        tmp_path, capsys):
    """rbla_norm cannot aggregate layer-stacked pairs: the launcher warns
    and saves the trained adapters, as the reference launcher does."""
    ckpt = str(tmp_path / "ckpt")
    res = train.main([*MAIN, "--steps", "1", "--method", "rbla_norm",
                      "--ckpt", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("WARNING: strategy=rbla_norm cannot aggregate "
                             "this adapter structure (")
    assert out[1].endswith("); saving unaggregated adapters")
    assert res["adapters"] is res["trained"]
    back = restore(ckpt, res["trained"])
    for g, w in zip(tree_leaves(back), tree_leaves(res["trained"])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", ["ref", "distributed"])
def test_train_main_agg_backends_agree(backend, capsys):
    """The other CPU backends give the auto round's aggregate
    (``distributed`` without a process group reduces over this process
    alone); ``kernel`` and its alias ``pallas`` need CUDA tensors."""
    want = train.main([*MAIN, "--steps", "1"])["adapters"]
    got = train.main([*MAIN, "--steps", "1", "--agg-backend",
                      backend])["adapters"]
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"aggregated cohort upload via strategy=rbla backend={backend}")
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert_close(g, w, F32_TOL, backend)
    for alias in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            train.main([*MAIN, "--steps", "1", "--agg-backend", alias])


def test_train_main_trains_a_mamba_model_through_the_plain_scan(
        monkeypatch, capsys):
    """The ssd_scan kernel has no backward, so the launcher builds its
    model with scan_backend="ref": mamba2-1.3b trains and uploads."""
    built = []

    def spy(cfg, **kw):
        built.append(kw)
        return make_model(cfg, **kw)
    monkeypatch.setattr(train, "make_model", spy)
    runtime.reset_counts()
    res = train.main(["--arch", "mamba2-1.3b", *MAIN])
    assert [kw["scan_backend"] for kw in built] == ["ref"]
    assert capsys.readouterr().out.splitlines()[-1] == (
        "aggregated cohort upload via strategy=rbla backend=auto")
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["cfg"].name == "mamba2-1.3b"
    for g, w in zip(tree_leaves(res["adapters"]),
                    tree_leaves(res["trained"]), strict=True):
        if w.is_floating_point():
            assert_close(g, w, F32_TOL, "a cohort of one")
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("phi-3-vision-4.2b", "patches")])
def test_train_main_front_end_archs_need_their_inputs(arch, key):
    """The batch holds tokens only, as in the reference launcher, so an
    encoder-decoder or a VLM fails for its missing input."""
    with pytest.raises(KeyError, match=key):
        train.main(["--arch", arch, *MAIN, "--steps", "1"])


def test_train_main_refusals(monkeypatch):
    """``--multi-pod`` takes the (2, 16, 16) production mesh, which raises
    without a world of 512 ranks, as the reference's does without 512
    devices (before any weight is built); a typo in ``--method`` and a
    missing card raise too."""
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        train.main(["--preset", "full", "--device", "cpu", "--multi-pod",
                    "--steps", "1"])
    with pytest.raises(ValueError, match="unknown aggregation strategy"):
        train.main([*MAIN, "--method", "no-such-method"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--preset", "reduced", "--steps", "1"])


# ------------------------------------------------------- on a test mesh --
CHILD = ROOT / "tests" / "_dist_child.py"
CHILD_TIMEOUT = 120            # seconds, each rank of a spawned world
MESH_KW = dict(steps=2, batch=4, seq=16, rank=4)


def _spawn(cases, world, tmp):
    """``world`` gloo ranks of ``tests/_dist_child.py`` over ``cases`` (a
    ``FileStore`` under ``tmp``); each rank's result arrays."""
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), str(inputs), str(tmp / "store"),
         str(k), str(world), str(tmp / f"out{k}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)]
    errs = []
    try:
        for k, p in enumerate(procs):
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                errs.append(f"rank {k} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)
    return [dict(np.load(tmp / f"out{k}.npz")) for k in range(world)]


def _flat_np(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_np(v, f"{prefix}|{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat_np(v, f"{prefix}|{i}", out)
    else:
        out[prefix] = tree.detach().float().numpy()
    return out


MESH_ARCHS = (ARCH, "granite-moe-3b-a800m", "mamba2-1.3b")


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """4 gloo ranks spawned once, each running ``launch.train.train`` for
    every arch of MESH_ARCHS on a (2, 2) mesh."""
    cases = [dict(name=arch, kind="train", arch=arch, mesh=[2, 2],
                  kw=MESH_KW) for arch in MESH_ARCHS]
    return _spawn(cases, 4, tmp_path_factory.mktemp("mesh_train"))


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_train_on_a_2x2_gloo_world_matches_one_device(arch, mesh_world):
    """``launch.train.train`` on a (2, 2) ("data", "model") mesh of 4
    spawned gloo ranks: the weights placed by the rules (q/k/v/gate/up
    column- and o/down row-parallel over "model", granite's experts and
    their adapters by expert, mamba's scan on its heads), the factors and
    the Adam state replicated, each batch split over "data".  On every
    rank, 2 steps' losses, the trained adapters and the upload equal the
    one-device run's within 2e-5 of max|want|."""
    want = train.train(get_config(arch).reduced(), None, device="cpu",
                       **MESH_KW)
    flat = _flat_np({"trained": want["trained"],
                     "adapters": want["adapters"]}, arch, {})
    assert len(flat) > 10
    for rank, arrays in enumerate(mesh_world):
        got = {k: v for k, v in arrays.items()
               if k.split("|")[0] == arch}
        assert_close(got[f"{arch}|losses"], np.asarray(want["losses"]),
                     F32_TOL, f"losses on rank {rank}")
        assert set(got) == set(flat) | {f"{arch}|losses"}
        for key, w in flat.items():
            assert_close(got[key], w, F32_TOL, f"{key} on rank {rank}")


# ------------------------------------------------------------- examples --
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_finetune_lm_example_runs_at_its_smallest_size(capsys):
    ex = _example("finetune_lm_torch")
    res = ex.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16", "--rank", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model lm-15m: ")
    assert out[-1].startswith("finished 3 steps in ")
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert ex.make_cfg("15m").n_layers == 4


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-large-v3",
                                  "phi-3-vision-4.2b"])
def test_serve_lora_example_runs_at_its_smallest_size(arch, capsys):
    ex = _example("serve_lora_torch")
    gen = ex.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                   "--prompt-len", "8", "--new", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 8 tokens x2: ")
    assert out[-1].startswith("generated token ids (seq 0): ")
    assert gen.shape == (2, 3)
    cfg = get_config(arch).reduced()
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all())


def test_heterogeneous_ranks_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/heterogeneous_ranks_torch.py --device cpu``: Alg. 2's live
    rows, zero-padding and RBLA against JAX's leaves on the same cohort,
    FLoRA's stacked ranks (10, 20, then 8 under the cap) and its exact
    mean update, and the rbla aggregate over 8 spawned gloo ranks equal to
    the host's (the example holds it at rtol 1e-5, atol 1e-6)."""
    import importlib

    from repro.core import rbla_leaf as jax_rbla_leaf
    from repro.core import zeropad_leaf as jax_zeropad_leaf
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    ex = importlib.import_module("heterogeneous_ranks_torch")
    res = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "matches the host result" in out
    assert res["live_rows"] == {2: 2, 5: 5, 8: 8}
    stacked, masks = res["stacked"].numpy(), res["masks"].numpy()
    w = jnp.ones(stacked.shape[0])
    assert_close(res["zp"], jax_zeropad_leaf(jnp.asarray(stacked),
                                             jnp.asarray(masks), w),
                 F32_TOL, "zeropad")
    assert_close(res["rbla"], jax_rbla_leaf(jnp.asarray(stacked),
                                            jnp.asarray(masks), w),
                 F32_TOL, "rbla")
    assert (res["flora_rank"], res["next_rank"], res["capped_rank"]) == \
        (10, 20, 8)
    assert res["flora_diff"] < 1e-6 and res["flora_launches"] == {}
    assert_close(res["collective"], res["rbla"], F32_TOL, "collective")
