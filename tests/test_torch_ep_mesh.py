"""``moe_mode="ep_a2a"`` on a mesh of DTensors (``models/moe_ep.py``,
``moe_forward_ep_on_mesh``) against the JAX package's
``moe_forward_ep_wrapped`` under a mesh, on the CPU.

A (data 2, model 2) world of 4 gloo ranks (``tests/_dist_child.py``, spawned
once on a ``FileStore``, 120 s a rank; no process group in a pytest worker)
runs the block's MoE call for reduced granite-moe-3b-a800m and
deepseek-v3-671b (its shared expert too) on DTensors placed by the sharding
rules, the ``experts/*`` factors by expert over "model"; a JAX process of
its own (``tests/_ep_mesh_jax.py``, 4 host devices) runs the reference on
the same (2, 2) mesh.  Every rank's output, loss <y, cotangent> and
gradient w.r.t. every LoRA factor equal JAX's within F32_TOL (2e-5 of
max|want|), after two all-to-alls in the forward.  Parameters come
from JAX's initialisers, inputs are numpy from a seed.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_parity import F32_TOL, assert_close

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.lora import init_pair as jax_init_pair
from repro.models import moe as jmoe
from repro.models import transformer as jt

TESTS = Path(__file__).resolve().parent
CHILD, JAX_CHILD = TESTS / "_dist_child.py", TESTS / "_ep_mesh_jax.py"
CHILD_TIMEOUT = 120            # seconds, each process
ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")
MESH = (2, 2)
BATCH, SEQ = 8, 8


def _lora(jcfg, seed, rank=5, r_max=8):
    """The MoE block's LoRA pairs, each with a live B (expert pairs ``(E,
    r, in)`` / ``(E, out, r)``, the shared expert's ``(r, in)``)."""
    specs = jt.block_lora_specs(jcfg, JBlockSpec(kind="gqa", ffn="moe"))
    rng = np.random.default_rng(seed)
    out = {}
    for i, (path, (fo, fi, extra)) in enumerate(sorted(specs.items())):
        if not path.startswith("ffn/"):
            continue
        pair = jax_init_pair(jax.random.PRNGKey(seed * 100 + i), fo, fi,
                             r_max, rank, leading=(1,) + extra)
        pair = jax.tree.map(lambda t: np.asarray(t[0]), pair)
        live = (np.arange(r_max) < rank).astype(np.float32)
        pair["B"] = ((rng.normal(size=pair["B"].shape) * 0.05)
                     .astype(np.float32) * live)
        out[path[len("ffn/"):]] = pair
    return out


def _case(arch, seed):
    jcfg = jax_get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    return dict(name=arch, kind="moe_ep_dtensor", arch=arch, overrides={},
                mesh=list(MESH),
                params=jax.tree.map(np.asarray, jmoe.moe_init(
                    jax.random.PRNGKey(seed), jcfg)),
                lora=_lora(jcfg, seed),
                x=rng.normal(size=(BATCH, SEQ, jcfg.d_model)).astype(
                    np.float32),
                cotangent=rng.normal(size=(BATCH, SEQ, jcfg.d_model))
                .astype(np.float32))


def _wait(procs, names):
    errs = []
    try:
        for name, p in zip(names, procs):
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                errs.append(f"{name} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)


@pytest.fixture(scope="module")
def ep_mesh(tmp_path_factory):
    """The port's 4-rank world and JAX's 4-device process, run at once."""
    tmp = tmp_path_factory.mktemp("ep_mesh")
    cases = [_case(arch, 3 + i) for i, arch in enumerate(ARCHS)]
    bad = dict(cases[0], name="bad_batch", x=cases[0]["x"][:6],
               cotangent=cases[0]["cotangent"][:6],
               expect_raise="does not split")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(cases + [bad], f)
    with open(tmp / "jax_inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    world = 4
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), str(tmp / "inputs.pkl"),
         str(tmp / "store"), str(k), str(world), str(tmp / f"out{k}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)]
    procs.append(subprocess.Popen(
        [sys.executable, str(JAX_CHILD), str(tmp / "jax_inputs.pkl"),
         str(tmp / "jax_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    _wait(procs, [f"rank {k}" for k in range(world)] + ["the JAX process"])
    outs = []
    for k in range(world):
        with open(tmp / f"out{k}.npz.meta", "rb") as f:
            meta = pickle.load(f)
        outs.append((dict(np.load(tmp / f"out{k}.npz")), meta))
    with open(tmp / "jax_out.pkl", "rb") as f:
        return outs, pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_a2a_on_a_2x2_mesh_matches_jax(ep_mesh, arch):
    """Every rank's output and loss equal JAX's ``moe_forward_ep_wrapped``
    on its (2, 2) mesh, after one ``all_to_all`` each way in the
    forward."""
    outs, wants = ep_mesh
    want = wants[arch]
    for rank, (arrays, _) in enumerate(outs):
        assert_close(arrays[f"{arch}|y"], want["y"], F32_TOL,
                     f"{arch} y on rank {rank}")
        assert_close(arrays[f"{arch}|loss"], want["loss"], F32_TOL,
                     f"{arch} loss on rank {rank}")
        assert int(arrays[f"{arch}|fwd_all_to_all"]) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_a2a_on_a_2x2_mesh_adapter_gradient_matches_jax(ep_mesh, arch):
    """The gradient w.r.t. every LoRA factor (the experts' by expert over
    "model", deepseek's shared expert's whole) equals JAX's on every rank;
    the backward adds one ``all_to_all``, the return trip's (the factors'
    gradient needs nothing from before the dispatch)."""
    outs, wants = ep_mesh
    want = wants[arch]["grad"]
    assert any(k.startswith("experts/") for k in want)
    for rank, (arrays, meta) in enumerate(outs):
        for k, pair in want.items():
            for f in ("A", "B"):
                assert_close(arrays[f"{arch}|grad|{k}|{f}"], pair[f],
                             F32_TOL, f"{arch} d{k}/{f} on rank {rank}")
        assert meta[arch]["collectives"]["all_to_all"] == 3, meta[arch]


def test_ep_a2a_on_a_mesh_refuses_a_batch_that_does_not_split(ep_mesh):
    """A batch of 6 over the (2, 2) mesh's 4 ranks raises, as the
    reference's ``shard_map`` refuses it."""
    outs, _ = ep_mesh
    for arrays, _ in outs:
        assert int(arrays["bad_batch|raised"]) == 1

