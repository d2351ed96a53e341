"""The port's mixture-of-experts (``models/moe.py``, ``models/moe_ep.py``)
against the JAX package on the CPU, at reduced fp32 configs:

* ``route``, ``expert_dense`` and ``moe_forward`` against JAX's, with and
  without per-expert LoRA (a live B), with shared experts (deepseek's),
  padded experts, drops at ``capacity_factor=1.25`` (a router that sends
  every token to one expert) and several group counts; ``ep_hint`` is the
  sort path; ``moe_init`` and the MoE LoRA specs have JAX's layout;
* the expert-parallel path: without a process group a world of one (the
  sort path with one group, no collective), and a twin of
  ``tests/test_distributed.py::test_moe_ep_a2a_matches_pjit_path``: 8
  spawned gloo ranks (``tests/_dist_child.py`` on a ``FileStore``, 120 s
  a rank) on a (data 2, model 4) mesh against JAX's ``moe_forward(
  n_groups=8)`` (and its gradient w.r.t. the params, the LoRA factors
  and x, whole on every rank), and a whole gqa+MoE block with
  ``moe_mode="ep_a2a"`` on the default 8-rank model mesh against JAX's
  sort-path block;
* the paper's aggregation over the new family's expert pairs:
  ``aggregate_adapters(method="rbla")`` over three clients' reduced
  granite and deepseek adapters (ranks 2, 5, 8), the port's ``ref`` and
  ``auto`` backends against JAX's ``ref`` and interpreted ``pallas``.

Parameters come from the JAX initialisers through ``repro_torch.bridge``,
inputs are numpy from a seed; tolerance F32_TOL (2e-5 of max|want|).  No
process group is initialised in a pytest worker.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, assert_trees_close, port_tree

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.core import strategy as js
from repro.lora import init_pair as jax_init_pair
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import BlockSpec, get_config
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_ep
from repro_torch.models import transformer as tt

GRANITE, DEEPSEEK, JAMBA = ("granite-moe-3b-a800m", "deepseek-v3-671b",
                            "jamba-1.5-large-398b")
CHILD = Path(__file__).resolve().parent / "_dist_child.py"
CHILD_TIMEOUT = 120            # seconds, each rank of a spawned world


def _cfgs(arch=GRANITE, **over):
    return get_config(arch).reduced(**over), jax_get_config(arch).reduced(
        **over)


def _lora(jcfg, seed, rank=5, r_max=8):
    """The MoE block's LoRA pairs (JAX), each with a live B: expert pairs
    ``(E, r, in)`` / ``(E, out, r)`` and a scalar rank, as one layer of a
    stage sees them."""
    specs = jt.block_lora_specs(jcfg, JBlockSpec(kind="gqa", ffn="moe"))
    rng = np.random.default_rng(seed)
    out = {}
    for i, (path, (fo, fi, extra)) in enumerate(sorted(specs.items())):
        if not path.startswith("ffn/"):
            continue
        pair = jax_init_pair(jax.random.PRNGKey(seed * 100 + i), fo, fi,
                             r_max, rank, leading=(1,) + extra)
        pair = jax.tree.map(lambda t: t[0], pair)
        live = (np.arange(r_max) < rank).astype(np.float32)
        b = (rng.normal(size=pair["B"].shape) * 0.05).astype(np.float32)
        out[path[len("ffn/"):]] = dict(pair, B=jnp.asarray(b * live))
    return out


#: JAX's moe_forward, compiled (the config is a frozen, hashable dataclass)
_jax_moe = jax.jit(jmoe.moe_forward, static_argnums=(3,),
                   static_argnames=("n_groups",))


def _x(d, shape=(2, 16), seed=0, offset=0.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape + (d,))
                      + offset, np.float32)


def _layout(tree, path=""):
    """{path: (shape, dtype name)} of a port or JAX tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


# ---------------------------------------------------------------- pieces --
def test_route_matches_jax():
    cfg, jcfg = _cfgs(experts_per_token=3, n_experts=6)
    logits = np.random.default_rng(1).normal(size=(4, 7, 6)).astype(
        np.float32)
    w, ix = tmoe.route(cfg, torch.from_numpy(logits))
    jw, jix = jmoe._route(jcfg, jnp.asarray(logits))
    assert np.array_equal(ix.numpy(), np.asarray(jix))
    assert_close(w, jw, F32_TOL, "routing weights")


@pytest.mark.parametrize("with_lora", [False, True])
def test_expert_dense_matches_jax(with_lora):
    _, jcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 5, 256)).astype(np.float32)
    w = rng.normal(size=(4, 256, 128)).astype(np.float32) * 0.05
    pair = _lora(jcfg, 3)["experts/gate"] if with_lora else None
    got = tmoe.expert_dense(torch.from_numpy(w), torch.from_numpy(x),
                            port_tree(pair) if pair else None)
    want = jmoe.expert_dense(jnp.asarray(w), jnp.asarray(x), pair)
    assert_close(got, want, F32_TOL, "expert_dense")


@pytest.mark.parametrize("n,n_groups", [(32, 32), (32, 3), (30, 8), (7, 32),
                                        (1, 32)])
def test_group_count_and_capacity_match_the_reference(n, n_groups):
    """g = min(n_groups, n) lowered until it divides n; cap = ceil(ng * k /
    E * capacity_factor), as the reference's dispatch tensor holds them."""
    cfg, jcfg = _cfgs()
    g = max(1, min(n_groups, n))
    while n % g:
        g -= 1
    cap = int(np.ceil(n // g * 2 / 4 * cfg.capacity_factor))
    assert tmoe.dispatch_shape(cfg, n, n_groups) == (g, 4, cap, 256)
    assert tmoe.n_route_groups(n, n_groups) == g


def test_moe_init_and_lora_specs_have_jax_layout():
    for arch, over in ((GRANITE, {}), (DEEPSEEK, {}),
                       (GRANITE, dict(moe_pad_experts=2)),
                       (JAMBA, dict(post_block_norm=True))):
        cfg, jcfg = _cfgs(arch, **over)
        got = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
        want = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
        assert _layout(got) == _layout(want), arch
        assert got["router"]["w"].dtype == torch.float32
        spec, jspec = BlockSpec(ffn="moe"), JBlockSpec(ffn="moe")
        assert tt.block_lora_specs(cfg, spec) == jt.block_lora_specs(jcfg,
                                                                     jspec)
    assert tmoe.MOE_LORA_TARGETS == jmoe.MOE_LORA_TARGETS


# ------------------------------------------------------------ moe_forward --
#: (label, arch, config overrides, LoRA, n_groups, x offset, skew the
#: router so that every token picks expert 0)
MOE_CASES = [
    ("plain", GRANITE, {}, False, 32, 0.0, False),
    ("lora", GRANITE, {}, True, 32, 0.0, False),
    ("shared", DEEPSEEK, {}, True, 32, 0.0, False),
    ("padded", GRANITE, dict(moe_pad_experts=2), True, 32, 0.0, False),
    ("post_norm", JAMBA, dict(post_block_norm=True), True, 4, 0.0, False),
    ("drops_cf1.25", GRANITE, dict(capacity_factor=1.25), True, 1, 1.0,
     True),
    ("drops_cf1.25_g2", DEEPSEEK, dict(capacity_factor=1.25), True, 2, 1.0,
     True),
    ("one_group", GRANITE, {}, True, 1, 0.0, False),
    ("groups_3_to_2", GRANITE, {}, True, 3, 0.0, False),
    ("groups_8", GRANITE, dict(capacity_factor=1.25), True, 8, 0.0, False),
]


def _moe_rig(arch, over, with_lora, offset, skew):
    cfg, jcfg = _cfgs(arch, **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(4), jcfg)
    if skew:
        w = np.asarray(jp["router"]["w"]).copy()
        w[:, 0] = np.abs(w[:, 0]) * 4.0
        jp = dict(jp, router={"w": jnp.asarray(w)})
    lora = _lora(jcfg, 5) if with_lora else None
    x = _x(cfg.d_model, offset=offset)
    return cfg, jcfg, jp, lora, x


@pytest.mark.parametrize("label,arch,over,with_lora,n_groups,offset,skew",
                         MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_forward_matches_jax(label, arch, over, with_lora, n_groups,
                                 offset, skew):
    cfg, jcfg, jp, lora, x = _moe_rig(arch, over, with_lora, offset, skew)
    want = _jax_moe(jp, lora, jnp.asarray(x), jcfg, n_groups=n_groups)
    got = tmoe.moe_forward(port_tree(jp), port_tree(lora) if lora else None,
                           torch.from_numpy(x), cfg, n_groups=n_groups)
    assert got.shape == x.shape
    assert_close(got, want, F32_TOL, label)
    if skew:    # the case really drops: expert 0 overflows its capacity
        g = tmoe.n_route_groups(32, n_groups)
        h = torch.from_numpy(x).reshape(g, 32 // g, -1)
        _, ix = tmoe.route(cfg, torch.einsum(
            "gnd,de->gne", h, port_tree(jp)["router"]["w"]))
        _, plan = tmoe.dispatch(h, ix, cfg.n_experts + cfg.moe_pad_experts,
                                tmoe.expert_capacity(cfg, 32 // g))
        assert (~plan[2]).sum() > 0, "no token dropped"


def test_moe_ep_hint_is_the_sort_path():
    cfg, jcfg, jp, lora, x = _moe_rig(GRANITE, {}, True, 0.0, False)
    want = _jax_moe(jp, lora, jnp.asarray(x), jcfg)
    got = tmoe.moe_forward(port_tree(jp), port_tree(lora),
                           torch.from_numpy(x),
                           dataclasses.replace(cfg, moe_mode="ep_hint"))
    assert_close(got, want, F32_TOL, "ep_hint")


def test_moe_gradient_reaches_every_expert_pair():
    """Autograd through the dispatch and combine: the expert pairs' B
    gradients are nonzero and finite."""
    cfg, jcfg, jp, lora, x = _moe_rig(GRANITE, {}, True, 0.0, False)
    tl = port_tree(lora)
    for pair in tl.values():
        pair["B"].requires_grad_(True)
    y = tmoe.moe_forward(port_tree(jp), tl, torch.from_numpy(x), cfg)
    grads = torch.autograd.grad(y.square().sum(),
                                [p["B"] for p in tl.values()])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


# -------------------------------------------------------- expert parallel --
def test_moe_ep_world_of_one_is_the_sort_path_with_one_group():
    """Without a process group the expert-parallel body and its wrapper
    are a world of one: the sort path with one routing group, and no
    collective."""
    cfg, jcfg, jp, lora, x = _moe_rig(DEEPSEEK, dict(capacity_factor=1.25),
                                      True, 0.0, False)
    want = _jax_moe(jp, lora, jnp.asarray(x), jcfg, n_groups=1)
    runtime.reset_counts()
    p, tl, tx = port_tree(jp), port_tree(lora), torch.from_numpy(x)
    for got in (moe_ep.moe_forward_ep(p, tl, tx, cfg),
                moe_ep.moe_forward_ep_wrapped(p, tl, tx, cfg)):
        assert_close(got, want, F32_TOL, "ep world of one")
    assert runtime.COLLECTIVES == {"all_reduce": 0, "all_gather": 0,
                                   "all_to_all": 0}


def test_block_dispatches_ep_a2a_to_the_expert_parallel_path(monkeypatch):
    cfg, _ = _cfgs()
    cfg = dataclasses.replace(cfg, moe_mode="ep_a2a")
    spec = BlockSpec(kind="gqa", ffn="moe")
    bp = tt.block_init(torch.Generator().manual_seed(0), cfg, spec)
    seen = []
    orig = moe_ep.moe_forward_ep_wrapped

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tt, "moe_forward_ep_wrapped", spy)
    x = torch.from_numpy(_x(cfg.d_model))
    y, _ = tt.block_forward(bp, None, x, cfg, spec, mode="full")
    assert seen == [1] and torch.isfinite(y).all()


def _spawn(cases, world, tmp):
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
    outs = []
    for k in range(world):
        with open(tmp / f"out{k}.npz.meta", "rb") as f:
            meta = pickle.load(f)
        outs.append((dict(np.load(tmp / f"out{k}.npz")), meta))
    return outs


EP_OVER = dict(d_model=64, n_experts=8, experts_per_token=2, moe_d_ff=32,
               capacity_factor=8.0)


def _jax_ep_grad(jp, lora, x, jcfg, ct):
    """The gradient of <moe_forward(n_groups=8), ct> w.r.t. the params, the
    LoRA factors and x, laid out as the child returns it."""
    factors = {k: {f: v[f] for f in ("A", "B")} for k, v in lora.items()}

    def inner(wrt):
        lo = {k: dict(lora[k], **wrt["lora"][k]) for k in lora}
        y = jmoe.moe_forward(wrt["p"], lo, wrt["x"], jcfg, n_groups=8)
        return jnp.sum(y * ct)
    return jax.grad(inner)({"p": jp, "x": x, "lora": factors})


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    """8 gloo ranks, spawned once: the (data 2, model 4) mesh case and the
    block case, each with its JAX want."""
    cfg, jcfg = _cfgs(**EP_OVER)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = _x(64, shape=(8, 16))
    lora = _lora(jcfg, 6)
    spec = dict(kind="gqa", ffn="moe")
    bp = jt.block_init(jax.random.PRNGKey(1), jcfg, JBlockSpec(**spec))
    np_tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    ct = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    cases = [dict(name="ep_mesh", kind="moe_ep", arch=GRANITE,
                  overrides=EP_OVER, params=np_tree(jp), lora=None, x=x,
                  mesh=(2, 4)),
             dict(name="ep_mesh_lora", kind="moe_ep", arch=GRANITE,
                  overrides=EP_OVER, params=np_tree(jp),
                  lora=np_tree(lora), x=x, mesh=(2, 4)),
             dict(name="ep_mesh_grad", kind="moe_ep", arch=GRANITE,
                  overrides=EP_OVER, params=np_tree(jp),
                  lora=np_tree(lora), x=x, mesh=(2, 4), cotangent=ct),
             dict(name="ep_block", kind="moe_ep_block", arch=GRANITE,
                  overrides=EP_OVER, params=np_tree(bp), lora=None, x=x,
                  spec=spec)]
    wants = {
        "ep_mesh": _jax_moe(jp, None, jnp.asarray(x), jcfg, n_groups=8),
        "ep_mesh_lora": _jax_moe(jp, lora, jnp.asarray(x), jcfg, n_groups=8),
        "ep_block": jt.block_forward(bp, None, jnp.asarray(x), jcfg,
                                     JBlockSpec(**spec), mode="full")[0],
        "ep_mesh_grad": _jax_ep_grad(jp, lora, jnp.asarray(x), jcfg, ct)}
    return _spawn(cases, 8, tmp_path_factory.mktemp("moe_ep")), wants


@pytest.mark.parametrize("case", ["ep_mesh", "ep_mesh_lora", "ep_block"])
def test_moe_ep_a2a_matches_pjit_path(ep_world, case):
    """Every rank of the 8-rank world returns the whole output, equal to
    the reference's sort path with 8 groups (the block: its sort path with
    32, no token dropped in either), after one all_to_all each way and one
    all_gather."""
    outs, wants = ep_world
    for rank, (arrays, meta) in enumerate(outs):
        assert_close(arrays[f"{case}|y"], wants[case], F32_TOL,
                     f"{case} rank {rank}")
        assert meta[case]["collectives"] == {
            "all_reduce": 0, "all_gather": 1, "all_to_all": 2}, meta[case]


def test_moe_ep_a2a_gradients_match_jax(ep_world):
    """Through the wrapped expert-parallel path, every rank of the 8-rank
    world holds the whole gradient of a loss on the whole output -- the
    params', the LoRA factors' and x's, as JAX's of its sort path with 8
    groups -- after the two all_to_alls back and one all_reduce of the
    inputs' gradients."""
    outs, wants = ep_world
    want = jax.tree.map(np.asarray, wants["ep_mesh_grad"])
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}|{k}")
        else:
            flat[path] = t
    walk(want, "ep_mesh_grad|grad")
    for rank, (arrays, meta) in enumerate(outs):
        for key, w in flat.items():
            assert_close(arrays[key], w, F32_TOL, f"{key} rank {rank}")
        assert meta["ep_mesh_grad"]["collectives"] == {
            "all_reduce": 1, "all_gather": 1, "all_to_all": 4}, meta


# ------------------------------------------------- RBLA on expert adapters --
@functools.lru_cache(maxsize=None)
def _rbla_rig(arch):
    """Three clients' adapters (ranks 2, 5, 8, live B), their weights and
    JAX's rbla round on its reference and interpreted Pallas backends."""
    clients = _client_adapters(arch)
    w = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    wants = [jax.tree.map(np.asarray, js.get_strategy(
        "rbla").aggregate_adapters(clients, w, r_max=8, backend=jb))
        for jb in ("ref", "pallas")]
    return clients, w, wants


def _client_adapters(arch, ranks=(2, 5, 8)):
    jcfg = jax_get_config(arch).reduced()
    model = jax_make_model(jcfg, remat=False)
    rng = np.random.default_rng(11)
    out = []
    for i, r in enumerate(ranks):
        ad = model.init_adapters(jax.random.PRNGKey(20 + i), rank=r)

        def live(pair):
            b = np.asarray(pair["B"])
            m = (np.arange(b.shape[-1]) < r).astype(np.float32)
            return dict(pair, B=jnp.asarray(
                (rng.normal(size=b.shape) * 0.05).astype(np.float32) * m))
        out.append({"stages": tuple(
            {b: {k: live(v) for k, v in unit.items()}
             for b, unit in st.items()} for st in ad["stages"])})
    return out


@pytest.mark.parametrize("backend", ["ref", "auto"])
@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_rbla_over_expert_adapters_matches_jax(arch, backend):
    """The paper's Eq. 7 over MoE expert pairs (leading (repeat, E) axes)
    of three clients at ranks 2, 5 and 8: the port's round (one plain
    packed_agg call on the CPU) against JAX's reference and interpreted
    Pallas rounds."""
    clients, w, wants = _rbla_rig(arch)
    unit = clients[0]["stages"][-1]["b0"]
    assert unit["ffn/experts/gate"]["A"].shape[:2] == (1, 4)
    runtime.reset_counts()
    got = ts.get_strategy("rbla").with_options().aggregate_adapters(
        [port_tree(c) for c in clients], torch.tensor(np.asarray(w)),
        r_max=8, backend=backend)
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    for want in wants:
        for g, w_ in zip(got["stages"], want["stages"], strict=True):
            assert_trees_close(g, w_, F32_TOL, arch)
