"""The port's sharding rules (``repro_torch.sharding.rules``) against the JAX
package's, on the CPU.

Specs are data: the rules read a mesh through its axis names and sizes, so
the duck-typed meshes below stand for the production meshes without 256
or 512 ranks.  First the twin of every test in
``tests/test_sharding_rules.py``; then, for all ten archs at full size,
the port's parameter (with and without ``fsdp``), adapter, batch and
cache specs against JAX's path by path on both production meshes, JAX's
trees from ``jax.eval_shape`` and the port's from the meta device
(``MetaGenerator``); then the placements a spec gives a ``DeviceMesh``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.models.common import MetaGenerator
from repro_torch.models.model import make_model
from repro_torch.sharding import P, rules


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeMesh1:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


MESHES = {"pod1": FakeMesh1, "pod2": FakeMesh}
ALL_ARCHS = sorted(ARCHS)


def _meta_params(arch):
    return make_model(get_config(arch)).init(MetaGenerator())


def _meta_adapters(arch, rank=8):
    return make_model(get_config(arch)).init_adapters(MetaGenerator(),
                                                      rank=rank)


# ------------------------------------------------- the reference's tests ----
def test_maybe_divisibility():
    m = FakeMesh1()
    assert rules.maybe(m, 64, "model") == "model"
    assert rules.maybe(m, 50280, "model") is None   # mamba vocab: uneven
    assert rules.axis_size(FakeMesh(), ("pod", "data")) == 32


def test_param_specs_yi():
    specs = rules.param_specs(_meta_params("yi-34b"), FakeMesh1())
    # embedding sharded on vocab (64000 % 16 == 0)
    assert specs["embed"]["table"] == P("model", None)
    st = specs["stages"][0]["b0"]
    # fused q (L, d, H*hd): column-parallel on fan-out
    assert st["mix"]["q"]["w"] == P(None, None, "model")
    # o: row-parallel on fan-in
    assert st["mix"]["o"]["w"] == P(None, "model", None)
    assert st["ffn"]["down"]["w"] == P(None, "model", None)
    # norms replicated
    assert st["mix"]["ln"]["scale"] == P(None, None)


def test_param_specs_moe_expert_axis():
    specs = rules.param_specs(_meta_params("deepseek-v3-671b"), FakeMesh1())
    moe = specs["stages"][1]["b0"]["ffn"]
    # experts (L, E, d, f): E sharded over model (256 % 16 == 0)
    assert moe["experts"]["gate"]["w"] == P(None, "model", None, None)
    # router replicated
    assert moe["router"]["w"] == P(None, None, None)


def test_param_specs_fsdp_shards_contracting_dim():
    specs = rules.param_specs(_meta_params("yi-34b"), FakeMesh1(), fsdp=True)
    st = specs["stages"][0]["b0"]
    assert st["mix"]["q"]["w"] == P(None, ("data",), "model")
    assert st["ffn"]["down"]["w"] == P(None, "model", ("data",))


def test_batch_and_cache_specs():
    m = FakeMesh()
    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                   device="meta")}
    specs = rules.batch_specs(batch, m)
    assert specs["tokens"] == P(("pod", "data"), None)
    # batch=1 long-context: shard cache time axis instead
    model = make_model(get_config("gemma2-9b"))
    cache = model.init_cache(1, 524288, device="meta")
    cspecs = rules.cache_specs(cache, m, global_batch=1)
    # global layer (b1) kv cache: (L, B, T, KV, hd) -> T sharded
    leaf = cspecs[0]["b1"]["k"]
    assert leaf[2] == ("pod", "data")
    dec = rules.cache_specs(cache, m, global_batch=128)
    assert dec[0]["b1"]["k"][1] == ("pod", "data")


def test_adapter_specs_expert_axis():
    specs = rules.adapter_specs(_meta_adapters("deepseek-v3-671b"),
                                FakeMesh1())
    pair = specs["stages"][1]["b0"]["ffn/experts/gate"]
    assert pair["A"] == P(None, "model", None, None)
    # non-expert adapters replicated
    q = specs["stages"][1]["b0"]["mix/q_a"]
    assert q["A"] == P(None, None, None)


# ------------------------------------------- every arch against JAX's ----
_JAX_SHAPES: dict = {}


def _jax_shapes(kind, arch, *args):
    """JAX's eval_shape trees, built once per (kind, arch, args)."""
    key = (kind, arch) + args
    if key not in _JAX_SHAPES:
        model = jax_make_model(jax_get_config(arch))
        if kind == "params":
            got = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        elif kind == "adapters":
            got = jax.eval_shape(
                lambda k: model.init_adapters(k, rank=args[0]),
                jax.random.PRNGKey(1))
        else:
            got = jax.eval_shape(lambda: model.init_cache(*args))
        _JAX_SHAPES[key] = got
    return _JAX_SHAPES[key]


def _jax_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in flat}


def _port_flat(specs) -> dict:
    out = {}
    rules._map_with_path(lambda path, s: out.__setitem__(path, tuple(s)),
                         specs)
    return out


def _same(got, want, msg):
    g, w = _port_flat(got), _jax_flat(want)
    assert set(g) == set(w), f"{msg}: paths {set(g) ^ set(w)}"
    bad = {p: (g[p], w[p]) for p in w if g[p] != w[p]}
    assert not bad, f"{msg}: {bad}"


def test_port_has_the_reference_archs():
    assert sorted(JAX_ARCHS) == ALL_ARCHS
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in INPUT_SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in JAX_SHAPES.items()}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch, mesh, fsdp):
    m = MESHES[mesh]()
    got = rules.param_specs(_meta_params(arch), m, fsdp=fsdp)
    want = jrules.param_specs(_jax_shapes("params", arch), m, fsdp=fsdp)
    _same(got, want, f"{arch} {mesh} fsdp={fsdp}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_adapter_specs_match_jax(arch, mesh):
    m = MESHES[mesh]()
    rank = get_config(arch).lora_r_max
    got = rules.adapter_specs(_meta_adapters(arch, rank), m)
    want = jrules.adapter_specs(_jax_shapes("adapters", arch, rank), m)
    _same(got, want, f"{arch} {mesh}")
    assert _port_flat(rules.replicated_specs(_meta_adapters(arch, rank))) \
        == _jax_flat(jrules.replicated_specs(
            _jax_shapes("adapters", arch, rank)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_batch_specs_match_jax(shape, mesh):
    """Every input shape's token batch, an encoder's frames and a VLM's
    patches, and a 0-d leaf, on both meshes."""
    m = MESHES[mesh]()
    s = INPUT_SHAPES[shape]
    dims = {"tokens": (s.global_batch, s.seq_len),
            "frames": (s.global_batch, 1500, 128),
            "patches": (s.global_batch, 576, 1024), "pos": (),
            "odd": (3, 7), "data_only": (16, 2)}
    got = rules.batch_specs({k: torch.empty(v, device="meta")
                             for k, v in dims.items()}, m)
    want = jrules.batch_specs({k: jax.ShapeDtypeStruct(v, jnp.float32)
                               for k, v in dims.items()}, m)
    _same(got, want, f"{shape} {mesh}")


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_jax(arch, shape, mesh, seq_shard):
    """The decode caches at each input shape's batch and length (with a
    VLM's prefix), including long_500k's ``global_batch=1`` and
    ``seq_shard_model=True``."""
    m = MESHES[mesh]()
    s = INPUT_SHAPES[shape]
    cfg = get_config(arch)
    n_prefix = cfg.n_prefix_tokens if cfg.frontend == "vision_patches" else 0
    b, t = s.global_batch, s.seq_len + n_prefix
    got = rules.cache_specs(make_model(cfg).init_cache(b, t, device="meta"),
                            m, b, seq_shard_model=seq_shard)
    want = jrules.cache_specs(_jax_shapes("cache", arch, b, t), m, b,
                              seq_shard_model=seq_shard)
    _same(got, want, f"{arch} {shape} {mesh} seq_shard={seq_shard}")


# ------------------------------------------------------------ placements ----
def test_spec_entries_normalise_as_the_reference():
    assert P(None, ("data",), "model") == P(None, "data", "model")
    assert tuple(P((), ("pod", "data"))) == tuple(JP((), ("pod", "data")))
    assert isinstance(P("model"), tuple) and repr(P(None)) == "P(None,)"


def test_to_shardings_places_each_axis():
    from torch.distributed.tensor import Replicate, Shard
    pod, one = FakeMesh(), FakeMesh1()
    specs = {"w": P(None, "model"), "b": P(("pod", "data"), None),
             "stack": (P(), P("data", "model"))}
    got = rules.to_shardings(specs, pod)
    assert got["w"] == (Replicate(), Replicate(), Shard(1))
    assert got["b"] == (Shard(0), Shard(0), Replicate())
    assert got["stack"][0] == (Replicate(),) * 3
    assert got["stack"][1] == (Replicate(), Shard(0), Shard(1))
    assert rules.to_shardings(P(None, "model"), one) == (Replicate(),
                                                         Shard(1))
    with pytest.raises(ValueError, match="names axis 'pod'"):
        rules.placements(P("pod"), one)
    with pytest.raises(ValueError, match="twice"):
        rules.placements(P("model", "model"), one)
    with pytest.raises(ValueError, match="mesh's order"):
        rules.placements(P(("data", "pod")), pod)


def test_param_specs_fit_the_rules_table():
    """Every leaf of every arch on the pod mesh: a sharded dimension
    divides its axes, as ``maybe`` promises."""
    m = FakeMesh()
    for arch in ALL_ARCHS:
        params = _meta_params(arch)
        specs = rules.param_specs(params, m, fsdp=True)
        leaves = {}
        rules._map_with_path(lambda p, t: leaves.__setitem__(p, t), params)
        for path, spec in _port_flat(specs).items():
            for d, entry in enumerate(spec):
                if entry is not None:
                    assert leaves[path].shape[d] % rules.axis_size(
                        m, entry) == 0, (arch, path, spec)
