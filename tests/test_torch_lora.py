"""The port's LoRA substrate (``repro_torch.lora``) against the JAX
package's: masking, rank re-slicing, the LoRA forward, merging, and the
no-aliasing guarantee of ``set_ranks``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import hetero_cohort
from _torch_parity import assert_close, assert_trees_close, port_tree

from repro import lora as jl
from repro_torch import lora as tl

SPECS = {"fc1": (12, 16), "fc2": (10, 12)}


def _random_pair(seed, r_max=8, rank=5):
    rng = np.random.default_rng(seed)
    pair = {"A": rng.normal(size=(r_max, 16)).astype(np.float32),
            "B": rng.normal(size=(12, r_max)).astype(np.float32),
            "rank": np.int32(rank)}
    return pair, port_tree(pair)


@pytest.mark.parametrize("rank,r_storage", [(3, None), (8, None), (2, 4),
                                            (5, 12)])
def test_set_ranks_parity(rank, r_storage):
    adapters, _, _ = hetero_cohort(n=1, seed=rank)
    want = jl.set_ranks(adapters[0], rank, r_storage=r_storage)
    got = tl.set_ranks(port_tree(adapters[0]), rank, r_storage=r_storage)
    assert_trees_close(got, want)


def test_set_ranks_never_aliases():
    src = port_tree(hetero_cohort(n=1, seed=0)[0][0])
    out = tl.set_ranks(src, 8)
    for k in src:
        for side in ("A", "B", "rank"):
            assert out[k][side].data_ptr() != src[k][side].data_ptr()
    before = src["fc1"]["A"].clone()
    out["fc1"]["A"].add_(1.0)
    assert torch.equal(src["fc1"]["A"], before)


def test_set_ranks_rejects_rank_beyond_storage():
    with pytest.raises(ValueError, match="exceeds"):
        tl.set_ranks(port_tree(hetero_cohort(n=1, seed=0)[0][0]), 9,
                     r_storage=8)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_merge_mask_parity(seed):
    jpair, tpair = _random_pair(seed)
    x = np.random.default_rng(seed + 10).normal(size=(3, 16)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, jpair)
    assert_close(tl.apply_pair(torch.as_tensor(x), tpair),
                 jl.apply_pair(jnp.asarray(x), jp))
    w = np.random.default_rng(seed).normal(size=(12, 16)).astype(np.float32)
    assert_close(tl.merge_pair(torch.as_tensor(w), tpair),
                 jl.merge_pair(jnp.asarray(w), jp))
    assert_trees_close(tl.mask_pair(tpair), jl.mask_pair(jp))
    got_m, want_m = tl.pair_masks(tpair), jl.pair_masks(jp)
    assert_close(got_m["A"], want_m["A"])
    assert_close(got_m["B"], want_m["B"])


def test_strip_attach_roundtrip_and_init():
    ad = tl.init_adapters(torch.Generator().manual_seed(0), SPECS, 8, 3)
    assert list(ad) == sorted(SPECS)
    for path, (fo, fi) in SPECS.items():
        assert ad[path]["A"].shape == (8, fi)
        assert ad[path]["B"].shape == (fo, 8)
        assert int(ad[path]["rank"]) == 3
        assert not ad[path]["A"][3:].any() and not ad[path]["B"].any()
    factors, ranks = tl.strip_ranks(ad)
    assert "rank" not in factors["fc1"]
    back = tl.attach_ranks(factors, ranks)
    assert all(back[k][s] is ad[k][s] for k in ad for s in ("A", "B", "rank"))
    assert tl.count_params(ad) == sum(8 * (fo + fi) + 1
                                      for fo, fi in SPECS.values())
