"""The port's upload codecs and encoded plans against the JAX package:
encode/decode of the same pairs in both packages, ingestion validation and
its reasons, the statistics of ``stochastic_round``, and the encoded mean
plan against ``repro``'s aggregate of the same encoded cohort for each
mean-family method (plus the robust family) under int8, bf16 and a
mixed-client codec mix.

Inputs come from numpy with fixed seeds (parametrised, not drawn), so
every run checks the same cases.  Tolerances: int8 codes exactly away from
rounding ties, decoded values within half a quantisation step, bf16 bit
for bit; aggregates within 2e-5 of max|want| (fp32 sums in another order).
Stochastic rounding draws from ``torch.Generator`` in the port and from
``jax.random`` in the reference, so it is gated by its statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, hetero_cohort
from _torch_parity import assert_close, assert_trees_close, port_tree

from repro.core import codec as jcodec
from repro.core import strategy as js
from repro_torch.core import codec as tcodec
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.tree import tree_leaves

MEAN = ["fedavg", "zeropad", "rbla", "rbla_ranked", "rbla_norm"]
ROBUST = ["rbla_clipped", "rbla_trimmed", "rbla_median"]
MIXES = {"int8": ("int8",) * 5, "bf16": ("bf16",) * 5,
         "mixed": ("int8", "bf16", "none", "int8", "bf16")}


def _pair(seed, r=8, fo=12, fi=16, rank=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(r, fi)).astype(np.float32)
    b = rng.normal(size=(fo, r)).astype(np.float32) * 3.0
    a[rank:], b[:, rank:] = 0.0, 0.0
    return {"A": a, "B": b, "rank": np.int32(rank)}


def _both(pair):
    tp = {"A": torch.as_tensor(pair["A"]), "B": torch.as_tensor(pair["B"]),
          "rank": torch.tensor(int(pair["rank"]), dtype=torch.int32)}
    jp = {"A": jnp.asarray(pair["A"]), "B": jnp.asarray(pair["B"]),
          "rank": jnp.asarray(pair["rank"])}
    return tp, jp


# ---------------------------------------------------------- encode/decode --
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_codes_and_scales_match_jax(seed):
    tp, jp = _both(_pair(seed))
    te, je = tcodec.encode_pair(tp, "int8"), jcodec.encode_pair(jp, "int8")
    assert te["A"].dtype == torch.int8 and set(te) == set(je)
    for k in ("A_scale", "B_scale"):
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    for side, scale, axis in (("A", "A_scale", -1), ("B", "B_scale", -2)):
        x = np.asarray(jp[side], np.float32)
        s = np.expand_dims(np.asarray(je[scale]), axis)
        q = x / s
        tie = np.abs(np.abs(q - np.trunc(q)) - 0.5) < 1e-4
        got, want = te[side].numpy(), np.asarray(je[side])
        np.testing.assert_array_equal(got[~tie], want[~tie])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        dec = tcodec.decode_pair(te)[side].numpy()
        assert np.all(np.abs(dec - x) <= 0.5 * s + 1e-7)
        np.testing.assert_allclose(
            dec, np.asarray(jcodec.decode_pair(je)[side]),
            atol=float(s.max()) + 1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_codec_matches_jax_bit_for_bit(seed):
    tp, jp = _both(_pair(seed))
    te, je = tcodec.encode_pair(tp, "bf16"), jcodec.encode_pair(jp, "bf16")
    for side in ("A", "B"):
        assert te[side].dtype == torch.bfloat16
        np.testing.assert_array_equal(te[side].float().numpy(),
                                      np.asarray(je[side], np.float32))
        np.testing.assert_array_equal(
            tcodec.decode_pair(te)[side].numpy(),
            np.asarray(jcodec.decode_pair(je)[side]))


def test_codec_names_trees_and_idempotent_decode():
    tp, _ = _both(_pair(0))
    tree = {"fc1": tp, "fc2": dict(tp)}
    assert tcodec.codec_of_pair(tp) == "none"
    assert tcodec.tree_codec(tcodec.encode_adapters(tree, "int8")) == "int8"
    assert tcodec.tree_codec(tcodec.encode_adapters(tree, "bf16")) == "bf16"
    mixed = {"fc1": tcodec.encode_pair(tp, "int8"), "fc2": tp}
    assert tcodec.tree_codec(mixed) == "mixed"
    assert tcodec.cohort_codecs([tree, tree]) is None
    assert tcodec.cohort_codecs([tree, mixed]) == ("none", "mixed")
    assert tcodec.encode_adapters(tree, "none") is tree
    dec = tcodec.decode_adapters(tree)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(dec),
                                                 tree_leaves(tree)))
    with pytest.raises(ValueError, match="unknown codec"):
        tcodec.encode_adapters(tree, "fp8")
    upd = ts.ClientUpdate(adapters=tree, base_trainable={"b": torch.ones(2)})
    enc = tcodec.encode_update(upd, "int8")
    assert enc.base_trainable is upd.base_trainable
    assert tcodec.tree_codec(tcodec.decode_update(enc).adapters) == "none"


# ------------------------------------------------------------ validation --
@pytest.mark.parametrize("poison,reason", [(float("nan"), "bad_scale"),
                                           (0.0, "bad_scale"),
                                           (-1.0, "bad_scale"),
                                           (1e37, "overflow")])
def test_validation_reasons_match_jax(poison, reason):
    tp, jp = _both(_pair(4))
    te, je = tcodec.encode_pair(tp, "int8"), jcodec.encode_pair(jp, "int8")
    te["B_scale"] = te["B_scale"].clone()
    te["B_scale"][2] = poison
    je["B_scale"] = je["B_scale"].at[2].set(poison)
    with pytest.raises(tcodec.UploadValidationError) as got:
        tcodec.validate_encoded_adapters({"p": te})
    with pytest.raises(jcodec.UploadValidationError) as want:
        jcodec.validate_encoded_adapters({"p": je})
    assert got.value.reason == want.value.reason == reason
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)
    tcodec.validate_encoded_adapters({"p": tcodec.encode_pair(tp, "int8")})


# ---------------------------------------------------- stochastic rounding --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_deterministic_and_fixed_points(seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(64, 33)).astype(np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)      # noqa: E731
    a = tcodec.stochastic_round(x, gen(seed))
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, tcodec.stochastic_round(x, gen(seed)))
    assert not torch.equal(a, tcodec.stochastic_round(x, gen(seed + 10)))
    # within one bf16 ulp, always on one of the two neighbours
    down = (x.view(torch.int32) & -65536).view(torch.float32)
    assert bool(((a.float() == down) | (a.float().abs() > down.abs())).all())
    assert bool(((a.float() - x).abs() <= 2.0 ** -7 * x.abs()).all())
    rep = x.bfloat16()                                   # fixed points
    assert torch.equal(tcodec.stochastic_round(rep.float(), gen(seed)), rep)


def test_stochastic_round_is_unbiased():
    """Mean of 512 draws of values placed at a quarter, half and three
    quarters of a bf16 ulp: the rounding error averages out to well under
    the deterministic error of round-to-nearest (an eighth of an ulp at
    the quarter points, against a quarter)."""
    base = torch.tensor([1.0, -3.0, 1000.0])
    ulp = 2.0 ** (torch.floor(torch.log2(base.abs())) - 7)
    x = (base[:, None] + ulp[:, None] * torch.tensor([0.25, 0.5, 0.75])
         ).reshape(-1)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tcodec.stochastic_round(x, gen).float()
                         for _ in range(512)])
    err = (draws.mean(0) - x).abs() / ulp.repeat_interleave(3)
    assert float(err.max()) < 0.125
    det = (x.bfloat16().float() - x).abs() / ulp.repeat_interleave(3)
    assert float(det.max()) >= 0.25


def test_stochastic_round_edges_and_tree():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0,
                      3.4e38])
    got = tcodec.stochastic_round(x, torch.Generator().manual_seed(0))
    assert torch.isinf(got[0]) and got[0] > 0 and torch.isinf(got[1])
    assert torch.isnan(got[2]) and float(got[3]) == 0.0
    tree = {"A": torch.randn(3, 4), "rank": torch.tensor(3)}
    out = tcodec.stochastic_round_tree(tree, torch.Generator().manual_seed(1))
    assert out["A"].dtype == torch.bfloat16 and out["rank"] is tree["rank"]
    with pytest.raises(ValueError, match="bfloat16"):
        tcodec.stochastic_round(x, torch.Generator(), torch.float16)


# ---------------------------------------------------------- encoded plans --
def _encoded_cohort(codecs, seed=0):
    adapters, ranks, w = hetero_cohort(n=len(codecs), seed=seed)
    jenc = [jcodec.encode_adapters(a, c) for a, c in zip(adapters, codecs)]
    tenc = [tcodec.encode_adapters(port_tree(a), c)
            for a, c in zip(adapters, codecs)]
    return jenc, tenc, ranks, w


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("name", MEAN + ROBUST)
def test_encoded_plan_matches_jax_aggregate(name, mix):
    """The same encoded cohort through both packages' encoded plans (JAX
    on its reference backend): one plain call per round, no decode."""
    jenc, tenc, ranks, w = _encoded_cohort(MIXES[mix])
    prev = hetero_cohort(n=1, seed=9)[0][0]
    kw = dict(r_max=R_MAX, client_ranks=None)
    want = js.get_strategy(name).aggregate_adapters(
        jenc, w, prev_global=prev, backend="ref", **kw)
    tstr = ts.get_strategy(name).with_options()
    runtime.reset_counts()
    got = tstr.aggregate_adapters(tenc, torch.tensor(np.asarray(w)),
                                  prev_global=port_tree(prev), backend="ref",
                                  **kw)
    kernel = "packed_robust" if name in ROBUST else "packed_agg"
    (plan,) = tstr.__dict__["_plan_cache"].values()
    assert plan.spec.codecs == MIXES[mix] and plan.kind == "packed"
    assert runtime.PLAIN_CALLS[kernel] == plan.n_kernel_launches == 1
    assert_trees_close(got, jax.tree.map(np.asarray, want), msg=name)


@pytest.mark.parametrize("name", ["svd", "flora"])
def test_other_strategies_decode_eagerly(name):
    """Outside the mean family the cohort is decoded and takes the plain
    path, as in the JAX package."""
    jenc, tenc, ranks, w = _encoded_cohort(MIXES["mixed"])
    tstr = ts.get_strategy(name).with_options(
        **({"stack_r_cap": 8 * R_MAX} if name == "flora" else {}))
    wt = torch.tensor(np.asarray(w))
    got = tstr.aggregate_adapters(tenc, wt, r_max=R_MAX, backend="ref")
    dec = tstr.aggregate_adapters([tcodec.decode_adapters(a) for a in tenc],
                                  wt, r_max=R_MAX, backend="ref")
    for a, b in zip(tree_leaves(got), tree_leaves(dec)):
        assert torch.equal(a, b)
    jstr = js.get_strategy(name).with_options(
        **({"stack_r_cap": 8 * R_MAX} if name == "flora" else {}))
    want = jstr.aggregate_adapters(jenc, w, r_max=R_MAX, backend="ref")
    for k in got:
        assert_close(got[k]["B"] @ got[k]["A"],
                     np.asarray(want[k]["B"]) @ np.asarray(want[k]["A"]))


def test_encoded_plan_cache_keys_on_the_codec_mix():
    _, tenc, _, w = _encoded_cohort(MIXES["int8"])
    _, tenc_bf, _, _ = _encoded_cohort(MIXES["bf16"])
    tstr = ts.get_strategy("rbla").with_options()
    wt = torch.tensor(np.asarray(w))
    for cohort in (tenc, tenc_bf, tenc, tenc_bf):
        tstr.aggregate_adapters(cohort, wt, r_max=R_MAX, backend="ref")
    assert tstr.plan_stats == {"hits": 2, "misses": 2}


def test_intra_client_mixed_codecs_decode_eagerly():
    adapters, ranks, w = hetero_cohort(n=3, seed=5)
    tenc = [port_tree(a) for a in adapters]
    tenc[0] = {"fc1": tcodec.encode_pair(tenc[0]["fc1"], "int8"),
               "fc2": tcodec.encode_pair(tenc[0]["fc2"], "bf16")}
    tstr = ts.get_strategy("rbla").with_options()
    wt = torch.tensor(np.asarray(w))
    got = tstr.aggregate_adapters(tenc, wt, r_max=R_MAX, backend="ref")
    want = tstr.aggregate_adapters([tcodec.decode_adapters(a) for a in tenc],
                                   wt, r_max=R_MAX, backend="ref")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
