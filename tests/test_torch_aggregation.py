"""Parity of the port's rank masks and aggregation leaves
(``repro_torch.core.masks`` / ``aggregation`` / ``variants``) with the JAX
package's, on the shared hetero-rank cohorts."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, hetero_cohort
from _torch_parity import assert_close

from repro.core import aggregation as ja
from repro.core import masks as jm
from repro.core import variants as jv
from repro.core.strategy import stack_trees as j_stack
from repro.lora import adapter_masks as j_adapter_masks
from repro_torch.core import aggregation as ta
from repro_torch.core import masks as tm
from repro_torch.core import variants as tv


@pytest.mark.parametrize("r_max,rank", [(8, 0), (8, 3), (8, 8), (64, 17)])
def test_rank_mask(r_max, rank):
    assert_close(tm.rank_mask(r_max, rank), jm.rank_mask(r_max, rank))


def test_stacked_rank_masks():
    ranks = np.array([1, 4, 8, 2], np.int32)
    assert_close(tm.stacked_rank_masks(8, torch.as_tensor(ranks)),
                 jm.stacked_rank_masks(8, jnp.asarray(ranks)))


@pytest.mark.parametrize("shape,axis", [((8, 5), 0), ((6, 8), -1),
                                        ((3, 8, 4), 1)])
def test_axis_mask(shape, axis):
    assert_close(tm.axis_mask(shape, axis, 3), jm.axis_mask(shape, axis, 3))


@pytest.mark.parametrize("axis", [0, -1])
def test_pad_and_slice_to_rank(axis):
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    got = tm.pad_to_rank(torch.as_tensor(x), axis, 9)
    assert_close(got, jm.pad_to_rank(jnp.asarray(x), axis, 9))
    assert_close(tm.slice_to_rank(got, axis, 2),
                 jm.slice_to_rank(jnp.asarray(got.numpy()), axis, 2))
    with pytest.raises(ValueError):
        tm.pad_to_rank(torch.as_tensor(x), axis, 1)


LEAVES = [("fc1", "A"), ("fc1", "B"), ("fc2", "A"), ("fc2", "B")]


@functools.cache
def _cohort(seed):
    adapters, ranks, weights = hetero_cohort(n=5, seed=seed)
    return (j_stack(adapters), j_stack([j_adapter_masks(a) for a in adapters]),
            weights)


def _stacked_leaf(seed, path, side):
    stacked, masks, weights = _cohort(seed)
    return stacked[path][side], masks[path][side], weights


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path,side", LEAVES)
@pytest.mark.parametrize("leaf", ["fedavg", "zeropad", "rbla", "rbla_prev",
                                  "rbla_norm"])
def test_leaf_parity(seed, path, side, leaf):
    x, m, w = _stacked_leaf(seed, path, side)
    tx, tmask, tw = (torch.as_tensor(np.array(v)) for v in (x, m, w))
    prev = np.random.default_rng(seed).normal(size=x.shape[1:]).astype(
        np.float32)
    if leaf == "fedavg":
        got, want = ta.fedavg_leaf(tx, tw), ja.fedavg_leaf(x, w)
    elif leaf == "zeropad":
        got, want = ta.zeropad_leaf(tx, tmask, tw), ja.zeropad_leaf(x, m, w)
    elif leaf == "rbla":
        got, want = ta.rbla_leaf(tx, tmask, tw), ja.rbla_leaf(x, m, w)
    elif leaf == "rbla_prev":
        got = ta.rbla_leaf(tx, tmask, tw, torch.as_tensor(prev))
        want = ja.rbla_leaf(x, m, w, jnp.asarray(prev))
    else:
        row_axis = 0 if side == "A" else 1
        got = tv.rbla_norm_leaf(tx, tmask, tw, row_axis=row_axis)
        want = jv.rbla_norm_leaf(x, m, w, row_axis=row_axis)
    assert_close(got, want, msg=f"{leaf} {path}.{side}")


def test_rbla_keeps_prev_on_unowned_rows():
    """Rows beyond every participant's rank are exactly the prev rows."""
    x, m, w = _stacked_leaf(3, "fc1", "A")
    ranks = np.asarray(hetero_cohort(n=5, seed=3)[1])
    prev = torch.full(x.shape[1:], 7.0)
    got = ta.rbla_leaf(torch.as_tensor(np.array(x)),
                       torch.as_tensor(np.array(m)),
                       torch.as_tensor(np.array(w)), prev)
    assert torch.equal(got[int(ranks.max()):], prev[int(ranks.max()):])
    assert int(ranks.max()) <= R_MAX


def test_rank_proportional_weights():
    w = np.array([1.0, 2.0, 0.5], np.float32)
    r = np.array([2, 8, 4], np.int32)
    assert_close(tv.rank_proportional_weights(torch.as_tensor(w),
                                              torch.as_tensor(r)),
                 jv.rank_proportional_weights(jnp.asarray(w), jnp.asarray(r)))


def test_integer_leaf_keeps_dtype():
    ranks = torch.tensor([2, 4, 6], dtype=torch.int32)
    out = ta.fedavg_leaf(ranks, torch.ones(3))
    assert out.dtype == torch.int32
    assert int(out) == int(ja.fedavg_leaf(jnp.asarray(ranks.numpy()),
                                          jnp.ones(3)))
