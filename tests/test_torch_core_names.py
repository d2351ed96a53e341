"""The port's package-level names against the JAX package's, on the CPU.

* every name of ``repro.core.__all__`` and ``repro.kernels.__all__``
  imports from ``repro_torch.core`` / ``repro_torch.kernels``, less the
  names that exist only inside a JAX trace (``dispatch_counter``, the
  ``*_inline`` kernels, ``packed_robust_xla``);
* ``repro_torch.core.aggregate`` (the deprecated shim over the strategy
  registry) equals ``repro.core.aggregate`` on ``tests/_cohorts.py``'s
  ``hetero_cohort`` for rbla (with and without a previous global) and
  zeropad, within F32_TOL (2e-5 of max|want|); ``AGGREGATORS`` holds the
  same leaves;
* ``BACKENDS`` and ``resolve_backend`` are the port's (``"kernel"`` in the
  place of ``"pallas"``, which stays an alias);
* the six aggregation kernels and their ``_ref`` forms are
  ``repro_torch.kernels.rbla_agg``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import hetero_cohort
from _torch_parity import F32_TOL, assert_close, port_tree

import repro.core as jcore
import repro.kernels as jkernels
import repro_torch.core as tcore
import repro_torch.kernels as tkernels
from repro.core import stack_trees as jax_stack_trees
from repro.lora import adapter_masks as jax_adapter_masks
from repro_torch.kernels.rbla_agg import ops as rbla_agg_ops
from repro_torch.kernels.rbla_agg import ref as rbla_agg_ref

JAX_ONLY = {"dispatch_counter", "lora_matmul_inline",
            "batched_lora_matmul_inline", "packed_robust_xla"}
CORE_NAMES = [n for n in jcore.__all__ if n not in JAX_ONLY]
KERNEL_NAMES = [n for n in jkernels.__all__ if n not in JAX_ONLY]
AGG_KERNELS = ("packed_agg", "packed_robust", "packed_stack", "flora_stack",
               "axpy_fold", "rbla_agg")


@pytest.mark.parametrize("name", CORE_NAMES)
def test_core_name_imports_from_the_port(name):
    assert name in tcore.__all__
    assert getattr(tcore, name) is not None


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernels_name_imports_from_the_port(name):
    assert name in tkernels.__all__
    assert callable(getattr(tkernels, name))


def test_only_the_jax_only_names_are_left_out():
    assert set(jcore.__all__) - set(tcore.__all__) == {"dispatch_counter"}
    assert set(jkernels.__all__) - set(tkernels.__all__) == {
        "lora_matmul_inline", "batched_lora_matmul_inline",
        "packed_robust_xla"}


@pytest.mark.parametrize("name", AGG_KERNELS)
def test_aggregation_kernels_are_the_rbla_agg_wrappers(name):
    assert getattr(tkernels, name) is getattr(rbla_agg_ops, name)
    assert getattr(tkernels, f"{name}_ref") is getattr(rbla_agg_ref,
                                                       f"{name}_ref")


def test_backends_are_the_ports():
    assert tcore.BACKENDS == ("auto", "ref", "kernel", "distributed")
    assert tcore.resolve_backend("pallas", "cpu") == "kernel"
    assert tcore.resolve_backend("auto", "cpu") == "ref"
    assert tcore.resolve_backend("distributed", "cpu") == "distributed"
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.resolve_backend("tpu", "cpu")
    from repro_torch.core import strategy
    assert strategy.BACKENDS is tcore.BACKENDS
    assert strategy.resolve_backend is tcore.resolve_backend


def test_aggregators_hold_the_leaves():
    assert sorted(tcore.AGGREGATORS) == sorted(jcore.AGGREGATORS)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 8, 6)).astype(np.float32)
    m = (np.arange(8)[None, :, None]
         < rng.integers(1, 9, 5)[:, None, None]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    for name, leaf in tcore.AGGREGATORS.items():
        got = leaf(torch.from_numpy(x), torch.from_numpy(m),
                   torch.from_numpy(w))
        want = jcore.AGGREGATORS[name](jnp.asarray(x), jnp.asarray(m),
                                       jnp.asarray(w))
        assert_close(got, want, F32_TOL, name)


def _cohort(seed):
    adapters, _, weights = hetero_cohort(n=5, seed=seed)
    stacked = jax_stack_trees(adapters)
    masks = jax_stack_trees([jax_adapter_masks(a) for a in adapters])
    prev = jax.tree.map(lambda t: t[0] * 0.5, stacked)
    return stacked, masks, weights, prev


def _close_trees(got, want, msg):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_trees(got[k], v, f"{msg}/{k}")
        else:
            assert_close(got[k], v, F32_TOL, f"{msg}/{k}")


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("method", ["rbla", "zeropad"])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_shim_matches_jax(method, with_prev, seed):
    stacked, masks, w, prev = _cohort(seed)
    want = jcore.aggregate(stacked, masks, w, method=method,
                           prev_tree=prev if with_prev else None)
    got = tcore.aggregate(port_tree(stacked), port_tree(masks),
                          torch.as_tensor(np.array(w)), method=method,
                          prev_tree=port_tree(prev) if with_prev else None)
    _close_trees(got, jax.tree.map(np.asarray, want), method)


def test_aggregate_shim_refuses_an_unknown_method():
    stacked, masks, w, _ = _cohort(0)
    with pytest.raises(ValueError):
        tcore.aggregate(port_tree(stacked), port_tree(masks),
                        torch.as_tensor(np.array(w)), method="nope")
