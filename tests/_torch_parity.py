"""Shared helpers for the port's parity tests (``test_torch_*.py``): one
place converts between JAX, numpy and torch and states the tolerance rule
of ``tests/test_kernels.py`` (rtol = tol, atol = tol * max(1, max|want|);
tol 2e-5 in fp32, 2e-2 in bf16)."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_adapters, from_jax_params, to_numpy

F32_TOL = 2e-5
BF16_TOL = 2e-2


def np32(x) -> np.ndarray:
    """Any array-like (torch, jax, numpy, incl. bf16) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, tol=F32_TOL, msg=""):
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    assert np.isfinite(w).all(), f"{msg}: reference is not finite"
    scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale, err_msg=msg,
                               equal_nan=False)


def assert_trees_close(got, want, tol=F32_TOL, msg=""):
    """``got``: a port tree; ``want``: a JAX tree with the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{msg}: keys {set(got)} != {set(want)}"
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{msg}/{k}")
        return
    assert_close(got, want, tol, msg)


def jax_tree_to_numpy(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def port_tree(jax_tree, device="cpu"):
    """A JAX params/adapters tree as port tensors, through the bridge."""
    return from_jax_params(jax_tree_to_numpy(jax_tree), device)


def need_cuda():
    """Skip (inside a test, never at import) when there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


__all__ = ["F32_TOL", "BF16_TOL", "np32", "assert_close",
           "assert_trees_close", "jax_tree_to_numpy", "port_tree",
           "need_cuda", "from_jax_adapters", "from_jax_params", "to_numpy"]
