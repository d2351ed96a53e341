"""The port's chunked SSD (``repro_torch.models.mamba.ssd_chunked``, the
plain version of the ``ssd_scan`` kernel) against the JAX package's
``ssd_chunked`` and its Pallas ``ssd_scan`` in interpret mode, against the
float64 sequential recurrence, and the wrapper's backend rule on the CPU;
and the CUDA kernel's four-phase decomposition (``ssd_scan_phases``)
against the same JAX functions, steep decay and a prime L included.

Tolerances: the port and the JAX ``ssd_chunked`` run the same fp32
arithmetic, so they agree within F32_TOL; the Pallas kernel takes its
cumulative sums as triangular matmuls, so it is held at the reference's own
2e-3 (``tests/test_kernels.py``); so is the float64 recurrence
(``tests/test_model_properties.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close

from repro.kernels import ssd_scan as jax_ssd_scan
from repro.models import mamba as jax_mamba
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import (chunk_len, ssd_scan,
                                          ssd_scan_phases, ssd_scan_ref)
from repro_torch.models import mamba as tm

SSD_TOL = 2e-3
# (b, l, h, p, n, chunk): tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [
    (1, 32, 2, 8, 16, 8),
    (2, 64, 4, 16, 32, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 48, 3, 8, 8, 16),
]


def _inputs(b, l, h, p, n, seed, dta_scale=0.5):
    rng = np.random.default_rng(seed)
    xdt = (rng.normal(size=(b, l, h, p)) * 0.5).astype(np.float32)
    dta = (-np.abs(rng.normal(size=(b, l, h))) * dta_scale).astype(
        np.float32)
    bm = (rng.normal(size=(b, l, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, l, n)) * 0.5).astype(np.float32)
    return xdt, dta, bm, cm


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _recurrence(xdt, dta, bm, cm, h_init=None):
    """The sequential recurrence in float64 (tests/test_model_properties.py's
    oracle), with an optional initial state."""
    b, l, h, p = xdt.shape
    n = bm.shape[-1]
    hs = (np.zeros((b, h, p, n)) if h_init is None
          else np.asarray(h_init, np.float64))
    ys = []
    for t in range(l):
        a = np.exp(np.asarray(dta[:, t], np.float64))
        hs = hs * a[..., None, None] + np.einsum(
            "bhp,bn->bhpn", np.asarray(xdt[:, t], np.float64),
            np.asarray(bm[:, t], np.float64))
        ys.append(np.einsum("bhpn,bn->bhp", hs,
                            np.asarray(cm[:, t], np.float64)))
    return np.stack(ys, 1), hs


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_jax(b, l, h, p, n, chunk):
    arrays = _inputs(b, l, h, p, n, b * l + h + n)
    y, hl = tm.ssd_chunked(*_torch(*arrays), chunk)
    jy, jh = jax_mamba.ssd_chunked(*_jax(*arrays), chunk)
    assert y.dtype == torch.float32 and y.shape == (b, l, h, p)
    assert_close(y, jy, F32_TOL, "y")
    assert_close(hl, jh, F32_TOL, "h_final")


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_cpu_matches_jax_pallas_kernel(b, l, h, p, n, chunk):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel run in interpret mode, as tests/test_kernels.py runs it."""
    arrays = _inputs(b, l, h, p, n, b * l + h + n)
    runtime.reset_counts()
    y, hl = ssd_scan(*_torch(*arrays), chunk=chunk)
    assert runtime.PLAIN_CALLS["ssd_scan"] == 1
    assert runtime.LAUNCHES["ssd_scan"] == 0
    jy, jh = jax_ssd_scan(*_jax(*arrays), chunk=chunk, interpret=True)
    assert_close(y, jy, SSD_TOL, "y")
    assert_close(hl, jh, SSD_TOL, "h_final")


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_with_h_init_matches_jax(b, l, h, p, n, chunk):
    arrays = _inputs(b, l, h, p, n, 7 + b * l)
    h0 = (np.random.default_rng(l).normal(size=(b, h, p, n)) * 0.5).astype(
        np.float32)
    y, hl = tm.ssd_chunked(*_torch(*arrays), chunk, torch.from_numpy(h0))
    jy, jh = jax_mamba.ssd_chunked(*_jax(*arrays), chunk, jnp.asarray(h0))
    assert_close(y, jy, F32_TOL, "y")
    assert_close(hl, jh, F32_TOL, "h_final")
    ry, rh = _recurrence(*arrays, h_init=h0)
    assert_close(y, ry, SSD_TOL, "y vs recurrence")
    assert_close(hl, rh, SSD_TOL, "h_final vs recurrence")


@pytest.mark.parametrize("l,chunk,seed", [(8, 4, 0), (16, 8, 1), (32, 16, 2),
                                          (32, 4, 3), (24, 16, 4)])
def test_ssd_chunked_matches_float64_recurrence(l, chunk, seed):
    arrays = _inputs(2, l, 3, 4, 5, seed)
    y, hl = tm.ssd_chunked(*_torch(*arrays), chunk)
    ry, rh = _recurrence(*arrays)
    assert_close(y, ry, SSD_TOL, "y")
    assert_close(hl, rh, SSD_TOL, "h_final")


def test_prime_length_takes_chunks_of_one():
    """L = 31 with chunk 8: no Q in 2..8 divides 31, so Q = 1 (31 chunks)."""
    assert chunk_len(31, 8) == 1
    arrays = _inputs(2, 31, 3, 8, 16, 31)
    y, hl = ssd_scan(*_torch(*arrays), chunk=8)
    jy, jh = jax_mamba.ssd_chunked(*_jax(*arrays), 8)
    assert_close(y, jy, F32_TOL, "y vs jax")
    assert_close(hl, jh, F32_TOL, "h_final vs jax")
    ry, rh = _recurrence(*arrays)
    assert_close(y, ry, SSD_TOL, "y vs recurrence")
    assert_close(hl, rh, SSD_TOL, "h_final vs recurrence")


def test_large_decay_stays_finite():
    """|dta| large enough that a_cs passes -100 within one chunk: the upper
    triangle of the segment sums is +100 and more, whose exponential
    overflows; masking keeps every output finite and right."""
    arrays = _inputs(1, 64, 2, 16, 32, 5, dta_scale=8.0)
    acs = np.cumsum(arrays[1][0, :32, 0])
    assert acs[-1] < -100
    y, hl = ssd_scan(*_torch(*arrays), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(hl).all()
    jy, jh = jax_ssd_scan(*_jax(*arrays), chunk=32, interpret=True)
    assert_close(y, jy, SSD_TOL, "y vs pallas")
    assert_close(hl, jh, SSD_TOL, "h_final vs pallas")
    ry, rh = _recurrence(*arrays)
    assert_close(y, ry, SSD_TOL, "y vs recurrence")
    assert_close(hl, rh, SSD_TOL, "h_final vs recurrence")


@pytest.mark.parametrize("l,chunk", [(32, 8), (48, 16), (2000, 256), (31, 8),
                                     (7, 256), (1, 4)])
def test_chunk_len_is_the_reference_rule(l, chunk):
    q = min(chunk, l)
    while l % q:
        q -= 1
    assert chunk_len(l, chunk) == q
    assert l % chunk_len(l, chunk) == 0


def test_segsum_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 9)).astype(np.float32)
    got = tm._segsum(torch.from_numpy(x))
    want = np.asarray(jax_mamba._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6,
                               atol=1e-6)
    s = tm._segsum(torch.tensor([[1.0, 2.0, 3.0]]))[0]
    assert s[0, 0] == 0.0 and s[1, 0] == 2.0 and s[2, 0] == 5.0
    assert s[2, 1] == 3.0 and s[0, 1] == float("-inf")


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    got = tm._causal_conv(*_torch(x, w, b))
    want = jax_mamba._causal_conv(*_jax(x, w, b))
    assert_close(got, want, F32_TOL, "conv")
    # causal: the first output sees only the first input
    x2 = x.copy()
    x2[:, 1:] += 1.0
    got2 = tm._causal_conv(*_torch(x2, w, b))
    assert torch.equal(got2[:, 0], got[:, 0])


def test_backend_rule_on_the_cpu():
    arrays = _torch(*_inputs(1, 32, 2, 8, 16, 3))
    runtime.reset_counts()
    ssd_scan(*arrays, chunk=8)
    ssd_scan(*arrays, chunk=8, backend="ref")
    assert runtime.PLAIN_CALLS["ssd_scan"] == 2
    assert runtime.LAUNCHES["ssd_scan"] == 0
    for backend in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ssd_scan(*arrays, chunk=8, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        ssd_scan(*arrays, chunk=8, backend="nope")
    assert runtime.LAUNCHES["ssd_scan"] == 0
    y, hl = ssd_scan_ref(*arrays, 8)
    assert runtime.PLAIN_CALLS["ssd_scan"] == 3
    assert "ssd_scan" in runtime.KERNELS


def test_wrapper_refuses_mismatched_shapes():
    xdt, dta, bm, cm = _torch(*_inputs(1, 32, 2, 8, 16, 3))
    with pytest.raises(ValueError, match="needs dta"):
        ssd_scan(xdt, dta[:, :16], bm, cm, chunk=8)
    with pytest.raises(ValueError, match="needs dta"):
        ssd_scan(xdt, dta, bm, cm[..., :8], chunk=8)
    with pytest.raises(ValueError, match="must be"):
        ssd_scan(xdt[0], dta, bm, cm, chunk=8)


#: (b, l, h, p, n, chunk, |dta| scale): the SSD shapes, a decay past -100
#: within a chunk, a prime L (chunks of one step) and a ragged chunk (Q 250)
PHASE_CASES = [shape + (0.5,) for shape in SSD_SHAPES] + [
    (1, 64, 2, 16, 32, 32, 8.0),
    (2, 31, 3, 8, 16, 8, 0.5),
    (1, 500, 2, 8, 16, 256, 0.5),
]


@pytest.mark.parametrize("b,l,h,p,n,chunk,scale", PHASE_CASES)
def test_ssd_scan_phases_match_jax(b, l, h, p, n, chunk, scale):
    """The kernel's decomposition (a_cs and C B^T per chunk, chunk states,
    the carry, the outputs) against the JAX ``ssd_chunked`` and the Pallas
    kernel in interpret mode, at the reference's 2e-3; every output
    finite."""
    arrays = _inputs(b, l, h, p, n, 3 * l + h, dta_scale=scale)
    runtime.reset_counts()
    y, hl = ssd_scan_phases(*_torch(*arrays), chunk)
    assert runtime.PLAIN_CALLS["ssd_scan"] == 0
    assert y.shape == (b, l, h, p) and hl.shape == (b, h, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(hl).all()
    jy, jh = jax_mamba.ssd_chunked(*_jax(*arrays), chunk)
    assert_close(y, jy, SSD_TOL, "y vs ssd_chunked")
    assert_close(hl, jh, SSD_TOL, "h_final vs ssd_chunked")
    py, ph = jax_ssd_scan(*_jax(*arrays), chunk=chunk, interpret=True)
    assert_close(y, py, SSD_TOL, "y vs pallas")
    assert_close(hl, ph, SSD_TOL, "h_final vs pallas")


def test_ssd_scan_phases_in_bf16_match_the_plain_version():
    """bf16 operands: the decomposition computes on their fp32 upcast and
    rounds once, as the kernel does; within 2e-2 of the plain version on
    the same upcast."""
    arrays = _torch(*_inputs(2, 64, 4, 16, 32, 9))
    xdt, dta, bm, cm = arrays
    got = ssd_scan_phases(xdt.bfloat16(), dta, bm.bfloat16(), cm.bfloat16(),
                          16)
    want = ssd_scan_ref(xdt.bfloat16().float(), dta, bm.bfloat16().float(),
                        cm.bfloat16().float(), 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert_close(g, w, 2e-2)
