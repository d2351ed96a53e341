"""The port's roofline (``repro_torch.roofline``) against the JAX package's,
on the CPU.

* ``active_params``, ``model_flops_estimate`` and ``scan_correction`` equal
  JAX's for all ten archs (and the four input shapes);
* ``Roofline``'s terms on the H100 constants: compute over 989 TFLOP/s,
  memory over 3.35 TB/s, collectives over NVLink (450 GB/s) within a node
  of 8 and over the network (50 GB/s) beyond; its ``as_dict`` keys are the
  reference's;
* ``DeviceCounts`` on plain tensors and ``collective_bytes`` on a known
  ``all_reduce`` and ``all_gather`` in a spawned fake world.
"""
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.roofline import DeviceCounts, Roofline, analysis, hw

from test_torch_dryrun import spawn_dryrun

ALL_ARCHS = sorted(ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_active_params_and_scan_correction_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert analysis.active_params(cfg) == janalysis.active_params(jcfg)
    assert analysis.scan_correction(cfg) == janalysis.scan_correction(jcfg)
    for spec, jspec in zip((u for s in cfg.stages for u in s.unit),
                           (u for s in jcfg.stages for u in s.unit)):
        assert analysis._block_params(cfg, spec) == \
            janalysis._block_params(jcfg, jspec)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_estimate_matches_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    s, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    n = analysis.active_params(cfg)
    for kind in ("train", "prefill", "decode"):
        assert analysis.model_flops_estimate(cfg, s, n, kind) == \
            janalysis.model_flops_estimate(jcfg, js, n, kind)


def test_h100_constants():
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.NVLINK_BW, hw.NET_BW,
            hw.GPUS_PER_NODE) == (989e12, 3.35e12, 450e9, 50e9, 8)
    assert "https://" in hw.__doc__


@pytest.mark.parametrize("chips,bw", [(1, 450e9), (8, 450e9), (16, 50e9),
                                      (512, 50e9)])
def test_roofline_terms_on_the_h100(chips, bw):
    r = Roofline(flops=2 * 989e12, hbm_bytes=3.35e12,
                 collective_bytes=4 * bw, chips=chips, model_flops=1e15,
                 collectives={"all-reduce": 4 * bw})
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(4.0)
    assert r.dominant == "collective"
    assert r.useful_flops_ratio == pytest.approx(1e15 / (2 * 989e12 * chips))
    j = janalysis.Roofline(flops=1.0, hbm_bytes=1.0, collective_bytes=1.0,
                           chips=chips)
    assert set(r.as_dict()) == set(j.as_dict())
    assert Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0,
                    chips=chips).useful_flops_ratio == 0.0


def test_roofline_dominant_term():
    assert Roofline(989e12, 1.0, 1.0, 1).dominant == "compute"
    assert Roofline(1.0, 3.35e13, 1.0, 1).dominant == "memory"


def test_device_counts_plain_ops():
    """A matmul's flops by the flop counter's formula; its operands and
    output once each; a view moves nothing; no collective."""
    a, b = torch.ones(8, 4), torch.ones(4, 16)
    with DeviceCounts() as c:
        y = a @ b
        y.t()
    assert c.flops == 2 * 8 * 4 * 16
    assert c.flops_by_op == {"aten.mm": 2 * 8 * 4 * 16}
    assert c.bytes == (8 * 4 + 4 * 16 + 8 * 16) * 4
    assert c.collectives == {}


def test_collective_bytes_in_a_fake_world(tmp_path):
    """A 6 x 5 fp32 all-reduce over "model" and all-gather over "data" of a
    (2, 2) fake world: each rank's output bytes, under the reference's
    names (the spawned child starts the world)."""
    got = spawn_dryrun(tmp_path, ["collectives"])["collectives"]
    assert got == {"all-reduce": 6 * 5 * 4, "all-gather": 2 * 6 * 5 * 4}
