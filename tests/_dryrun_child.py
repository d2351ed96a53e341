"""The dry run's cases for ``tests/test_torch_dryrun.py`` and
``tests/test_torch_roofline.py``, in a process of their own: each case
starts a fake process group (``repro_torch.launch.dryrun.fake_world``),
which no pytest worker may.

    python tests/_dryrun_child.py OUT CASE [CASE ...]

Writes ``{case: result}`` as JSON to ``OUT``.  Imports the port only.
"""
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import chunk_len  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import flops as ssd_flops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.roofline import collective_bytes  # noqa: E402

GRANITE = {"reduced": True, "vocab_size": 512, "n_experts": 4,
           "experts_per_token": 2}
TRAIN = InputShape("t", 64, 8, "train")
DECODE = InputShape("d", 128, 8, "decode")
PREFILL = InputShape("p", 128, 4, "prefill")


def _rec(arch, shape, mesh, over=None, out=None):
    return dryrun.run_one(arch, None, False, out or "", mesh_shape=mesh,
                          shape=shape, cfg_overrides=over or {"reduced": True},
                          write=out is not None)


def _units(cfg, n):
    """``cfg`` with every stage repeated ``n`` times."""
    return dataclasses.replace(cfg, stages=tuple(
        dataclasses.replace(s, repeat=n) for s in cfg.stages))


def case(name, out_dir):
    if name == "granite_2x2":
        return {"train": _rec("granite-moe-3b-a800m", TRAIN, (2, 2), GRANITE,
                              out_dir),
                "decode": _rec("granite-moe-3b-a800m", DECODE, (2, 2),
                               GRANITE, out_dir)}
    if name == "dense_meshes":
        return {m: _rec("h2o-danube-3-4b", TRAIN, shape)
                for m, shape in (("1x1", (1, 1)), ("1x2", (1, 2)),
                                 ("2x2", (2, 2)))}
    if name == "mamba_prefill":
        cfg = get_config("mamba2-1.3b").reduced()
        rec = _rec("mamba2-1.3b", PREFILL, (1, 2))
        d_in = cfg.ssm_expand * cfg.d_model
        h = d_in // cfg.ssm_head_dim
        q = chunk_len(PREFILL.seq_len, cfg.ssm_chunk)
        one = ssd_flops(PREFILL.global_batch, PREFILL.seq_len, h // 2,
                        cfg.ssm_head_dim, cfg.ssm_state, q)
        return {"rec": rec, "layers": cfg.n_layers, "formula_per_layer": one}
    if name == "units":
        base = get_config("h2o-danube-3-4b").reduced()
        flops = []
        for n in (1, 2, 3):
            cfg = _units(base, n)
            with dryrun.fake_world(2):
                mesh = dryrun._mesh(False, (1, 2))
                counts, _ = dryrun.trace(cfg, TRAIN, mesh,
                                         make_model(cfg, scan_backend="ref"))
            flops.append(counts.flops)
        return {"flops": flops, "layers": [_units(base, n).n_layers
                                           for n in (1, 2, 3)]}
    if name == "skip":
        return {"yi": dryrun.run_one("yi-34b", "long_500k", False, out_dir),
                "mamba_reason": dryrun.skip_reason(
                    get_config("mamba2-1.3b"),
                    dryrun.INPUT_SHAPES["long_500k"])}
    if name == "collectives":
        import torch.distributed._functional_collectives as fc
        from torch._subclasses.fake_tensor import FakeTensorMode
        with dryrun.fake_world(4):
            mesh = dryrun._mesh(False, (2, 2))
            with FakeTensorMode():
                x = torch.empty(6, 5, dtype=torch.float32)
                got = collective_bytes(
                    lambda: (fc.all_reduce(x, "sum", mesh.get_group("model")),
                             fc.all_gather_tensor(x, 0,
                                                  mesh.get_group("data"))))
        return got
    raise ValueError(f"unknown case {name!r}")


def main(argv):
    out, names = argv[0], argv[1:]
    out_dir = str(Path(out).parent / "records")
    res = {name: case(name, out_dir) for name in names}
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
