"""What the harness takes from the program: its configuration object for a
configuration file, and the layout (shapes and dtypes, on the meta
device) of its weights and adapters.  The values always come from the
benchmark's own seeded fill (:mod:`gpubench.lib.seeded`)."""
from __future__ import annotations

import dataclasses


def build_arch(config: dict, overrides: dict | None = None):
    """The program's ``ArchConfig`` for ``config`` (a
    ``gpubench/configs/<name>.json``): the program's registered arch with
    every field of ``config["arch"]`` set.  ``n_layers``, where the file
    gives it, is the repeat of the arch's one stage of one block; without
    it the registered stages stand.  ``window`` is set on every attention
    block.  ``overrides`` (tests at tiny widths) are set over
    ``config["arch"]``.  Raises if a field of the file has no
    counterpart."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    base = get_config(config["program_arch"])
    fields = dict(config["arch"])
    fields.update(overrides or {})
    n_layers = fields.pop("n_layers", None)
    window = fields.pop("window", None)
    fields.pop("block", None)
    unknown = [k for k in fields if not hasattr(base, k)]
    if unknown:
        raise KeyError(f"{config['name']}: fields {unknown} are not in the "
                       "program's ArchConfig")
    stages = base.stages
    if n_layers is not None:
        if len(stages) != 1 or len(stages[0].unit) != 1:
            raise ValueError(f"{config['name']}: n_layers is the depth of "
                             "one stage of one block; leave it out to keep "
                             "the program's stages")
        stages = (Stage(unit=stages[0].unit, repeat=int(n_layers)),)
    if window is not None:
        stages = tuple(dataclasses.replace(st, unit=tuple(
            b if b.kind == "mamba" else dataclasses.replace(
                b, window=int(window)) for b in st.unit)) for st in stages)
    return dataclasses.replace(base, stages=stages, **fields)


def structures(arch, r_max: int):
    """(weights, adapters) of ``arch`` on the meta device: the program's
    layout, no memory."""
    from repro_torch.models.common import MetaGenerator
    from repro_torch.models.model import make_model
    model = make_model(arch)
    return (model.init(MetaGenerator()),
            model.init_adapters(MetaGenerator(), r_max=r_max, rank=r_max))
