"""Which weights get LoRA adapters (the paper: "dense layers only").

Models expose ``lora_specs()``: an ordered mapping ``path -> (fan_out,
fan_in)`` describing every LoRA-able 2-D projection.  Policies filter that
mapping; the FL layer and the big-model trainer both consume the filtered
specs, so changing the target set is one line of config.
"""
from __future__ import annotations

import re
from typing import Mapping


def filter_specs(specs: Mapping[str, tuple[int, int]],
                 include: str = ".*",
                 exclude: str | None = None) -> dict[str, tuple[int, int]]:
    inc = re.compile(include)
    exc = re.compile(exclude) if exclude else None
    out = {}
    for path, shape in specs.items():
        if inc.search(path) and not (exc and exc.search(path)):
            out[path] = shape
    return out


# Named policies used by configs.
POLICIES = {
    "all_dense": dict(include=r".*"),
    "attention_only": dict(include=r"(attn|attention)"),
    "mlp_only": dict(include=r"(mlp|ffn|fc)"),
    # paper experiments: LoRA on dense (fc) layers, conv/bias full-trained
    "paper_dense": dict(include=r"fc|dense|out"),
}


def apply_policy(specs: Mapping[str, tuple[int, int]],
                 policy: str = "all_dense") -> dict[str, tuple[int, int]]:
    return filter_specs(specs, **POLICIES[policy])
