from .optimizers import (Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, sgd)
from .schedules import constant, cosine, exponential

__all__ = ["Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "sgd", "constant", "cosine", "exponential"]
