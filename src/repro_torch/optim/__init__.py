from .optimizers import Optimizer, adam, adamw, apply_updates, sgd
from .schedules import constant, cosine, exponential

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "sgd", "constant",
           "cosine", "exponential"]
