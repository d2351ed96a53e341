from . import rules
from .rules import P

__all__ = ["rules", "P"]
