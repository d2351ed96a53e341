from . import hw
from .analysis import (DeviceCounts, Roofline, active_params,
                       collective_bytes, model_flops_estimate,
                       scan_correction)

__all__ = ["hw", "DeviceCounts", "Roofline", "active_params",
           "collective_bytes", "model_flops_estimate", "scan_correction"]
