from .ops import ssd_scan
from .ref import chunk_len, ssd_scan_phases, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_scan_phases", "chunk_len"]
