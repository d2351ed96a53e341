from .ops import ssd_scan
from .ref import chunk_len, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_ref", "chunk_len"]
