"""Checkpoint I/O: tensor-tree save/restore, the self-describing blob codec
and atomic writes (the port's copy of ``repro.checkpoint``)."""
from .io import (CheckpointError, GeneratorState, atomic_write_bytes,
                 host_copy, load_blob, pack_obj, restore, save, save_blob,
                 unpack_obj)

__all__ = ["restore", "save", "CheckpointError", "GeneratorState",
           "host_copy", "pack_obj", "unpack_obj", "save_blob", "load_blob",
           "atomic_write_bytes"]
