"""Tensor-tree checkpointing and a self-describing blob codec (the port's
copy of ``repro.checkpoint.io``, in a format of its own built from the
standard library: ``struct`` framing, ``zlib`` checksums, ``json`` for a
checkpoint's index and numpy ``.npy`` payloads).

Durability contract (the async service's crash-recovery layer,
:mod:`repro_torch.fl.durability`, checkpoints through this module):

* :func:`save` is **atomic**: payloads go to a uniquely named data file,
  everything is fsynced, and the index -- the commit point -- is
  installed with an atomic rename.  A crash at any instant leaves either
  the previous checkpoint or the new one, never a torn hybrid.
* :func:`restore` **validates** before it trusts: every leaf's recorded
  kind, shape, dtype and payload checksum must match; a missing path, a
  size mismatch or a corrupt payload raises :class:`CheckpointError`
  naming the leaf.
* The leaf codec carries what the service holds: tensors of any device
  (bf16 stored as its uint16 bits under a dtype tag, int8 as it is),
  numpy arrays and scalars, ``torch.Generator`` states
  (:class:`GeneratorState`, under a tag of their own), and Python
  ``bool`` / ``int`` / ``float`` / ``str`` scalars, which come back as
  scalars, not 0-d tensors.

:func:`pack_obj` / :func:`unpack_obj` serialise self-describing objects
-- nested dicts (in insertion order), lists, tuples, ``None``, scalars,
strings, bytes and the leaves above -- which is what the write-ahead log
and the service snapshots use.  :func:`atomic_write_bytes` is the shared
rename-commit primitive.

**The stream rule.**  Card tensors are read to the host by
:func:`host_copy` on the stream that wrote them (``stream=``; default the
device's current stream): asynchronous copies into pinned memory, then
one event a stream, and nothing reads the host copies before the event
completes.  Decoded tensors are host tensors; the caller places them.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import uuid
import zlib
from typing import Any

import numpy as np
import torch

Tree = Any

_KIND_TENSOR = "tensor"
_KIND_NUMPY = "numpy"
_KIND_SCALAR = "scalar"
_KIND_GENERATOR = "generator"

_INDEX = "index.json"
_FORMAT = 1
_BLOB_MAGIC = b"RTB1"

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_PY_SCALARS = {"bool": bool, "int": int, "float": float, "str": str}


class CheckpointError(ValueError):
    """A checkpoint that cannot be trusted: missing leaves, kind, shape or
    dtype mismatches against the restore target, checksum failures, torn
    or unparseable files.  Subclasses ``ValueError``."""


@dataclasses.dataclass(frozen=True)
class GeneratorState:
    """A ``torch.Generator``'s state, as bytes, and the device type it
    belongs to (a CUDA generator's state is its Philox seed and offset, a
    CPU generator's the Mersenne Twister's).  A snapshot carries this in
    place of the generator, which goes on drawing."""
    device: str
    state: bytes

    @classmethod
    def of(cls, gen: torch.Generator) -> "GeneratorState":
        return cls(device=gen.device.type,
                   state=gen.get_state().numpy().tobytes())

    def generator(self, device=None) -> torch.Generator:
        """A fresh generator on ``device`` (default: the recorded device
        type) in this state."""
        dev = torch.device(self.device if device is None else device)
        if dev.type != self.device:
            raise CheckpointError(
                f"a {self.device} generator state cannot seed a generator "
                f"on {dev}")
        gen = torch.Generator(device=dev)
        gen.set_state(torch.frombuffer(bytearray(self.state),
                                       dtype=torch.uint8))
        return gen


# ------------------------------------------------------------ atomic I/O --
def _fsync_dir(dirname: str) -> None:
    """Flush directory metadata so a rename survives a crash (no-op where
    a directory cannot be opened)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: a uniquely named temp file in
    the same directory, flush + fsync, then rename-commit (and fsync the
    directory).  Readers see the old contents or the new, never a
    prefix."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".tmp-{uuid.uuid4().hex}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(d)


# ----------------------------------------------------- reading the card --
def _map(fn, tree):
    """``fn`` over every non-container leaf; dicts keep their order."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def host_copy(tree: Tree, stream=None) -> Tree:
    """``tree`` with every card tensor copied to the host and every
    ``torch.Generator`` replaced by its :class:`GeneratorState`.

    The copies are issued on ``stream`` (default: each tensor's device's
    current stream) -- the stream that wrote the tensors -- into pinned
    buffers, asynchronously; one event a stream is recorded after them and
    waited on before this returns, so no copy is read unfinished.  Host
    tensors and other leaves pass through as they are."""
    pending: dict = {}

    def leaf(x):
        if isinstance(x, torch.Generator):
            return GeneratorState.of(x)
        if not (isinstance(x, torch.Tensor) and x.device.type == "cuda"):
            return x
        s = stream if stream is not None else torch.cuda.current_stream(
            x.device)
        dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        with torch.cuda.stream(s):
            dst.copy_(x, non_blocking=True)
        pending[s] = s
        return dst

    out = _map(leaf, tree)
    for s in pending:
        done = torch.cuda.Event()
        done.record(s)
        done.synchronize()
    return out


# ------------------------------------------------------------ leaf codec --
def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _encode_leaf(leaf) -> tuple[dict, bytes]:
    """One host leaf -> (index entry, payload bytes)."""
    if isinstance(leaf, GeneratorState):
        raw = leaf.state
        return {"kind": _KIND_GENERATOR, "device": leaf.device,
                "crc": zlib.crc32(raw)}, raw
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise CheckpointError(
                f"a {leaf.device} tensor reached the encoder; read it with "
                "host_copy on the stream that wrote it")
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            # .npy cannot carry bf16: store its bits as uint16 under a tag
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            try:
                arr = t.numpy()
            except TypeError as e:
                raise CheckpointError(
                    f"cannot store a {t.dtype} tensor ({e})") from e
        raw = _npy(arr)
        return {"kind": _KIND_TENSOR, "dtype": _dtype_name(t.dtype),
                "shape": list(t.shape), "crc": zlib.crc32(raw)}, raw
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.asarray(leaf)
        if arr.dtype == object:
            raise CheckpointError("cannot store an object array")
        raw = _npy(arr)
        return {"kind": _KIND_NUMPY, "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "scalar": isinstance(leaf, np.generic),
                "crc": zlib.crc32(raw)}, raw
    raise CheckpointError(f"cannot store a leaf of type {type(leaf).__name__}")


def _load_npy(raw: bytes, where: str) -> np.ndarray:
    try:
        return np.load(io.BytesIO(raw), allow_pickle=False)
    except Exception as e:          # any parse failure is an untrusted file
        raise CheckpointError(f"{where}: unreadable payload ({e})") from e


def _decode_leaf(entry: dict, raw: bytes, where: str):
    """Inverse of :func:`_encode_leaf`; validates the checksum, shape and
    dtype.  Tensors come back on the host."""
    kind = entry.get("kind")
    if kind == _KIND_SCALAR:
        py = _PY_SCALARS.get(entry.get("pykind"))
        if py is None:
            raise CheckpointError(f"{where}: unknown scalar kind "
                                  f"{entry.get('pykind')!r}")
        return py(entry["value"])
    if zlib.crc32(raw) != entry.get("crc"):
        raise CheckpointError(f"{where}: payload checksum mismatch (corrupt "
                              "or torn checkpoint data)")
    if kind == _KIND_GENERATOR:
        return GeneratorState(device=str(entry["device"]), state=bytes(raw))
    if kind not in (_KIND_TENSOR, _KIND_NUMPY):
        raise CheckpointError(f"{where}: unknown leaf kind {kind!r}")
    arr = _load_npy(raw, where)
    if list(arr.shape) != list(entry["shape"]):
        raise CheckpointError(f"{where}: payload shape {list(arr.shape)} "
                              f"!= recorded {entry['shape']}")
    if kind == _KIND_NUMPY:
        if str(arr.dtype) != entry["dtype"]:
            raise CheckpointError(f"{where}: payload dtype {arr.dtype} != "
                                  f"recorded {entry['dtype']}")
        return arr[()] if entry.get("scalar") else arr
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if _dtype_name(t.dtype) != entry["dtype"]:
        raise CheckpointError(f"{where}: payload dtype {t.dtype} != recorded "
                              f"{entry['dtype']}")
    return t


def _is_py_scalar(x) -> bool:
    return isinstance(x, (bool, int, float, str)) and not isinstance(
        x, np.generic)


# ------------------------------------------------------- path-index save --
def _flatten_with_paths(tree: Tree, prefix: str = "") -> tuple[list, list]:
    """``(paths, leaves)`` in traversal order; ``None`` is an empty
    subtree, as in ``jax.tree``."""
    if tree is None:
        return [], []
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        paths, leaves = [], []
        for k, v in items:
            p, lv = _flatten_with_paths(v, f"{prefix}{k}/")
            paths += p
            leaves += lv
        return paths, leaves
    return [prefix[:-1]], [tree]


def _unflatten(like: Tree, leaves: list) -> Tree:
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def save(path: str, tree: Tree, stream=None) -> None:
    """Atomically checkpoint ``tree`` under directory ``path``.

    Card tensors are read on ``stream`` (see :func:`host_copy`).  Payloads
    land in a fresh ``data-<token>.bin``; the index rename is the commit
    point, after which superseded data files are pruned.  A crash anywhere
    in between leaves the previous checkpoint loadable."""
    os.makedirs(path, exist_ok=True)
    paths, leaves = _flatten_with_paths(host_copy(tree, stream))
    data_name = f"data-{uuid.uuid4().hex[:12]}.bin"
    index = []
    with open(os.path.join(path, data_name), "wb") as f:
        for p, leaf in zip(paths, leaves):
            if _is_py_scalar(leaf):
                index.append({"path": p, "kind": _KIND_SCALAR, "value": leaf,
                              "pykind": type(leaf).__name__})
                continue
            entry, raw = _encode_leaf(leaf)
            entry.update(path=p, offset=f.tell(), size=len(raw))
            index.append(entry)
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    atomic_write_bytes(os.path.join(path, _INDEX), json.dumps(
        {"format": _FORMAT, "data": data_name, "leaves": index}).encode())
    for name in os.listdir(path):          # prune superseded data files
        if name.startswith("data-") and name != data_name:
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def _load_index(path: str) -> dict:
    index_path = os.path.join(path, _INDEX)
    if not os.path.exists(index_path):
        raise CheckpointError(f"no checkpoint index at {index_path}")
    try:
        with open(index_path, "rb") as f:
            index = json.loads(f.read())
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"unreadable checkpoint index {index_path} ({e})") from e
    if not isinstance(index, dict) or "leaves" not in index:
        raise CheckpointError(f"malformed checkpoint index {index_path}")
    if index.get("format") != _FORMAT:
        raise CheckpointError(f"checkpoint {path}: format "
                              f"{index.get('format')!r}, want {_FORMAT}")
    return index


def _check_kind(p: str, entry: dict, want) -> None:
    """The stored leaf must be the restore target's kind, shape and dtype
    (restore never casts)."""
    kind = entry.get("kind")
    if isinstance(want, torch.Tensor):
        expect, dtype, shape = (_KIND_TENSOR, _dtype_name(want.dtype),
                                list(want.shape))
    elif isinstance(want, (np.ndarray, np.generic)):
        arr = np.asarray(want)
        expect, dtype, shape = _KIND_NUMPY, str(arr.dtype), list(arr.shape)
    elif isinstance(want, (torch.Generator, GeneratorState)):
        expect, dtype, shape = _KIND_GENERATOR, None, None
    elif _is_py_scalar(want):
        expect, dtype, shape = _KIND_SCALAR, None, None
        if kind == expect and entry.get("pykind") != type(want).__name__:
            raise CheckpointError(f"{p}: stored a python "
                                  f"{entry.get('pykind')}, restore target is "
                                  f"a python {type(want).__name__}")
    else:
        raise CheckpointError(f"{p}: cannot restore into a "
                              f"{type(want).__name__}")
    if kind != expect:
        raise CheckpointError(f"{p}: stored a {kind} leaf, restore target "
                              f"is a {expect} leaf")
    if shape is not None and list(entry["shape"]) != shape:
        raise CheckpointError(f"{p}: shape {tuple(entry['shape'])} != "
                              f"{tuple(shape)}")
    if dtype is not None and entry["dtype"] != dtype:
        raise CheckpointError(f"{p}: dtype {entry['dtype']} != {dtype} "
                              "(restore never casts silently)")


def restore(path: str, like: Tree, device=None) -> Tree:
    """Restore into the structure of ``like``.

    Every leaf is validated before it is trusted: an entry must exist for
    each of ``like``'s paths with its kind, shape and dtype (no silent
    cast), and payload checksums must verify; any mismatch raises
    :class:`CheckpointError` naming the leaf.  Tensors land on ``device``
    (default: the ``like`` tensor's device); generators come back as a
    generator on ``like``'s (or ``device``'s) device, Python scalars as
    scalars."""
    index = _load_index(path)
    by_path = {e["path"]: e for e in index["leaves"]}
    paths, leaves = _flatten_with_paths(like)
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise CheckpointError(
            f"checkpoint {path} is missing leaves {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''} (have {len(by_path)}, "
            f"want {len(paths)})")
    data_name = index.get("data", "")
    data_path = os.path.join(path, data_name)
    if not os.path.isfile(data_path):
        raise CheckpointError(f"checkpoint {path}: index references missing "
                              f"payload file {data_name!r}")
    out = []
    with open(data_path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        for p, want in zip(paths, leaves):
            e = by_path[p]
            _check_kind(p, e, want)
            raw = b""
            if e["kind"] != _KIND_SCALAR:
                if e["offset"] + e["size"] > size:
                    raise CheckpointError(
                        f"{p}: payload extends past the end of {data_name} "
                        "(truncated checkpoint)")
                f.seek(e["offset"])
                raw = f.read(e["size"])
            value = _decode_leaf(e, raw, where=p)
            if isinstance(want, torch.Tensor):
                value = value.to(want.device if device is None else device)
            elif isinstance(want, torch.Generator):
                value = value.generator(want.device if device is None
                                        else device)
            out.append(value)
    return _unflatten(like, out)


# --------------------------------------------- self-describing blob codec --
def _put(out: bytearray, obj) -> None:
    if obj is None:
        out += b"n"
    elif isinstance(obj, bool):
        out += b"T" if obj else b"F"
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        if not -(1 << 63) <= obj < (1 << 63):
            raise CheckpointError(f"cannot store the int {obj}: past 64 bits")
        out += b"i" + _I64.pack(obj)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out += b"f" + _F64.pack(obj)
    elif isinstance(obj, str):
        s = obj.encode("utf-8")
        out += b"s" + _U32.pack(len(s)) + s
    elif isinstance(obj, (bytes, bytearray)):
        out += b"y" + _U64.pack(len(obj)) + bytes(obj)
    elif isinstance(obj, dict):
        out += b"d" + _U32.pack(len(obj))
        for k, v in obj.items():
            _put(out, k)
            _put(out, v)
    elif isinstance(obj, (list, tuple)):
        out += (b"t" if isinstance(obj, tuple) else b"l") + _U32.pack(
            len(obj))
        for v in obj:
            _put(out, v)
    else:                       # tensors, numpy, generator states
        entry, raw = _encode_leaf(obj)
        out += b"a"
        _put(out, entry)
        out += _U64.pack(len(raw)) + raw


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise CheckpointError("truncated blob")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _get(r: _Reader):
    tag = bytes(r.take(1))
    if tag == b"n":
        return None
    if tag in (b"T", b"F"):
        return tag == b"T"
    if tag == b"i":
        return r.unpack(_I64)
    if tag == b"f":
        return r.unpack(_F64)
    if tag == b"s":
        return bytes(r.take(r.unpack(_U32))).decode("utf-8")
    if tag == b"y":
        return bytes(r.take(r.unpack(_U64)))
    if tag == b"d":
        n = r.unpack(_U32)
        out = {}
        for _ in range(n):
            k = _get(r)
            out[k] = _get(r)
        return out
    if tag in (b"l", b"t"):
        items = [_get(r) for _ in range(r.unpack(_U32))]
        return tuple(items) if tag == b"t" else items
    if tag == b"a":
        entry = _get(r)
        if not isinstance(entry, dict):
            raise CheckpointError("malformed blob leaf entry")
        raw = bytes(r.take(r.unpack(_U64)))
        return _decode_leaf(entry, raw, where="<blob>")
    raise CheckpointError(f"unknown blob node tag {tag!r}")


def pack_obj(obj, stream=None) -> bytes:
    """Serialise a self-describing object graph (dict / list / tuple /
    None / bool / int / float / str / bytes / tensors incl. bf16 / numpy /
    generator states) to bytes.  Card tensors are read on ``stream`` (see
    :func:`host_copy`).  Deterministic for a given object; dicts keep
    their insertion order."""
    out = bytearray(_BLOB_MAGIC)
    _put(out, host_copy(obj, stream))
    return bytes(out)


def unpack_obj(data: bytes):
    """Inverse of :func:`pack_obj` (checksum-validated payloads); tensors
    come back on the host."""
    if bytes(data[:len(_BLOB_MAGIC)]) != _BLOB_MAGIC:
        raise CheckpointError("unreadable blob (bad magic)")
    r = _Reader(data)
    r.take(len(_BLOB_MAGIC))
    try:
        obj = _get(r)
    except (struct.error, UnicodeDecodeError, ValueError, TypeError,
            KeyError) as e:
        if isinstance(e, CheckpointError):
            raise
        raise CheckpointError(f"unreadable blob ({e})") from e
    if r.pos != len(r.data):
        raise CheckpointError(f"unreadable blob ({len(r.data) - r.pos} "
                              "trailing bytes)")
    return obj


def save_blob(path: str, obj, fsync: bool = True, stream=None) -> int:
    """Atomically write one :func:`pack_obj` blob behind an 8-byte length
    and a 4-byte crc32; returns the bytes written.  The rename is the
    commit point."""
    payload = pack_obj(obj, stream)
    framed = (len(payload).to_bytes(8, "little")
              + zlib.crc32(payload).to_bytes(4, "little") + payload)
    atomic_write_bytes(path, framed, fsync=fsync)
    return len(framed)


def load_blob(path: str):
    """Read back a :func:`save_blob` file; raises :class:`CheckpointError`
    on truncation or a checksum mismatch."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise CheckpointError(f"{path}: truncated blob header")
        size = int.from_bytes(head[:8], "little")
        crc = int.from_bytes(head[8:12], "little")
        payload = f.read(size)
    if len(payload) != size:
        raise CheckpointError(f"{path}: truncated blob payload "
                              f"({len(payload)} of {size} bytes)")
    if zlib.crc32(payload) != crc:
        raise CheckpointError(f"{path}: blob checksum mismatch")
    return unpack_obj(payload)


__all__ = ["CheckpointError", "GeneratorState", "atomic_write_bytes",
           "host_copy", "save", "restore", "pack_obj", "unpack_obj",
           "save_blob", "load_blob"]
