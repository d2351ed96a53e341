"""The port's checkpoint I/O (``repro_torch.checkpoint``) against the JAX
package's contract (``tests/test_durability.py``'s checkpoint tests,
mirrored): atomic save/restore of a tensor tree with bf16, int8, Python
scalars, strings and generator states; restore refusing kind, shape and
dtype drift and bit rot by name; the self-describing blob codec with its
framing, corruption checks and dict order.  The format is the port's own
(stdlib framing, ``.npy`` payloads): loading a JAX checkpoint is not a
goal, so the two packages are held to the same behaviour, not the same
bytes.  Every file lives under ``tmp_path``.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointError, GeneratorState,
                                    atomic_write_bytes, host_copy, load_blob,
                                    pack_obj, restore, save, save_blob,
                                    unpack_obj)


def _tree():
    return {
        "w": torch.tensor([[1.5, -2.25], [0.125, 3e-2]],
                          dtype=torch.bfloat16),
        "n": 7, "lr": 0.3, "on": True, "name": "rbla",
        "key": torch.Generator().manual_seed(42),
        "x": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "q": torch.tensor([[-127, 0, 5]], dtype=torch.int8),
    }


# ------------------------------------------------ checkpoint io hardening --
def test_checkpoint_roundtrips_bf16_scalars_and_keys(tmp_path):
    """bf16 (uint16 bits + tag), int8, Python scalars, strings and
    generator states survive save/restore bit-exactly; scalars come back
    as scalars, the generator as a generator drawing the same stream."""
    tree = _tree()
    path = str(tmp_path / "ck")
    save(path, tree)
    back = restore(path, tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert back["n"] == 7 and type(back["n"]) is int
    assert back["lr"] == 0.3 and type(back["lr"]) is float
    assert back["on"] is True and back["name"] == "rbla"
    assert isinstance(back["key"], torch.Generator)
    assert torch.equal(back["key"].get_state(), tree["key"].get_state())
    assert torch.equal(torch.rand(5, generator=back["key"]),
                       torch.rand(5, generator=tree["key"]))
    assert torch.equal(back["x"], tree["x"]) and back["x"].dtype == \
        torch.int32
    assert torch.equal(back["q"], tree["q"]) and back["q"].dtype == \
        torch.int8


def test_restore_rejects_shape_and_dtype_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    save(path, {"a": torch.zeros(2, 3)})
    with pytest.raises(CheckpointError, match="shape"):
        restore(path, {"a": torch.zeros(3, 2)})
    with pytest.raises(CheckpointError, match="dtype"):
        restore(path, {"a": torch.zeros(2, 3, dtype=torch.int32)})
    with pytest.raises(CheckpointError):
        restore(path, {"b": torch.zeros(2, 3)})


def test_restore_rejects_kind_mismatch_by_name(tmp_path):
    """A stored tensor never restores into a scalar, a scalar never into a
    tensor, an int never into a float: the leaf is named."""
    path = str(tmp_path / "ck")
    save(path, {"a": torch.zeros(2), "n": 3, "g": torch.Generator()})
    with pytest.raises(CheckpointError, match="a: stored a tensor"):
        restore(path, {"a": 1.0, "n": 3, "g": torch.Generator()})
    with pytest.raises(CheckpointError, match="n: stored a scalar"):
        restore(path, {"a": torch.zeros(2), "n": torch.zeros(()),
                       "g": torch.Generator()})
    with pytest.raises(CheckpointError, match="n: stored a python int"):
        restore(path, {"a": torch.zeros(2), "n": 3.0,
                       "g": torch.Generator()})
    with pytest.raises(CheckpointError, match="g: stored a generator"):
        restore(path, {"a": torch.zeros(2), "n": 3, "g": torch.zeros(2)})


def test_restore_detects_bit_rot(tmp_path):
    path = str(tmp_path / "ck")
    save(path, {"a": torch.ones(16, 16)})
    save(path, {"a": torch.ones(16, 16)})
    data = [n for n in os.listdir(path) if n.startswith("data-")]
    assert len(data) == 1            # stale payloads from prior saves pruned
    fp = os.path.join(path, data[0])
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match="checksum|corrupt"):
        restore(path, {"a": torch.ones(16, 16)})


def test_restore_refuses_truncation_and_a_missing_index(tmp_path):
    path = str(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="no checkpoint index"):
        restore(path, {"a": torch.ones(4)})
    save(path, {"a": torch.ones(64)})
    fp = [os.path.join(path, n) for n in os.listdir(path)
          if n.startswith("data-")][0]
    raw = open(fp, "rb").read()
    open(fp, "wb").write(raw[:len(raw) // 2])
    with pytest.raises(CheckpointError, match="truncated"):
        restore(path, {"a": torch.ones(64)})


def test_restore_places_tensors_on_the_requested_device(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"a": torch.arange(4.0), "g": torch.Generator().manual_seed(1)}
    save(path, tree)
    back = restore(path, tree, device="cpu")
    assert back["a"].device.type == "cpu"
    assert back["g"].device.type == "cpu"
    state = GeneratorState.of(tree["g"])
    with pytest.raises(CheckpointError, match="cannot seed"):
        state.generator("meta")


def test_blob_roundtrip_and_corruption(tmp_path):
    obj = {"replay": [[{"A": np.arange(4.0)}, 1.5]],
           "ids": ("u1", "u2"), "none": None, "raw": b"\x00\xff",
           "bf": torch.tensor([1.5, -0.25], dtype=torch.bfloat16)}
    path = str(tmp_path / "blob.bin")
    n = save_blob(path, obj)
    assert n == os.path.getsize(path)
    back = load_blob(path)
    assert back["ids"] == ("u1", "u2")     # a tuple stays a tuple
    assert back["none"] is None and back["raw"] == b"\x00\xff"
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"], obj["bf"])
    assert np.array_equal(back["replay"][0][0]["A"], obj["replay"][0][0]["A"])
    # truncation (a torn write) and bit rot both fail loudly
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) - 3])
    with pytest.raises(CheckpointError):
        load_blob(path)
    flipped = bytearray(raw)
    flipped[-1] ^= 0x01
    open(path, "wb").write(bytes(flipped))
    with pytest.raises(CheckpointError):
        load_blob(path)
    open(path, "wb").write(raw[:5])
    with pytest.raises(CheckpointError, match="header"):
        load_blob(path)


def test_pack_obj_preserves_dict_order():
    obj = {"z": 1, "a": 2, "m": 3}
    assert list(unpack_obj(pack_obj(obj))) == ["z", "a", "m"]


def test_pack_obj_carries_every_leaf_the_service_holds():
    """Python scalars come back as the same Python types, numpy scalars as
    numpy scalars, int8 and bf16 tensors in their dtypes, a generator as
    its state, and packing is deterministic."""
    gen = torch.Generator().manual_seed(9)
    obj = {"b": False, "i": -(1 << 63), "j": 12, "f": 0.1, "s": "ü",
           "t": (1, [2.5, None]), "np": np.float32(2.5),
           "i8": torch.tensor([-128, 127], dtype=torch.int8),
           "bf": torch.full((2, 3), 0.3).bfloat16(), "e": torch.zeros(0, 4),
           "gen": gen, 7: "int key"}
    data = pack_obj(obj)
    assert data == pack_obj(obj)
    back = unpack_obj(data)
    assert list(back) == list(obj)
    for k in ("b", "i", "j", "f", "s", "t", 7):
        assert back[k] == obj[k] and type(back[k]) is type(obj[k]), k
    assert back["np"] == obj["np"] and type(back["np"]) is np.float32
    for k in ("i8", "bf", "e"):
        assert back[k].dtype == obj[k].dtype and torch.equal(back[k], obj[k])
    assert isinstance(back["gen"], GeneratorState)
    assert torch.equal(back["gen"].generator().get_state(), gen.get_state())


def test_unpack_obj_refuses_garbage():
    data = pack_obj({"a": torch.arange(8.0), "b": "x"})
    for bad in (b"", b"XXXX" + data[4:], data[:-1], data + b"\x00"):
        with pytest.raises(CheckpointError):
            unpack_obj(bad)
    raw = bytearray(data)
    raw[-10] ^= 0xFF                   # inside the last tensor's payload
    with pytest.raises(CheckpointError):
        unpack_obj(bytes(raw))


def test_encoder_refuses_what_it_cannot_carry():
    with pytest.raises(CheckpointError, match="cannot store"):
        pack_obj({"x": object()})
    with pytest.raises(CheckpointError, match="object array"):
        pack_obj(np.array([object()], dtype=object))
    with pytest.raises(CheckpointError, match="64 bits"):
        pack_obj({"n": 1 << 64})


def test_host_copy_passes_host_leaves_and_snapshots_generators():
    """On the host nothing is copied (the service writes no tensor in
    place); a generator becomes its state at that instant."""
    t = torch.arange(3.0)
    gen = torch.Generator().manual_seed(3)
    out = host_copy({"t": t, "g": gen, "n": [1, None]})
    assert out["t"] is t and out["n"] == [1, None]
    snap = out["g"]
    torch.rand(4, generator=gen)
    assert torch.equal(snap.generator().get_state(),
                       torch.Generator().manual_seed(3).get_state())


def test_atomic_write_leaves_no_temp_files(tmp_path):
    path = tmp_path / "f.bin"
    atomic_write_bytes(str(path), b"one")
    atomic_write_bytes(str(path), b"two", fsync=False)
    assert path.read_bytes() == b"two"
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]
