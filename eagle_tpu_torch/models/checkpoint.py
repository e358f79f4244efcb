"""Parameter checkpoints in flax's msgpack format, read and written without
flax or the ``msgpack`` package (counterpart of the JAX package's
``eagle_tpu/models/checkpoint.py``: ``load_params``, ``save_params``,
``convert_and_save``).

The JAX package persists converted parameter pytrees with
``flax.serialization.to_bytes``: a msgpack document of nested maps whose
array leaves are msgpack extension objects of type 1, each holding a packed
``[shape, dtype name, raw C-order bytes]``.  flax writes lists and tuples
as maps keyed ``"0"``, ``"1"``, ... and ``None`` as nil, which is how
:func:`load_params` returns them: :func:`eagle_tpu_torch.models.bridge.flatten_params`
joins those keys as it joins list indices, so the tree builds the port's
modules as it is.  The ``<path>.tree`` file beside a checkpoint (a pickled
JAX treedef) is not read: the port restores by the names of its own
modules.

The decoder knows the types such a document holds -- maps, arrays, str,
bin, nil, bool, int, float and the extension types 1 (array) and 3 (numpy
scalar, the same payload) -- and raises, naming it, on anything else.  It
joins flax's chunked arrays (leaves over 1 GiB, split into flat chunks).

The encoder (:func:`to_bytes`) writes the bytes
``flax.serialization.to_bytes`` writes for the same tree: lists as maps
keyed ``"0"``, ``"1"``, ..., array leaves as type-1 extensions (numpy
scalars type 3) in msgpack's smallest encodings, leaves over 1 GiB
chunked.  :func:`save_params` first maps the tree as the JAX package's
does (leaves through ``numpy.asarray``, dict keys sorted).  It writes no ``<path>.tree``: a JAX
treedef cannot be written without JAX, so the JAX package reads the file
with ``load_params(path, template=...)``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

#: flax's msgpack extension type codes
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
#: flax's ``MAX_CHUNK_SIZE``: leaves of more bytes are written in chunks
MAX_CHUNK_SIZE = 2**30


class _Reader:
    """A msgpack decoder over one in-memory document."""

    def __init__(self, data, where: str):
        self.buf = memoryview(data)
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} at byte {self.pos}; not a flax msgpack checkpoint this reader knows")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail("truncated document")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(self.unpack(">b"), n)
            return getattr(self, kind)(n)
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        self.fail(f"msgpack type byte 0x{b:02x} (not used by flax checkpoints)")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                self.fail(f"map key {key!r} that is not a string")
            out[key] = self.value()
        if _CHUNKED in out:  # flax's chunked leaf: flat chunks and the shape
            try:
                shape = tuple(out["shape"][str(i)] for i in range(len(out["shape"])))
                chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
                return np.concatenate(chunks).reshape(shape)
            except (KeyError, TypeError, ValueError):
                self.fail("a malformed flax chunked array (its shape and chunks do not make a leaf)")
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.fail(f"msgpack extension type {code} (only 1, an array, and 3, a numpy scalar, are read)")
        inner = _Reader(payload, f"{self.where} (array payload)")
        shape, name, raw = inner.value()
        name = name.decode() if isinstance(name, bytes) else name
        try:
            dtype = np.dtype(name)
        except TypeError:
            self.fail(f"array dtype {name!r}")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def load_params(path: str) -> dict:
    """A ``.msgpack`` checkpoint written by the JAX package's
    ``save_params`` -> the parameter tree as nested dicts (lists as maps
    keyed ``"0"``, ``"1"``, ...; ``None`` leaves kept) with numpy array
    leaves, bit-equal to what flax restores."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data, path)
    tree = reader.value()
    if reader.pos != len(data):
        reader.fail("trailing bytes after the document")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the document is a {type(tree).__name__}, not a parameter tree")
    return tree


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _head(out: list, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((byte, struct format, limit)) whose limit holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(out: list, v: int) -> None:
    """msgpack's smallest encoding of an int."""
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack cannot hold the int {v}")
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack cannot hold the int {v}")


def _array_payload(arr: np.ndarray) -> bytes:
    """flax's array payload: the msgpack of (shape, dtype name, C-order
    bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not written")
    out: list = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _pack(obj, out: list) -> None:
    """msgpack of ``obj`` as ``msgpack.packb(obj, strict_types=True)`` with
    flax's extension hook writes it."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, _STR)
        out.append(raw)
    elif type(obj) is bytes:
        _head(out, len(obj), None, 0, _BIN)
        out.append(obj)
    elif type(obj) is list:
        _head(out, len(obj), 0x90, 15, _ARRAY)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _head(out, len(obj), 0x80, 15, _MAP)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        payload = _array_payload(np.asarray(obj))
        if len(payload) in _FIXEXT:
            out.append(bytes([_FIXEXT[len(payload)]]))
        else:
            _head(out, len(payload), None, 0, _EXT)
        out.append(struct.pack(">b", code) + payload)
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} into a flax msgpack checkpoint")


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of a leaf over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _state(tree):
    """flax's state dict of a tree, as its serializer sees it: lists and
    tuples as maps keyed by index, keys as strings, in their order; array
    leaves over ``MAX_CHUNK_SIZE`` bytes chunked; other leaves as they
    are."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys {list(tree)} have no unique string form")
        return {str(k): _state(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _as_arrays(tree):
    """Every leaf through ``numpy.asarray`` (``None`` kept), as the JAX
    package's ``save_params`` maps it before writing, with JAX's tree map's
    effect on order: every dict's keys sorted."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_arrays(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_arrays(v) for v in tree)
    return np.asarray(tree)


def to_bytes(tree) -> bytes:
    """The bytes of ``flax.serialization.to_bytes`` of a tree of dicts,
    lists, tuples, ``None``, Python scalars, strings and numpy leaves."""
    out: list = []
    _pack(_state(tree), out)
    return b"".join(out)


def save_params(params, path: str) -> str:
    """Write a parameter tree -- the JAX package's layout (nested dicts and
    lists, HWIO conv kernels), or a port module, taken back to that layout
    by :func:`eagle_tpu_torch.models.bridge.params_from_module` -- as a
    flax msgpack checkpoint, every leaf through ``numpy.asarray`` first.  The JAX package reads it with
    ``load_params(path, template=...)``, this package with
    :func:`load_params`.  Returns ``path``."""
    import torch

    if isinstance(params, torch.nn.Module):
        from eagle_tpu_torch.models.bridge import params_from_module

        params = params_from_module(params)
    data = to_bytes(_as_arrays(params))
    with open(path, "wb") as f:
        f.write(data)
    return path


def convert_and_save(torch_path: str, out_path: str, kind: str) -> str:
    """A torch checkpoint -> a ``.msgpack`` one: ``kind`` "hrnet" (the
    reference's ``KeypointModel`` state dict) or "yolov8" (an ultralytics
    state dict, keys with or without the ``model.`` prefix).  As the JAX
    package, the file is loaded with ``torch.load(weights_only=False)`` (a
    trusted file: it may hold the module, whose ``state_dict()`` is taken)."""
    import torch

    from eagle_tpu_torch.models.convert import hrnet_from_torch, yolov8_from_torch

    sd = torch.load(torch_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "state_dict"):
        sd = sd["model"].state_dict()  # ultralytics .pt layout
    if kind == "hrnet":
        params = hrnet_from_torch(sd)
    elif kind == "yolov8":
        params = yolov8_from_torch(sd, prefix="model." if any(k.startswith("model.") for k in sd) else "")
    else:
        raise ValueError(f"unknown kind: {kind}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return save_params(params, out_path)
