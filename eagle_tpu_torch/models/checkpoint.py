"""Parameter checkpoints in flax's msgpack format, read without flax or the
``msgpack`` package (counterpart of the JAX package's
``eagle_tpu/models/checkpoint.py::load_params``).

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
scalar, the same payload) -- and raises, naming it, on anything else,
including flax's chunked arrays (leaves over 1 GiB).
"""

from __future__ import annotations

import struct

import numpy as np

#: flax's msgpack extension type codes
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


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
        if _CHUNKED in out:
            self.fail("a flax chunked array (a leaf over 1 GiB), which this reader does not join")
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
