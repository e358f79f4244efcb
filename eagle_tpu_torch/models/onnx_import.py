"""ONNX detector weights without the ``onnx`` package (counterpart of the
JAX package's ``eagle_tpu/models/onnx_import.py``).

The reference's CPU path loads ``detector_medium.onnx`` through ONNX
Runtime.  An ONNX file is a protobuf message; this module reads the part
that matters -- the graph's initializer tensors and its node list -- with a
small wire-format reader, and maps the initializers onto the YOLOv8
parameter pytree.  Ultralytics exports call ``model.fuse()`` first, so the
graph carries BN-fused conv weights named after the torch module tree
(``model.0.conv.weight``, ``model.0.conv.bias``, ...), which
:func:`~eagle_tpu_torch.models.convert.yolov8_from_fused` wraps in exactly-
identity BatchNorms; an unfused graph goes through the state-dict
converter.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

# protobuf wire types
_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5

#: TensorProto.DataType -> numpy dtype (the types model exports use)
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) over a serialized message: LEN
    fields give their bytes, varints their int, fixed32/64 their 4/8
    bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _LEN:
            size, pos = _read_varint(buf, pos)
            val = buf[pos : pos + size]
            pos += size
        elif wt == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:  # groups (3/4) do not occur in ONNX
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _packed_varints(val: bytes) -> list[int]:
    out, p = [], 0
    while p < len(val):
        v, p = _read_varint(val, p)
        out.append(v)
    return out


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, array), from ``raw_data`` or the typed
    repeated fields (float_data, int32_data / int64_data, double_data)."""
    dims: list[int] = []
    dtype = None
    name = ""
    raw = None
    floats: list[float] = []
    ints: list[int] = []
    doubles: list[float] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:  # dims
            dims.extend([val] if wt == _VARINT else _packed_varints(val))
        elif field == 2 and wt == _VARINT:
            dtype = val
        elif field == 8 and wt == _LEN:
            name = val.decode("utf-8")
        elif field == 9 and wt == _LEN:
            raw = val
        elif field == 4:  # float_data
            if wt == _I32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field in (5, 7):  # int32_data / int64_data
            ints.extend([val] if wt == _VARINT else _packed_varints(val))
        elif field == 10:  # double_data
            if wt == _I64:
                doubles.append(struct.unpack("<d", val)[0])
            else:
                doubles.extend(struct.unpack(f"<{len(val) // 8}d", val))
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif doubles:
        arr = np.asarray(doubles, np.float64)
    elif ints:
        # int64_data holds two's-complement varints
        arr = np.asarray([v - (1 << 64) if v >= (1 << 63) else v for v in ints]).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_node(buf: bytes) -> dict:
    node = {"input": [], "output": [], "name": "", "op_type": ""}
    for field, wt, val in _iter_fields(buf):
        if wt != _LEN:
            continue
        if field == 1:
            node["input"].append(val.decode("utf-8"))
        elif field == 2:
            node["output"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op_type"] = val.decode("utf-8")
    return node


def parse_onnx(path: str) -> tuple[dict[str, np.ndarray], list[dict]]:
    """An ``.onnx`` file -> (initializers {name: array}, nodes)."""
    with open(path, "rb") as f:
        model = f.read()
    graph = next((val for field, wt, val in _iter_fields(model) if field == 7 and wt == _LEN), None)
    if graph is None:
        raise ValueError(f"{path}: no graph in the ONNX model")
    initializers: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, wt, val in _iter_fields(graph):
        if field == 5 and wt == _LEN:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1 and wt == _LEN:  # GraphProto.node
            nodes.append(_parse_node(val))
    return initializers, nodes


def load_yolov8_onnx(path: str, prefix: str = "model."):
    """A detector ``.onnx`` -> the YOLOv8 parameter pytree, from a fused
    export (the published ultralytics files: conv biases, no BatchNorm
    initializers) or an unfused graph."""
    from eagle_tpu_torch.models.convert import yolov8_from_fused, yolov8_from_torch

    init, _nodes = parse_onnx(path)
    # some exporters put a wrapper's module path before the parameter names
    if not any(k.startswith(prefix) for k in init):
        for k in list(init):
            i = k.find(prefix)
            if i > 0:
                init[k[i:]] = init.pop(k)
    fused = any(k.endswith(".conv.bias") for k in init) and not any(k.endswith(".bn.weight") for k in init)
    return (yolov8_from_fused if fused else yolov8_from_torch)(init, prefix=prefix)
