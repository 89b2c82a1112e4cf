"""Minimal protobuf wire-format encoder for ONNX ModelProto.

The port's own copy of ``paddle_tpu/onnx/_proto.py`` (the port reads
nothing of the JAX package).

The environment has no ``onnx`` package, but the protobuf wire format is
simple and stable (varints + length-delimited submessages), so a real
``.onnx`` file can be emitted without the dependency. Field numbers
below follow onnx/onnx.proto (IR version 8 / opset 13 layout).

Only the message shapes the exporter emits are encoded; the companion
``decode_model`` implements the inverse for the self-check tests (and
doubles as documentation of what was written).
"""
from __future__ import annotations

import struct
from typing import List, Tuple

# ONNX TensorProto.DataType
FLOAT, INT64, INT32, BOOL = 1, 7, 6, 9
FLOAT16, DOUBLE, INT8, UINT8 = 10, 11, 3, 2

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def _varint(n: int) -> bytes:
    out = bytearray()
    if n < 0:
        n += 1 << 64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def tensor_proto(name: str, dims: Tuple[int, ...], data_type: int,
                 raw: bytes) -> bytes:
    out = b""
    for d in dims:
        out += _int_field(1, d)
    out += _int_field(2, data_type)
    out += _str_field(8, name)
    out += _len_field(9, raw)  # raw_data
    return out


def attribute(name: str, *, i=None, f=None, s=None, ints=None,
              floats=None, t=None) -> bytes:
    out = _str_field(1, name)
    if i is not None:
        out += _int_field(3, i) + _int_field(20, ATTR_INT)
    elif f is not None:
        out += _tag(2, 5) + struct.pack("<f", f) + _int_field(20, ATTR_FLOAT)
    elif s is not None:
        out += _len_field(4, s.encode()) + _int_field(20, ATTR_STRING)
    elif ints is not None:
        for v in ints:
            out += _int_field(8, v)
        out += _int_field(20, ATTR_INTS)
    elif floats is not None:
        for v in floats:
            out += _tag(7, 5) + struct.pack("<f", v)
        out += _int_field(20, ATTR_FLOATS)
    elif t is not None:
        out += _len_field(5, t) + _int_field(20, ATTR_TENSOR)
    return out


def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str = "", attrs: List[bytes] = ()) -> bytes:
    out = b""
    for x in inputs:
        out += _str_field(1, x)
    for y in outputs:
        out += _str_field(2, y)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for a in attrs:
        out += _len_field(5, a)
    return out


def value_info(name: str, elem_type: int, shape: Tuple[int, ...]) -> bytes:
    dims = b""
    for d in shape:
        dims += _len_field(1, _int_field(1, d))  # Dimension.dim_value
    tensor_t = _int_field(1, elem_type) + _len_field(2, dims)
    type_p = _len_field(1, tensor_t)  # TypeProto.tensor_type
    return _str_field(1, name) + _len_field(2, type_p)


def graph(nodes: List[bytes], name: str, initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes]) -> bytes:
    out = b""
    for n in nodes:
        out += _len_field(1, n)
    out += _str_field(2, name)
    for t in initializers:
        out += _len_field(5, t)
    for v in inputs:
        out += _len_field(11, v)
    for v in outputs:
        out += _len_field(12, v)
    return out


def model(graph_bytes: bytes, opset: int = 13,
          producer: str = "paddle-tpu") -> bytes:
    opset_id = _int_field(2, opset)  # OperatorSetIdProto.version
    out = _int_field(1, 8)  # ir_version 8
    out += _str_field(2, producer)
    out += _len_field(7, graph_bytes)
    out += _len_field(8, opset_id)
    return out


# ----------------------------------------------------------- decoder ----
def _read_varint(buf, off):
    shift, val = 0, 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) triples."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            v = buf[off:off + ln]
            off += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[off:off + 4])[0]
            off += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[off:off + 8])[0]
            off += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def decode_model(buf: bytes) -> dict:
    """Inverse of ``model`` for the emitted subset — self-check +
    documentation."""
    import numpy as np

    m = {"opset": None, "producer": None, "graph": None}
    for field, _, v in _fields(buf):
        if field == 1:
            m["ir_version"] = v
        elif field == 2:
            m["producer"] = v.decode()
        elif field == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    m["opset"] = v2
        elif field == 7:
            g = {"nodes": [], "initializers": {}, "inputs": [],
                 "outputs": []}
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    n = {"inputs": [], "outputs": [], "op_type": None,
                         "attrs": {}}
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            n["inputs"].append(v3.decode())
                        elif f3 == 2:
                            n["outputs"].append(v3.decode())
                        elif f3 == 4:
                            n["op_type"] = v3.decode()
                        elif f3 == 5:
                            a = {"ints": [], "floats": []}
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1:
                                    a["name"] = v4.decode()
                                elif f4 == 3:
                                    a["i"] = v4
                                elif f4 == 2:
                                    a["f"] = v4
                                elif f4 == 8:
                                    a["ints"].append(v4)
                                elif f4 == 7:
                                    a["floats"].append(v4)
                                elif f4 == 4:
                                    a["s"] = v4
                            n["attrs"][a["name"]] = a
                    g["nodes"].append(n)
                elif f2 == 5:
                    dims, dtype, name, raw = [], None, None, b""
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            dims.append(v3)
                        elif f3 == 2:
                            dtype = v3
                        elif f3 == 8:
                            name = v3.decode()
                        elif f3 == 9:
                            raw = v3
                    np_dt = {FLOAT: np.float32, INT64: np.int64,
                             INT32: np.int32, BOOL: np.bool_,
                             INT8: np.int8}[dtype]
                    g["initializers"][name] = np.frombuffer(
                        raw, np_dt).reshape(dims)
                elif f2 in (11, 12):
                    vi = {"name": None, "shape": [], "elem_type": None}
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            vi["name"] = v3.decode()
                        elif f3 == 2:
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            vi["elem_type"] = v5
                                        elif f5 == 2:
                                            for f6, _, v6 in _fields(v5):
                                                if f6 == 1:
                                                    for f7, _, v7 in \
                                                            _fields(v6):
                                                        if f7 == 1:
                                                            vi["shape"] \
                                                              .append(v7)
                    (g["inputs"] if f2 == 11 else g["outputs"]).append(vi)
            m["graph"] = g
    return m
