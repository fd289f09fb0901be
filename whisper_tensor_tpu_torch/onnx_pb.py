"""Self-contained ONNX protobuf wire-format codec.

The image has no ``onnx`` package and the reference's vendored onnx
submodule is an empty stub, so this module implements the protobuf wire
format (varint / length-delimited) directly against the public ONNX IR
schema (onnx.proto, IR version <= 11). It provides both directions:

  * decode: ModelProto.parse(bytes) — ONNX ingest (reference equivalent:
    prost decode in src/symbolic_graph/mod.rs:1497)
  * encode: ModelProto(...).dumps() — the importer's ONNX emission
    (reference equivalent: onnx_graph/mod.rs:92 build_proto)

Only the subset of the schema the framework uses is modeled; unknown
fields are skipped on decode (forward-compatible).

The port's copy of whisper_tensor_tpu/onnx_pb.py (the port imports
nothing of the JAX package). `dumps` writes the reference's bytes, but
gathers an encoding as a list of parts (`_Chunks`) in which a large
payload (a weight's raw_data) is kept by reference, so the final join
copies it once instead of once for each enclosing message. A safetensors
origin reference is read by its span in the file's header (bf16
included), one tensor at a time.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1  # two's complement 64-bit
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _skip(buf: memoryview, pos: int, wt: int) -> int:
    if wt == 0:
        _, pos = _read_varint(buf, pos)
    elif wt == 1:
        pos += 8
    elif wt == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wt == 5:
        pos += 4
    else:
        raise ValueError(f"bad wire type {wt}")
    return pos


# field kinds
_VARINT = "varint"        # int32/int64/uint64/bool/enum
_SINT = "sint"            # zigzag (unused by onnx but kept for completeness)
_FLOAT = "float"
_DOUBLE = "double"
_BYTES = "bytes"
_STRING = "string"
_MSG = "msg"


class Message:
    """Base for schema-described protobuf messages."""

    # subclasses define FIELDS: {number: (name, kind, repeated, msg_cls_name, packed)}
    FIELDS: Dict[int, Tuple[str, str, bool, Optional[str], bool]] = {}
    _BY_NAME: Dict[str, Tuple[int, str, bool, Optional[str], bool]] = {}

    def __init__(self, **kw):
        for num, (name, kind, rep, mcls, packed) in self.FIELDS.items():
            setattr(self, name, [] if rep else _default(kind))
        for k, v in kw.items():
            if k not in self._BY_NAME:
                raise AttributeError(f"{type(self).__name__} has no field {k}")
            setattr(self, k, v)

    # -- decode ---------------------------------------------------------
    @classmethod
    def parse(cls, data) -> "Message":
        buf = memoryview(bytes(data) if not isinstance(data, (bytes, memoryview, bytearray)) else data)
        if isinstance(buf.obj, bytearray):
            buf = memoryview(bytes(buf))
        msg = cls()
        pos, end = 0, len(buf)
        fields = cls.FIELDS
        while pos < end:
            key, pos = _read_varint(buf, pos)
            fnum, wt = key >> 3, key & 7
            spec = fields.get(fnum)
            if spec is None:
                pos = _skip(buf, pos, wt)
                continue
            name, kind, rep, mcls, _packed = spec
            if kind in (_VARINT, _SINT):
                if wt == 0:
                    v, pos = _read_varint(buf, pos)
                    v = _to_signed64(v)
                    if rep:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
                elif wt == 2:  # packed
                    ln, pos = _read_varint(buf, pos)
                    sub_end = pos + ln
                    lst = getattr(msg, name)
                    while pos < sub_end:
                        v, pos = _read_varint(buf, pos)
                        lst.append(_to_signed64(v))
                else:
                    pos = _skip(buf, pos, wt)
            elif kind == _FLOAT:
                if wt == 5:
                    v = struct.unpack_from("<f", buf, pos)[0]
                    pos += 4
                    if rep:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
                elif wt == 2:
                    ln, pos = _read_varint(buf, pos)
                    vals = np.frombuffer(buf[pos:pos + ln], dtype="<f4")
                    pos += ln
                    getattr(msg, name).extend(vals.tolist())
                else:
                    pos = _skip(buf, pos, wt)
            elif kind == _DOUBLE:
                if wt == 1:
                    v = struct.unpack_from("<d", buf, pos)[0]
                    pos += 8
                    if rep:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
                elif wt == 2:
                    ln, pos = _read_varint(buf, pos)
                    vals = np.frombuffer(buf[pos:pos + ln], dtype="<f8")
                    pos += ln
                    getattr(msg, name).extend(vals.tolist())
                else:
                    pos = _skip(buf, pos, wt)
            elif kind in (_BYTES, _STRING):
                ln, pos = _read_varint(buf, pos)
                raw = bytes(buf[pos:pos + ln])
                pos += ln
                v = raw.decode("utf-8", errors="replace") if kind == _STRING else raw
                if rep:
                    getattr(msg, name).append(v)
                else:
                    setattr(msg, name, v)
            elif kind == _MSG:
                ln, pos = _read_varint(buf, pos)
                sub = _MSG_REGISTRY[mcls].parse(buf[pos:pos + ln])
                pos += ln
                if rep:
                    getattr(msg, name).append(sub)
                else:
                    setattr(msg, name, sub)
            else:  # pragma: no cover
                pos = _skip(buf, pos, wt)
        return msg

    # -- encode ---------------------------------------------------------
    def dumps(self) -> bytes:
        out = _Chunks()
        self._emit(out)
        return out.join()

    def _emit(self, out: "_Chunks") -> None:
        for num, (name, kind, rep, mcls, packed) in self.FIELDS.items():
            val = getattr(self, name)
            if rep:
                if not val:
                    continue
                if packed and kind in (_VARINT, _FLOAT, _DOUBLE):
                    _write_varint(out, (num << 3) | 2)
                    body = bytearray()
                    if kind == _VARINT:
                        for v in val:
                            _write_varint(body, int(v))
                    elif kind == _FLOAT:
                        body += np.asarray(val, dtype="<f4").tobytes()
                    else:
                        body += np.asarray(val, dtype="<f8").tobytes()
                    _write_varint(out, len(body))
                    out += body
                else:
                    for v in val:
                        _emit_one(out, num, kind, v)
            else:
                if _is_default(kind, val):
                    continue
                _emit_one(out, num, kind, val)


class _Chunks:
    """An encoding in parts, written like a bytearray (`append`, `+=`,
    `len`): small writes gather in a bytearray, a payload of _BIG bytes
    or more and a nested message's parts are kept by reference, and
    `join` copies every part once."""

    __slots__ = ("parts", "buf", "n")

    def __init__(self):
        self.parts: List[Any] = []
        self.buf = bytearray()
        self.n = 0

    def append(self, b: int) -> None:
        self.buf.append(b)
        self.n += 1

    def __iadd__(self, data) -> "_Chunks":
        if isinstance(data, _Chunks):
            self._flush()
            self.parts += data.parts
            self.parts.append(data.buf)
        elif len(data) >= _BIG:
            self._flush()
            self.parts.append(data)
        else:
            self.buf += data
        self.n += len(data)
        return self

    def _flush(self) -> None:
        if self.buf:
            self.parts.append(self.buf)
            self.buf = bytearray()

    def __len__(self) -> int:
        return self.n

    def join(self) -> bytes:
        self._flush()
        return b"".join(self.parts)


_BIG = 1 << 16      # bytes from which a payload is kept by reference


def _emit_one(out: _Chunks, num: int, kind: str, v: Any) -> None:
    if kind == _VARINT:
        _write_varint(out, (num << 3) | 0)
        _write_varint(out, int(v))
    elif kind == _FLOAT:
        _write_varint(out, (num << 3) | 5)
        out += struct.pack("<f", float(v))
    elif kind == _DOUBLE:
        _write_varint(out, (num << 3) | 1)
        out += struct.pack("<d", float(v))
    elif kind == _STRING:
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _write_varint(out, (num << 3) | 2)
        _write_varint(out, len(raw))
        out += raw
    elif kind == _BYTES:
        raw = bytes(v)
        _write_varint(out, (num << 3) | 2)
        _write_varint(out, len(raw))
        out += raw
    elif kind == _MSG:
        body = _Chunks()
        v._emit(body)
        _write_varint(out, (num << 3) | 2)
        _write_varint(out, len(body))
        out += body


def _default(kind: str):
    if kind in (_VARINT, _SINT):
        return 0
    if kind in (_FLOAT, _DOUBLE):
        return 0.0
    if kind == _BYTES:
        return b""
    if kind == _STRING:
        return ""
    return None  # msg


def _is_default(kind: str, v) -> bool:
    if v is None:
        return True
    if kind in (_VARINT, _SINT):
        return v == 0
    if kind in (_FLOAT, _DOUBLE):
        return v == 0.0
    if kind in (_BYTES, _STRING):
        return len(v) == 0
    return False


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


_MSG_REGISTRY: Dict[str, type] = {}


def _message(name: str, fields: List[Tuple[int, str, str, bool, Optional[str], bool]]) -> type:
    """fields: (number, name, kind, repeated, msg_cls_name, packed)"""
    fdict = {num: (fname, kind, rep, mcls, packed) for num, fname, kind, rep, mcls, packed in fields}
    byname = {fname: (num, kind, rep, mcls, packed) for num, fname, kind, rep, mcls, packed in fields}
    cls = type(name, (Message,), {"FIELDS": fdict, "_BY_NAME": byname})
    _MSG_REGISTRY[name] = cls
    return cls


# ---------------------------------------------------------------------------
# ONNX IR schema (public onnx.proto field numbers)
# ---------------------------------------------------------------------------

StringStringEntryProto = _message("StringStringEntryProto", [
    (1, "key", _STRING, False, None, False),
    (2, "value", _STRING, False, None, False),
])

OperatorSetIdProto = _message("OperatorSetIdProto", [
    (1, "domain", _STRING, False, None, False),
    (2, "version", _VARINT, False, None, False),
])

TensorShapeDim = _message("TensorShapeDim", [
    (1, "dim_value", _VARINT, False, None, False),
    (2, "dim_param", _STRING, False, None, False),
    (3, "denotation", _STRING, False, None, False),
])

TensorShapeProto = _message("TensorShapeProto", [
    (1, "dim", _MSG, True, "TensorShapeDim", False),
])

TensorTypeProto = _message("TensorTypeProto", [
    (1, "elem_type", _VARINT, False, None, False),
    (2, "shape", _MSG, False, "TensorShapeProto", False),
])

TypeProto = _message("TypeProto", [
    (1, "tensor_type", _MSG, False, "TensorTypeProto", False),
    (6, "denotation", _STRING, False, None, False),
])

ValueInfoProto = _message("ValueInfoProto", [
    (1, "name", _STRING, False, None, False),
    (2, "type", _MSG, False, "TypeProto", False),
    (3, "doc_string", _STRING, False, None, False),
])

TensorProto = _message("TensorProto", [
    (1, "dims", _VARINT, True, None, True),
    (2, "data_type", _VARINT, False, None, False),
    (4, "float_data", _FLOAT, True, None, True),
    (5, "int32_data", _VARINT, True, None, True),
    (6, "string_data", _BYTES, True, None, False),
    (7, "int64_data", _VARINT, True, None, True),
    (8, "name", _STRING, False, None, False),
    (9, "raw_data", _BYTES, False, None, False),
    (10, "double_data", _DOUBLE, True, None, True),
    (11, "uint64_data", _VARINT, True, None, True),
    (12, "doc_string", _STRING, False, None, False),
    (13, "external_data", _MSG, True, "StringStringEntryProto", False),
    (14, "data_location", _VARINT, False, None, False),  # 0=DEFAULT 1=EXTERNAL
])

AttributeProto = _message("AttributeProto", [
    (1, "name", _STRING, False, None, False),
    (2, "f", _FLOAT, False, None, False),
    (3, "i", _VARINT, False, None, False),
    (4, "s", _BYTES, False, None, False),
    (5, "t", _MSG, False, "TensorProto", False),
    (6, "g", _MSG, False, "GraphProto", False),
    (7, "floats", _FLOAT, True, None, True),
    (8, "ints", _VARINT, True, None, True),
    (9, "strings", _BYTES, True, None, False),
    (10, "tensors", _MSG, True, "TensorProto", False),
    (11, "graphs", _MSG, True, "GraphProto", False),
    (13, "doc_string", _STRING, False, None, False),
    (20, "type", _VARINT, False, None, False),
    (21, "ref_attr_name", _STRING, False, None, False),
])

NodeProto = _message("NodeProto", [
    (1, "input", _STRING, True, None, False),
    (2, "output", _STRING, True, None, False),
    (3, "name", _STRING, False, None, False),
    (4, "op_type", _STRING, False, None, False),
    (5, "attribute", _MSG, True, "AttributeProto", False),
    (6, "doc_string", _STRING, False, None, False),
    (7, "domain", _STRING, False, None, False),
])

GraphProto = _message("GraphProto", [
    (1, "node", _MSG, True, "NodeProto", False),
    (2, "name", _STRING, False, None, False),
    (5, "initializer", _MSG, True, "TensorProto", False),
    (10, "doc_string", _STRING, False, None, False),
    (11, "input", _MSG, True, "ValueInfoProto", False),
    (12, "output", _MSG, True, "ValueInfoProto", False),
    (13, "value_info", _MSG, True, "ValueInfoProto", False),
])

FunctionProto = _message("FunctionProto", [
    (1, "name", _STRING, False, None, False),
    (4, "input", _STRING, True, None, False),
    (5, "output", _STRING, True, None, False),
    (6, "attribute", _STRING, True, None, False),
    (7, "node", _MSG, True, "NodeProto", False),
    (8, "doc_string", _STRING, False, None, False),
    (9, "opset_import", _MSG, True, "OperatorSetIdProto", False),
    (10, "domain", _STRING, False, None, False),
])

ModelProto = _message("ModelProto", [
    (1, "ir_version", _VARINT, False, None, False),
    (2, "producer_name", _STRING, False, None, False),
    (3, "producer_version", _STRING, False, None, False),
    (4, "domain", _STRING, False, None, False),
    (5, "model_version", _VARINT, False, None, False),
    (6, "doc_string", _STRING, False, None, False),
    (7, "graph", _MSG, False, "GraphProto", False),
    (8, "opset_import", _MSG, True, "OperatorSetIdProto", False),
    (14, "metadata_props", _MSG, True, "StringStringEntryProto", False),
    (25, "functions", _MSG, True, "FunctionProto", False),
])


# AttributeProto.AttributeType values
class AttrType:
    UNDEFINED = 0
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10


# ---------------------------------------------------------------------------
# TensorProto <-> numpy
# ---------------------------------------------------------------------------

from .dtype import DType, ONNX_TO_DTYPE, DTYPE_TO_ONNX  # noqa: E402


def tensor_proto_to_numpy(tp: "TensorProto", base_dir: Optional[str] = None) -> np.ndarray:
    dt = ONNX_TO_DTYPE.get(tp.data_type)
    if dt is None:
        raise ValueError(f"unsupported ONNX data_type {tp.data_type} for tensor {tp.name!r}")
    shape = tuple(int(d) for d in tp.dims)
    if tp.data_location == 1:  # EXTERNAL
        import os

        meta = {e.key: e.value for e in tp.external_data}
        path = meta["location"]
        if base_dir is not None and not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        if meta.get("format") == "safetensors":
            # OriginReference export pointing at a safetensors origin
            # (reference onnx_graph/weights.rs:365-410): resolved by
            # tensor NAME through the safetensors header, not by byte
            # span, so re-sharded checkpoints still load
            from .importers.safetensors_io import read_span

            st_dt, raw = read_span(path, meta["tensor_name"])
            return _raw_to_numpy(raw, st_dt, shape).astype(
                dt.to_numpy(), copy=False)
        offset = int(meta.get("offset", 0))
        length = int(meta.get("length", -1))
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(length if length >= 0 else -1)
        return _raw_to_numpy(raw, dt, shape)
    if tp.raw_data:
        return _raw_to_numpy(tp.raw_data, dt, shape)
    if dt is DType.STRING:
        arr = np.array([s.decode("utf-8", errors="replace") for s in tp.string_data], dtype=object)
        return arr.reshape(shape)
    # typed repeated fields
    if dt in (DType.F32,):
        vals = np.asarray(tp.float_data, dtype=np.float32)
    elif dt in (DType.F64,):
        vals = np.asarray(tp.double_data, dtype=np.float64)
    elif dt in (DType.I64,):
        vals = np.asarray(tp.int64_data, dtype=np.int64)
    elif dt in (DType.U64, DType.U32):
        vals = np.asarray(tp.uint64_data or tp.int32_data, dtype=np.uint64)
    elif dt in (DType.F16, DType.BF16):
        # stored as uint16 bit patterns in int32_data
        bits = np.asarray(tp.int32_data, dtype=np.uint16)
        vals = bits.view(dt.to_numpy())
    else:  # ints/bool/u8 etc. in int32_data
        vals = np.asarray(tp.int32_data, dtype=np.int64).astype(dt.to_numpy())
    return vals.reshape(shape).astype(dt.to_numpy(), copy=False)


def _raw_to_numpy(raw: bytes, dt: DType, shape: Tuple[int, ...]) -> np.ndarray:
    if dt is DType.STRING:
        raise ValueError("STRING tensors cannot use raw_data")
    if dt in (DType.U4, DType.I4):
        packed = np.frombuffer(raw, dtype=np.uint8)
        lo = packed & 0x0F
        hi = packed >> 4
        vals = np.empty(packed.size * 2, dtype=np.uint8)
        vals[0::2] = lo
        vals[1::2] = hi
        n = int(np.prod(shape)) if shape else 1
        vals = vals[:n]
        if dt is DType.I4:
            vals = vals.astype(np.int8)
            vals = np.where(vals >= 8, vals - 16, vals)
        return vals.reshape(shape).astype(dt.to_numpy())
    arr = np.frombuffer(raw, dtype=dt.to_numpy())
    return arr.reshape(shape)


def numpy_to_tensor_proto(arr: np.ndarray, name: str, dtype: Optional[DType] = None) -> "TensorProto":
    dt = dtype or DType.from_numpy(arr.dtype)
    tp = TensorProto()
    tp.name = name
    tp.data_type = DTYPE_TO_ONNX[dt]
    tp.dims = [int(d) for d in arr.shape]
    if dt is DType.STRING:
        tp.string_data = [str(s).encode("utf-8") for s in arr.reshape(-1)]
    else:
        tp.raw_data = np.ascontiguousarray(arr.astype(dt.to_numpy(), copy=False)).tobytes()
    return tp
