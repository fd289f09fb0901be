"""GGUF file parser and writer: metadata, lazy quantized tensors.

Reference equivalent: crates/whisper-tensor-import/src/gguf/ (full GGUF
parser incl. quantized tensors). Tensors load lazily; block-quantized
payloads become PackedTensors (dequantized by backends.cpu.dequant or
repacked for the packed_matmul kernel).

The port's copy of whisper_tensor_tpu/importers/gguf.py (:108-245):
GGUFFile and write_gguf. `GGUFFile.stored` (out-of-line TensorStore
entries) and `gguf_tokenizer` are not ported: the server serves GGUF
models with the byte tokenizer, as the reference's does.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..dtype import DType
from ..packed_format import GGML_TYPE_TO_PACKED, PackedFormat
from ..tensor import NumericTensor, PackedTensor

GGUF_MAGIC = 0x46554747  # 'GGUF'

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

# ggml scalar tensor types (non-quantized)
_GGML_SCALAR = {
    0: DType.F32, 1: DType.F16, 16: DType.I8, 17: DType.I16,
    18: DType.I32, 24: DType.I64, 25: DType.F64, 30: DType.BF16,
}


class _Reader:
    def __init__(self, data: memoryview):
        self.d = data
        self.pos = 0

    def u(self, fmt: str):
        v = struct.unpack_from(fmt, self.d, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def string(self) -> str:
        n = self.u("<Q")
        s = bytes(self.d[self.pos:self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def value(self, t: int):
        if t == _T_U8:
            return self.u("<B")
        if t == _T_I8:
            return self.u("<b")
        if t == _T_U16:
            return self.u("<H")
        if t == _T_I16:
            return self.u("<h")
        if t == _T_U32:
            return self.u("<I")
        if t == _T_I32:
            return self.u("<i")
        if t == _T_F32:
            return self.u("<f")
        if t == _T_BOOL:
            return bool(self.u("<B"))
        if t == _T_STRING:
            return self.string()
        if t == _T_U64:
            return self.u("<Q")
        if t == _T_I64:
            return self.u("<q")
        if t == _T_F64:
            return self.u("<d")
        if t == _T_ARRAY:
            et = self.u("<I")
            n = self.u("<Q")
            return [self.value(et) for _ in range(n)]
        raise ValueError(f"bad gguf metadata type {t}")


@dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]      # logical (row-major, reversed from file)
    ggml_type: int
    offset: int                 # relative to data section start

    @property
    def dtype(self) -> Optional[DType]:
        return _GGML_SCALAR.get(self.ggml_type)

    @property
    def packed(self) -> Optional[PackedFormat]:
        return GGML_TYPE_TO_PACKED.get(self.ggml_type)

    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        if self.packed is not None:
            return self.packed.storage_bytes(n)
        return int(n * self.dtype.size_bytes)


class GGUFFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(1 << 20)  # headers are small; extend if needed
            while True:
                try:
                    self._parse(memoryview(head))
                    break
                except struct.error:
                    more = f.read(len(head))
                    if not more:
                        raise
                    head += more

    def _parse(self, mv: memoryview) -> None:
        r = _Reader(mv)
        magic = r.u("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        self.version = r.u("<I")
        if self.version < 2:
            raise ValueError(f"GGUF v{self.version} unsupported (need >= 2)")
        n_tensors = r.u("<Q")
        n_kv = r.u("<Q")
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            t = r.u("<I")
            self.metadata[key] = r.value(t)
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = r.string()
            nd = r.u("<I")
            dims = [r.u("<Q") for _ in range(nd)]
            ggml_type = r.u("<I")
            offset = r.u("<Q")
            # gguf stores dims innermost-first; numpy wants outermost-first
            self.tensors[name] = GGUFTensorInfo(name, tuple(reversed(dims)),
                                                ggml_type, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self.data_start = (r.pos + align - 1) // align * align

    # -- tensor access ----------------------------------------------------
    def load(self, name: str):
        info = self.tensors[name]
        start = self.data_start + info.offset
        with open(self.path, "rb") as f:
            f.seek(start)
            raw = f.read(info.nbytes())
        if info.packed is not None:
            return PackedTensor(raw, info.packed, info.shape)
        arr = np.frombuffer(raw, dtype=info.dtype.to_numpy()).reshape(info.shape)
        return NumericTensor.from_numpy(arr, info.dtype)

    @property
    def architecture(self) -> Optional[str]:
        return self.metadata.get("general.architecture")


def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, Any]) -> None:
    """Minimal GGUF v3 writer (round-trip tests + re-export).
    tensors: name -> np.ndarray (f32/f16/i32) or PackedTensor. The bytes
    are the reference writer's."""
    align = 32

    def enc_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def enc_value(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", _T_BOOL) + struct.pack("<B", int(v))
        if isinstance(v, int):
            return struct.pack("<I", _T_I64) + struct.pack("<q", v)
        if isinstance(v, float):
            return struct.pack("<I", _T_F32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", _T_STRING) + enc_str(v)
        if isinstance(v, list):
            if all(isinstance(x, str) for x in v):
                body = b"".join(enc_str(x) for x in v)
                return (struct.pack("<I", _T_ARRAY) + struct.pack("<I", _T_STRING)
                        + struct.pack("<Q", len(v)) + body)
            if all(isinstance(x, int) for x in v):
                body = b"".join(struct.pack("<q", x) for x in v)
                return (struct.pack("<I", _T_ARRAY) + struct.pack("<I", _T_I64)
                        + struct.pack("<Q", len(v)) + body)
            if all(isinstance(x, float) for x in v):
                body = b"".join(struct.pack("<f", x) for x in v)
                return (struct.pack("<I", _T_ARRAY) + struct.pack("<I", _T_F32)
                        + struct.pack("<Q", len(v)) + body)
        raise TypeError(f"gguf writer: unsupported metadata {type(v)}")

    out = bytearray()
    out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata))
    for k, v in metadata.items():
        out += enc_str(k)
        out += enc_value(v)
    # tensor infos; the payloads are written after the header, one at a
    # time, so a multi-GB file is never held in memory twice
    payloads: List[Any] = []
    offset = 0
    for name, tsr in tensors.items():
        if isinstance(tsr, PackedTensor):
            shape = tsr.shape
            ggml_type = {v: k for k, v in GGML_TYPE_TO_PACKED.items()}[tsr.fmt]
            nbytes = len(tsr.data)
        else:
            arr = np.asarray(tsr)
            shape = arr.shape
            ggml_type = {np.dtype(np.float32): 0, np.dtype(np.float16): 1,
                         np.dtype(np.int32): 18}[arr.dtype]
            nbytes = arr.nbytes
        out += enc_str(name)
        out += struct.pack("<I", len(shape))
        for d in reversed(shape):
            out += struct.pack("<Q", int(d))
        out += struct.pack("<I", ggml_type)
        out += struct.pack("<Q", offset)
        pad = (-nbytes) % align
        payloads.append((tsr, pad))
        offset += nbytes + pad
    pad = (-len(out)) % align
    out += b"\0" * pad
    with open(path, "wb") as f:
        f.write(bytes(out))
        for tsr, pad in payloads:
            f.write(bytes(tsr.data) if isinstance(tsr, PackedTensor)
                    else np.ascontiguousarray(np.asarray(tsr)).tobytes())
            f.write(b"\0" * pad)
