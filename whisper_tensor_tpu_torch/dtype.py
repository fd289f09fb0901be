"""The port's DType, and DType <-> torch.dtype, host <-> device transfers.

`DType`, `ONNX_TO_DTYPE` and `DTYPE_TO_ONNX` are the port's copy of
whisper_tensor_tpu/dtype.py, trimmed to the scalar types: the packed
(block-quantized) formats live in packed_format.py; `AnyDType`,
`promote` and the jax mapping are left out.

Where each DType lives on the device:

  DType            host (numpy)            device (torch)
  F64 F32 F16      float64/32/16           float64/32/16
  BF16             ml_dtypes.bfloat16      bfloat16 (crosses as 16-bit words)
  F8E4M3 F8E5M2    ml_dtypes float8s       float8_e4m3fn, float8_e5m2
                                           (cross as bytes; the lowerings
                                           compute in f32 and round back)
  I64 I32 I16 I8   int64/32/16/8           int64/32/16/8
  U8               uint8                   uint8
  U16 U32 U64      uint16/32/64            uint16/32/64; torch lacks most
                                           arithmetic on them, so the
                                           lowerings widen for the op and
                                           round back (milli/ops/common.py,
                                           `widen_unsigned`)
  BOOL             bool_                   bool
  U4 I4            uint8 / int8 carriers   uint8 / int8 carriers (the
                                           host's own unpacked form)
  F4E2M1           ml_dtypes.float4_e2m1fn float32 carrier: crosses as its
                                           4-bit codes in bytes, widened on
                                           the device through a 16-entry
                                           table, narrowed on the way back
                                           (exact: every carried value is a
                                           4-bit float)
  STRING           object                  none: graphs with strings run
                                           in the host interpreter

bf16 crosses between host and device as raw 16-bit words: numpy has no
bf16 of its own (the host keeps ml_dtypes' bfloat16), and
``torch.from_numpy`` rejects ml_dtypes arrays. When ml_dtypes is
missing, BF16 tensors are stored on the host as float32; such an array
is uploaded as float32 and cast to bf16 on the device.
"""

from __future__ import annotations

from typing import Optional

import enum

import numpy as np
import torch

try:
    import ml_dtypes

    _NP_BF16: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # BF16 is then kept as float32 on the host
    ml_dtypes = None
    _NP_BF16 = None


class DType(enum.Enum):
    """Scalar element types. Mirrors ONNX TensorProto.DataType coverage."""

    F64 = "f64"
    F32 = "f32"
    BF16 = "bf16"
    F16 = "f16"
    F8E4M3 = "f8e4m3"
    F8E5M2 = "f8e5m2"
    I64 = "i64"
    I32 = "i32"
    I16 = "i16"
    I8 = "i8"
    U64 = "u64"
    U32 = "u32"
    U16 = "u16"
    U8 = "u8"
    BOOL = "bool"
    STRING = "string"
    # U4/I4 sub-byte types (ONNX 21+); stored unpacked as u8/i8 on host.
    U4 = "u4"
    I4 = "i4"
    # FLOAT4E2M1 (ONNX 23); ml_dtypes float4_e2m1fn host representation
    F4E2M1 = "f4e2m1"

    def __repr__(self) -> str:
        return f"DType.{self.name}"

    @property
    def is_float(self) -> bool:
        return self in _FLOATS

    @property
    def is_signed_int(self) -> bool:
        return self in (DType.I64, DType.I32, DType.I16, DType.I8, DType.I4)

    @property
    def is_unsigned_int(self) -> bool:
        return self in (DType.U64, DType.U32, DType.U16, DType.U8, DType.U4)

    @property
    def is_int(self) -> bool:
        return self.is_signed_int or self.is_unsigned_int

    @property
    def size_bytes(self) -> Optional[float]:
        """Bytes per element; fractional for sub-byte types; None for STRING."""
        return _SIZES.get(self)

    def to_numpy(self) -> np.dtype:
        """The numpy dtype of the host (oracle) representation."""
        if self is DType.STRING:
            return np.dtype(object)
        return np.dtype(_NP_MAP[self])

    @staticmethod
    def from_numpy(dt) -> "DType":
        dt = np.dtype(dt)
        if dt == np.dtype(object) or dt.kind in ("U", "S"):
            return DType.STRING
        for k, v in _NP_MAP.items():
            if np.dtype(v) == dt and k not in (DType.U4, DType.I4):
                return k
        raise ValueError(f"no DType for numpy dtype {dt}")

    def accumulate_dtype(self) -> "DType":
        """Default accumulation dtype for contractions of this element
        type: bf16/f16/f8 accumulate in f32, small ints in i32."""
        if self in (DType.BF16, DType.F16, DType.F8E4M3, DType.F8E5M2,
                    DType.F4E2M1):
            return DType.F32
        if self in (DType.I8, DType.I16, DType.U8, DType.U16, DType.I4, DType.U4):
            return DType.I32
        return self


_FLOATS = (DType.F64, DType.F32, DType.BF16, DType.F16, DType.F8E4M3,
           DType.F8E5M2, DType.F4E2M1)

_SIZES = {
    DType.F64: 8.0, DType.F32: 4.0, DType.BF16: 2.0, DType.F16: 2.0,
    DType.F8E4M3: 1.0, DType.F8E5M2: 1.0, DType.F4E2M1: 0.5,
    DType.I64: 8.0, DType.I32: 4.0, DType.I16: 2.0, DType.I8: 1.0,
    DType.U64: 8.0, DType.U32: 4.0, DType.U16: 2.0, DType.U8: 1.0,
    DType.BOOL: 1.0, DType.U4: 0.5, DType.I4: 0.5,
}

_NP_MAP = {
    DType.F64: np.float64,
    DType.F32: np.float32,
    DType.F16: np.float16,
    DType.I64: np.int64,
    DType.I32: np.int32,
    DType.I16: np.int16,
    DType.I8: np.int8,
    DType.U64: np.uint64,
    DType.U32: np.uint32,
    DType.U16: np.uint16,
    DType.U8: np.uint8,
    DType.BOOL: np.bool_,
    # sub-byte types are stored widened on host
    DType.U4: np.uint8,
    DType.I4: np.int8,
}
if ml_dtypes is not None:
    _NP_MAP[DType.BF16] = ml_dtypes.bfloat16
    _NP_MAP[DType.F8E4M3] = ml_dtypes.float8_e4m3fn
    _NP_MAP[DType.F8E5M2] = ml_dtypes.float8_e5m2
    _NP_MAP[DType.F4E2M1] = getattr(ml_dtypes, "float4_e2m1fn",
                                    ml_dtypes.float8_e4m3fn)
else:
    _NP_MAP[DType.BF16] = np.float32
    _NP_MAP[DType.F8E4M3] = np.float32
    _NP_MAP[DType.F8E5M2] = np.float32
    _NP_MAP[DType.F4E2M1] = np.float32

# ONNX TensorProto.DataType <-> DType (the public ONNX IR constants)
ONNX_TO_DTYPE = {
    1: DType.F32,
    2: DType.U8,
    3: DType.I8,
    4: DType.U16,
    5: DType.I16,
    6: DType.I32,
    7: DType.I64,
    8: DType.STRING,
    9: DType.BOOL,
    10: DType.F16,
    11: DType.F64,
    12: DType.U32,
    13: DType.U64,
    16: DType.BF16,
    17: DType.F8E4M3,
    19: DType.F8E5M2,
    21: DType.U4,
    22: DType.I4,
    23: DType.F4E2M1,
}
DTYPE_TO_ONNX = {v: k for k, v in ONNX_TO_DTYPE.items()}

_TORCH = {
    DType.F64: torch.float64,
    DType.F32: torch.float32,
    DType.F16: torch.float16,
    DType.BF16: torch.bfloat16,
    DType.F8E4M3: torch.float8_e4m3fn,
    DType.F8E5M2: torch.float8_e5m2,
    DType.I64: torch.int64,
    DType.I32: torch.int32,
    DType.I16: torch.int16,
    DType.I8: torch.int8,
    DType.U64: torch.uint64,
    DType.U32: torch.uint32,
    DType.U16: torch.uint16,
    DType.U8: torch.uint8,
    DType.BOOL: torch.bool,
}
_DTYPE = {v: k for k, v in _TORCH.items()}
# carriers: the device type that holds a DType torch does not have
_TORCH.update({DType.U4: torch.uint8, DType.I4: torch.int8,
               DType.F4E2M1: torch.float32})
# the 16 values of a 4-bit E2M1 float, by code
F4E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                 -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
_NP_F4 = (np.dtype(ml_dtypes.float4_e2m1fn)
          if ml_dtypes is not None and hasattr(ml_dtypes, "float4_e2m1fn")
          else None)
_NP_F8 = ({np.dtype(ml_dtypes.float8_e4m3fn): torch.float8_e4m3fn,
           np.dtype(ml_dtypes.float8_e5m2): torch.float8_e5m2}
          if ml_dtypes is not None else {})


def to_torch(dt: DType) -> torch.dtype:
    """The torch dtype (or carrier, see the table above) of a DType."""
    try:
        return _TORCH[dt]
    except KeyError:
        raise NotImplementedError(
            f"DType {dt.name} has no device type: it lives on the host "
            f"only") from None


def from_torch(dt: torch.dtype) -> DType:
    try:
        return _DTYPE[dt]
    except KeyError:
        raise NotImplementedError(
            f"torch dtype {dt} has no DType mapping in the port") from None


def to_device(arr: np.ndarray, device: torch.device,
              dtype: Optional[DType] = None) -> torch.Tensor:
    """Upload a host array. `dtype` is the declared element type: an
    array that arrives in another type (BF16 kept as float32 on a host
    without ml_dtypes, a float feed of an integer input) is cast on the
    device after the copy."""
    arr = np.asarray(arr, order="C")     # (ascontiguousarray makes 0-d 1-d)
    if arr.dtype == np.dtype(object) or arr.dtype.kind in "US":
        raise NotImplementedError(
            "STRING tensors live on the host only")
    if device.type == "cpu" or not arr.flags.writeable:
        # never alias the host array: lowerings may write in place (and
        # torch.from_numpy wants a writable array)
        arr = arr.copy()
    if _NP_BF16 is not None and arr.dtype == _NP_BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype in _NP_F8:
        t = torch.from_numpy(arr.view(np.uint8)).view(_NP_F8[arr.dtype])
    elif _NP_F4 is not None and arr.dtype == _NP_F4:
        codes = torch.from_numpy(arr.view(np.uint8)).to(device)
        table = torch.tensor(F4E2M1_VALUES, dtype=torch.float32,
                             device=device)
        return table[codes.long()]
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    if dtype is not None:
        want = to_torch(dtype)
        if t.dtype != want:
            t = t.to(want)
    return t


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a small host array without waiting for the device: on CUDA
    it is staged in pinned memory and copied on the current stream
    (PyTorch's copy from pageable memory synchronizes the stream, which
    would stall a pipelined loop). The array may change afterwards."""
    t = torch.from_numpy(np.array(arr, order="C"))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor, dtype: Optional[DType] = None) -> np.ndarray:
    """Download a tensor into the host representation: bf16 as
    ml_dtypes.bfloat16 (float32 where ml_dtypes is missing), the f8 types
    as ml_dtypes', and a declared F4E2M1 from its f32 carrier."""
    t = t.detach().cpu()
    if dtype is DType.F4E2M1 and _NP_F4 is not None:
        return t.float().numpy().astype(_NP_F4)
    if t.dtype == torch.bfloat16:
        if _NP_BF16 is None:
            return t.float().numpy()
        return t.contiguous().view(torch.int16).numpy().view(_NP_BF16)
    for np_dt, tdt in _NP_F8.items():
        if t.dtype == tdt:
            return t.contiguous().view(torch.uint8).numpy().view(np_dt)
    return t.numpy()
