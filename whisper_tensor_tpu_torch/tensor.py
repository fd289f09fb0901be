"""NumericTensor: a host array with its DType; PackedTensor: GGUF
block-quantized bytes.

The port's copy of whisper_tensor_tpu/tensor.py, trimmed to the numpy
backend: the port keeps weights on the host as numpy until its
interfaces upload them as torch tensors (dtype.to_device). The jax
backend is left out. PackedTensor (:152-189) is whole: its bytes,
format and shape, and `dequantize` through backends/cpu/dequant.py.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from .dtype import DType
from .packed_format import PackedFormat


class NumericTensor:
    __slots__ = ("_data", "_dtype")

    def __init__(self, data: Any, dtype: Optional[DType] = None):
        if dtype is None:
            data = np.asarray(data)
            dtype = DType.from_numpy(data.dtype)
        else:
            data = np.asarray(data, dtype=dtype.to_numpy())
        self._data = data
        self._dtype = dtype

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: Optional[DType] = None) -> "NumericTensor":
        return NumericTensor(np.asarray(arr), dtype=dtype)

    @staticmethod
    def zeros(shape: Sequence[int], dtype: DType) -> "NumericTensor":
        return NumericTensor(np.zeros(tuple(shape), dtype=dtype.to_numpy()), dtype=dtype)

    @property
    def dtype(self) -> DType:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self._data.shape)

    @property
    def ndim(self) -> int:
        return len(self._data.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def numpy(self) -> np.ndarray:
        return self._data

    def astype(self, dtype: DType) -> "NumericTensor":
        if dtype == self._dtype:
            return self
        if dtype is DType.BOOL:
            return NumericTensor.from_numpy(self._data.astype(np.bool_), dtype)
        return NumericTensor.from_numpy(self._data.astype(dtype.to_numpy()), dtype)

    def __repr__(self) -> str:
        return f"NumericTensor({self._dtype.name}, shape={self.shape})"


class PackedTensor:
    """Raw-byte block-quantized tensor (GGUF formats) + dequantize.

    Equivalent of the reference's PackedTensor (src/packed_tensor.rs:16,96).
    Dequantization lives in ``backends.cpu.dequant`` (vectorized numpy);
    on the device the bytes are repacked for the packed_matmul kernel
    (``backends.cuda.packed_matmul``).
    """

    __slots__ = ("data", "fmt", "shape")

    def __init__(self, data: bytes, fmt: PackedFormat, shape: Sequence[int]):
        self.data = data
        self.fmt = fmt
        self.shape = tuple(int(d) for d in shape)
        n = 1
        for d in self.shape:
            n *= d
        expect = fmt.storage_bytes(n)
        if len(data) != expect:
            raise ValueError(f"{fmt} tensor {self.shape}: got {len(data)} bytes, want {expect}")

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def dequantize(self, dtype: DType = DType.F32) -> NumericTensor:
        from .backends.cpu.dequant import dequantize_blocks

        flat = dequantize_blocks(self.data, self.fmt, self.num_elements)
        out = flat.reshape(self.shape).astype(dtype.to_numpy())
        return NumericTensor.from_numpy(out, dtype)

    def __repr__(self) -> str:
        return f"PackedTensor({self.fmt.name}, shape={self.shape})"
