"""TensorStore: lazy weight storage.

Reference equivalent: src/symbolic_graph/tensor_store.rs:10-193
(StoredTensor::Numeric | ExternalBinary | ExternalPth). Weights larger
than a threshold stay out-of-line (mmap'd safetensors/bin files or
.pth entries) and are materialized on first use; packed (GGUF-quant)
tensors keep their raw bytes and dequantize on demand (or feed the
fused dequant-matmul Pallas kernel directly on TPU).

The port's copy of whisper_tensor_tpu/symbolic_graph/tensor_store.py.
`packed_sources` maps a weight name to a zero-argument loader of its
packed source (GGUF orientation), which the text interface keeps packed
on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np

from ..dtype import DType
from ..packed_format import PackedFormat
from ..tensor import NumericTensor, PackedTensor


@dataclass
class ExternalBinary:
    """Slice of a flat binary file holding one tensor, little-endian."""

    path: str
    offset: int
    length: int
    dtype: DType
    shape: Tuple[int, ...]

    def load(self) -> NumericTensor:
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            raw = f.read(self.length)
        arr = np.frombuffer(raw, dtype=self.dtype.to_numpy()).reshape(self.shape)
        return NumericTensor.from_numpy(arr, self.dtype)


@dataclass
class ExternalPacked:
    path: str
    offset: int
    length: int
    fmt: PackedFormat
    shape: Tuple[int, ...]

    def load(self) -> PackedTensor:
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            raw = f.read(self.length)
        return PackedTensor(raw, self.fmt, self.shape)


@dataclass
class LazyTensor:
    """Arbitrary deferred loader (e.g. a .pth or safetensors entry)."""

    loader: Callable[[], Union[NumericTensor, PackedTensor]]
    dtype: Optional[DType] = None
    shape: Optional[Tuple[int, ...]] = None


Stored = Union[NumericTensor, PackedTensor, ExternalBinary, ExternalPacked, LazyTensor]


class TensorStore:
    def __init__(self) -> None:
        self._store: Dict[str, Stored] = {}
        self._cache: Dict[str, Union[NumericTensor, PackedTensor]] = {}
        # weight name -> zero-arg loader of the ORIGINAL PackedTensor
        # (GGUF orientation) for weights whose dense entry is a
        # transposed dequantization — the fused packed-matmul path
        # (milli.transforms.pack_matmul_nodes) reads these to keep
        # sub-byte weights packed on device.
        self.packed_sources: Dict[str, Any] = {}

    def put(self, name: str, t: Stored) -> None:
        self._store[name] = t
        self._cache.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def names(self):
        return self._store.keys()

    def raw(self, name: str) -> Stored:
        return self._store[name]

    def get(self, name: str) -> Union[NumericTensor, PackedTensor]:
        """Materialize (numeric or packed). Cached."""
        if name in self._cache:
            return self._cache[name]
        s = self._store[name]
        if isinstance(s, (NumericTensor, PackedTensor)):
            out = s
        elif isinstance(s, (ExternalBinary, ExternalPacked)):
            out = s.load()
        elif isinstance(s, LazyTensor):
            out = s.loader()
        else:  # pragma: no cover
            raise TypeError(type(s))
        self._cache[name] = out
        return out

    def get_numeric(self, name: str, dequant_dtype: DType = DType.F32) -> NumericTensor:
        t = self.get(name)
        if isinstance(t, PackedTensor):
            return t.dequantize(dequant_dtype)
        return t

    def evict(self, name: Optional[str] = None) -> None:
        if name is None:
            self._cache.clear()
        else:
            self._cache.pop(name, None)

    def total_bytes(self) -> int:
        n = 0
        for s in self._store.values():
            if isinstance(s, NumericTensor):
                b = s.dtype.size_bytes or 0
                n += int(s.size * b)
            elif isinstance(s, PackedTensor):
                n += len(s.data)
            elif isinstance(s, (ExternalBinary, ExternalPacked)):
                n += s.length
        return n

    def __len__(self) -> int:
        return len(self._store)
