"""TensorStore: the weights of a symbolic graph, by name.

The port's copy of whisper_tensor_tpu/symbolic_graph/tensor_store.py,
trimmed to what the port's loaders store: in-memory NumericTensors (the
transformers loader embeds every weight in its ONNX bytes),
PackedTensors, and LazyTensors (:58-64), whose loader runs on first use
and is cached (the GGUF loader's dense fallback of a packed weight).
`packed_sources` maps a weight name to a zero-argument loader of its
packed source (GGUF orientation), which the text interface keeps packed
on the device. The out-of-line file entries (ExternalBinary,
ExternalPacked) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

from ..dtype import DType
from ..tensor import NumericTensor, PackedTensor


@dataclass
class LazyTensor:
    """Arbitrary deferred loader (e.g. a GGUF tensor's dequantization)."""

    loader: Callable[[], Union[NumericTensor, PackedTensor]]


Stored = Union[NumericTensor, PackedTensor, LazyTensor]


class TensorStore:
    def __init__(self) -> None:
        self._store: Dict[str, Stored] = {}
        self._cache: Dict[str, Union[NumericTensor, PackedTensor]] = {}
        # weight name -> zero-arg loader of the ORIGINAL PackedTensor
        # (GGUF orientation) for weights whose dense entry is a
        # transposed dequantization (milli.transforms.pack_matmul_nodes)
        self.packed_sources: Dict[str, Any] = {}

    def put(self, name: str, t: Stored) -> None:
        if not isinstance(t, (NumericTensor, PackedTensor, LazyTensor)):
            raise NotImplementedError(
                f"stored tensor {name!r} of type {type(t).__name__}: only "
                f"NumericTensor, PackedTensor and LazyTensor are ported")
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
        out = s.loader() if isinstance(s, LazyTensor) else s
        self._cache[name] = out
        return out

    def get_numeric(self, name: str,
                    dequant_dtype: DType = DType.F32) -> NumericTensor:
        t = self.get(name)
        if isinstance(t, PackedTensor):
            return t.dequantize(dequant_dtype)
        return t

    def total_bytes(self) -> int:
        n = 0
        for s in self._store.values():
            if isinstance(s, NumericTensor):
                n += int(s.size * (s.dtype.size_bytes or 0))
            elif isinstance(s, PackedTensor):
                n += len(s.data)
        return n

    def __len__(self) -> int:
        return len(self._store)
