"""TensorStore: the weights of a symbolic graph, by name.

The port's copy of whisper_tensor_tpu/symbolic_graph/tensor_store.py,
trimmed to in-memory NumericTensors: the step graphs the port loads
embed every weight in their ONNX bytes. Out-of-line and packed
(GGUF-quantized) entries are not ported; `packed_sources` stays as an
empty map, which the text interface checks before it runs a model.
"""

from __future__ import annotations

from typing import Any, Dict

from ..tensor import NumericTensor


class TensorStore:
    def __init__(self) -> None:
        self._store: Dict[str, NumericTensor] = {}
        # weight name -> loader of a packed source (not ported: stays empty)
        self.packed_sources: Dict[str, Any] = {}

    def put(self, name: str, t: NumericTensor) -> None:
        if not isinstance(t, NumericTensor):
            raise NotImplementedError(
                f"stored tensor {name!r} of type {type(t).__name__}: only "
                f"in-memory NumericTensors are ported")
        self._store[name] = t

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def names(self):
        return self._store.keys()

    def get(self, name: str) -> NumericTensor:
        return self._store[name]

    def get_numeric(self, name: str) -> NumericTensor:
        return self._store[name]

    def total_bytes(self) -> int:
        return sum(int(s.size * (s.dtype.size_bytes or 0))
                   for s in self._store.values())

    def __len__(self) -> int:
        return len(self._store)
