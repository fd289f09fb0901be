"""Lazy safetensors weight manager.

Reference equivalent: the mmap'd SafetensorsWeightManager
(crates/whisper-tensor-import/src/onnx_graph/weights.rs). Uses the
baked-in `safetensors` package for zero-copy lazy slices; multi-shard
checkpoints (model.safetensors.index.json) are resolved transparently.

The port's copy of whisper_tensor_tpu/importers/safetensors_io.py.
`header_entry` and `read_span` are the port's one reader of a file's
header: `meta`, `lazy` and the ONNX origin reader (onnx_pb.py) take a
tensor's type, shape and bytes from it, and a type the table lacks
raises.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..dtype import DType

SAFETENSORS_DTYPES = {
    "F64": DType.F64, "F32": DType.F32, "F16": DType.F16,
    "BF16": DType.BF16, "I64": DType.I64, "I32": DType.I32,
    "I16": DType.I16, "I8": DType.I8, "U64": DType.U64, "U32": DType.U32,
    "U16": DType.U16, "U8": DType.U8, "BOOL": DType.BOOL,
    "F8_E4M3": DType.F8E4M3, "F8_E5M2": DType.F8E5M2,
}


def header_entry(path: str, name: str) -> Tuple[DType, Tuple[int, ...],
                                                 int, int]:
    """(type, shape, first byte, end byte) of tensor `name` of a
    .safetensors file, from its header alone; the bytes are offsets into
    the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        entry = json.loads(f.read(n))[name]
    dt = SAFETENSORS_DTYPES.get(entry["dtype"])
    if dt is None:
        raise ValueError(f"{path}: tensor {name!r} has safetensors type "
                         f"{entry['dtype']}, which the port does not read")
    start, end = entry["data_offsets"]
    return dt, tuple(int(d) for d in entry["shape"]), 8 + n + start, 8 + n + end


def read_span(path: str, name: str) -> Tuple[DType, bytes]:
    """(type, bytes) of one tensor, found by name in the header and read
    alone: a safetensors backend may map or copy the whole file for each
    tensor it is asked for, and not every backend has bf16."""
    dt, _, start, end = header_entry(path, name)
    with open(path, "rb") as f:
        f.seek(start)
        return dt, f.read(end - start)


class SafetensorsStore:
    """name -> lazy numpy loader over one or many .safetensors files."""

    def __init__(self, paths: List[str]):
        self.paths = list(paths)
        self._by_name: Dict[str, str] = {}
        from safetensors import safe_open

        self._handles: Dict[str, object] = {}
        for p in self.paths:
            with safe_open(p, framework="numpy") as f:
                for k in f.keys():
                    self._by_name[k] = p

    @staticmethod
    def from_dir(d: str) -> "SafetensorsStore":
        idx = os.path.join(d, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                meta = json.load(f)
            shards = sorted(set(meta["weight_map"].values()))
            return SafetensorsStore([os.path.join(d, s) for s in shards])
        single = os.path.join(d, "model.safetensors")
        if os.path.exists(single):
            return SafetensorsStore([single])
        files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors in {d}")
        return SafetensorsStore([os.path.join(d, f) for f in files])

    def names(self):
        return self._by_name.keys()

    def __contains__(self, name):
        return name in self._by_name

    def load(self, name: str) -> np.ndarray:
        from safetensors import safe_open

        p = self._by_name[name]
        with safe_open(p, framework="numpy") as f:
            return f.get_tensor(name)

    def getter(self, transform: Optional[Callable[[str, np.ndarray], np.ndarray]] = None
               ) -> Callable[[str], np.ndarray]:
        def get(name: str) -> np.ndarray:
            arr = self.load(name)
            return transform(name, arr) if transform else arr

        return get

    def meta(self, name: str):
        """(shape, numpy dtype) from the safetensors header — no data read."""
        dt, shape, _, _ = header_entry(self._by_name[name], name)
        return shape, dt.to_numpy()

    def lazy(self, name: str):
        """Origin-bearing LazyWeight for WeightStorage.origin_reference():
        carries the safetensors file path + tensor name so an exported
        ONNX can point back at this checkpoint instead of embedding the
        payload (reference OriginReferenceOutputManager,
        onnx_graph/weights.rs:263-282)."""
        from .onnx_builder import LazyWeight

        dt, shape, _, _ = header_entry(self._by_name[name], name)
        return LazyWeight(
            lambda: self.load(name), dt, shape,
            origin={"format": "safetensors", "tensor_name": name,
                    "location": os.path.abspath(self._by_name[name])})

    def zeros_getter(self) -> Callable[[str], np.ndarray]:
        """Shape-faithful zero arrays (header metadata only) — for
        building structure-only graph variants (WeightStorage.none) that
        share a real TensorStore afterwards."""

        def get(name: str) -> np.ndarray:
            shape, dt = self.meta(name)
            return np.zeros(shape, dtype=dt)

        return get


def load_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)
