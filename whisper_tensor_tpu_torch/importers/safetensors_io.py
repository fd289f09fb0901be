"""Lazy safetensors weight manager.

Reference equivalent: the mmap'd SafetensorsWeightManager
(crates/whisper-tensor-import/src/onnx_graph/weights.rs). Uses the
baked-in `safetensors` package for zero-copy lazy slices; multi-shard
checkpoints (model.safetensors.index.json) are resolved transparently.

The port's copy of whisper_tensor_tpu/importers/safetensors_io.py,
without the header-only metadata, origin-reference and zero-weight
getters (ONNX export by reference and windowed decode are not ported).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np


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


def load_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)
