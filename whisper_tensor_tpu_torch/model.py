"""Model: a SymbolicGraph with a name, an id and execution convenience.

The port's copy of whisper_tensor_tpu/model.py (reference src/model.rs:
47-182) without `save_onnx` (the port has no exporter yet). `eval` runs
the graph through an EvalBackend (backends/eval_backend.py): mode "torch"
(the default) on the device `resolve_device` gives, the card unless the
caller passes device="cpu"; mode "oracle" in the numpy interpreter.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from .backends.eval_backend import EvalBackend, SymbolicObserver
from .device import resolve_device
from .graph import new_global_id
from .symbolic_graph.ir import SymbolicGraph
from .tensor_info import TensorInfo


class Model:
    def __init__(self, graph: SymbolicGraph, name: str = ""):
        self.id = new_global_id()
        self.name = name or graph.name
        self.graph = graph
        self._backends: Dict[Any, EvalBackend] = {}

    # -- constructors -----------------------------------------------------
    @staticmethod
    def new_from_onnx(data: bytes, base_dir: Optional[str] = None,
                      name: str = "") -> "Model":
        return Model(SymbolicGraph.from_onnx_bytes(data, base_dir), name)

    @staticmethod
    def new_from_onnx_file(path: str, name: str = "") -> "Model":
        with open(path, "rb") as f:
            data = f.read()
        return Model.new_from_onnx(data, base_dir=os.path.dirname(path),
                                   name=name or os.path.basename(path))

    # -- execution ----------------------------------------------------------
    def backend(self, mode: str = "torch", validate: Optional[bool] = None,
                observer: Optional[SymbolicObserver] = None,
                device=None) -> EvalBackend:
        dev = resolve_device(device) if mode == "torch" else None
        key = (mode, validate, id(observer), str(dev))
        if key not in self._backends:
            self._backends[key] = EvalBackend(mode, validate, observer, dev)
        return self._backends[key]

    def eval(self, feeds: Dict[str, np.ndarray], mode: str = "torch",
             device=None, validate: Optional[bool] = None,
             observer: Optional[SymbolicObserver] = None
             ) -> Dict[str, np.ndarray]:
        return self.backend(mode, validate, observer, device).run(
            self.graph, feeds)

    def load_tensors(self, mode: str = "torch", device=None) -> None:
        """Pre-materialize all weights: upload them to the device (torch
        mode) or load them on the host (reference src/model.rs:120+)."""
        if mode == "torch":
            be = self.backend("torch", device=device)
            be._device_weights(self.graph, self.graph.store.names())
        else:
            for name in self.graph.store.names():
                self.graph.store.get(name)

    # -- introspection ------------------------------------------------------
    def input_infos(self) -> Dict[str, Optional[TensorInfo]]:
        return {self.graph.tensors[t].name: self.graph.tensors[t].info
                for t in self.graph.inputs}

    def output_names(self) -> List[str]:
        return [self.graph.tensors[t].name for t in self.graph.outputs]

    def __repr__(self) -> str:
        return f"Model({self.name!r}, {self.graph!r})"
