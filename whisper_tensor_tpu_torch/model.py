"""Model: a SymbolicGraph with a name and an id.

The port's copy of whisper_tensor_tpu/model.py, trimmed to what the
port's interfaces read: `graph`, `name`, `id` and the two ONNX
constructors. The reference's EvalBackend (`eval`, `backend`) and
`load_tensors("xla")` are left out: the port's GraphExecutor
(backends/torch_exec) runs the graph, and its interfaces upload the
weights.
"""

from __future__ import annotations

import os
from typing import Optional

from .graph import new_global_id
from .symbolic_graph.ir import SymbolicGraph


class Model:
    def __init__(self, graph: SymbolicGraph, name: str = ""):
        self.id = new_global_id()
        self.name = name or graph.name
        self.graph = graph

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

    def __repr__(self) -> str:
        return f"Model({self.name!r}, {self.graph!r})"
