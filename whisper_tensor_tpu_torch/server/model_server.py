"""ModelServer: model lifecycle (load/unload/introspect).

Reference equivalent: crates/whisper-tensor-server/src/model_server.rs:
23-241 (loader registry, load/unload, Arc<Model> cache, model reports).

The port's copy of whisper_tensor_tpu/server/model_server.py; its
graph report has no control-flow sub-graphs, which the port's graphs
never hold.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..importers.loaders import LoadedBundle, loader_registry
from ..model import Model


@dataclass
class LoadedModelEntry:
    id: int
    name: str
    model: Model
    interfaces: Dict[str, Any] = field(default_factory=dict)
    tokenizer_source: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)


class ModelServer:
    def __init__(self):
        self._models: Dict[int, LoadedModelEntry] = {}
        self._bundles: Dict[int, LoadedBundle] = {}
        self._next = itertools.count(1)
        self._next_bundle = itertools.count(1)
        self._lock = threading.Lock()

    def run_loader(self, loader_name: str, config: Dict[str, Any]) -> List[LoadedModelEntry]:
        reg = loader_registry()
        if loader_name not in reg:
            raise ValueError(f"unknown loader {loader_name!r} (have {sorted(reg)})")
        bundle: LoadedBundle = reg[loader_name].load(config)
        out = []
        with self._lock:
            bid = next(self._next_bundle)
            self._bundles[bid] = bundle
            bundle.meta["bundle_id"] = bid
            for name, model in bundle.models.items():
                mid = next(self._next)
                entry = LoadedModelEntry(mid, name, model, bundle.interfaces,
                                         bundle.tokenizer_source, bundle.meta)
                self._models[mid] = entry
                out.append(entry)
        return out

    def unload(self, model_id: int) -> bool:
        with self._lock:
            return self._models.pop(model_id, None) is not None

    def bundle(self, bundle_id: int) -> LoadedBundle:
        b = self._bundles.get(bundle_id)
        if b is None:
            raise KeyError(f"no bundle {bundle_id}")
        return b

    def get(self, model_id: int) -> LoadedModelEntry:
        entry = self._models.get(model_id)
        if entry is None:
            raise KeyError(f"no model {model_id}")
        return entry

    def list_models(self) -> List[dict]:
        return [{
            "id": e.id, "name": e.name,
            "n_ops": len(e.model.graph.ops),
            "n_weights": len(e.model.graph.store),
            "weight_bytes": e.model.graph.store.total_bytes(),
            "interfaces": {k: {kk: vv for kk, vv in v.items()
                               if isinstance(vv, (str, int, float, bool))}
                           for k, v in e.interfaces.items()},
            "meta": e.meta,
        } for e in self._models.values()]

    def graph_json(self, model_id: int) -> dict:
        """Introspectable graph structure for the UI graph explorer."""
        return self._graph_json(self.get(model_id).model.graph)

    def _graph_json(self, g) -> dict:
        tensors = {}
        for tid, t in g.tensors.items():
            tensors[str(tid)] = {"name": t.name, "kind": t.kind.value,
                                 "dtype": t.dtype.name if t.dtype else None,
                                 "info": repr(t.info) if t.info else None}
        ops = []
        for sop in g.ops:
            entry = {"id": sop.id, "name": sop.name,
                     "op_type": sop.op.OP_TYPE,
                     "display": sop.op.display_name(),
                     "properties": sop.op.properties(),
                     "inputs": [i for i in sop.inputs],
                     "outputs": [o for o in sop.outputs]}
            ops.append(entry)
        return {"name": g.name, "tensors": tensors, "ops": ops,
                "inputs": g.inputs, "outputs": g.outputs}
