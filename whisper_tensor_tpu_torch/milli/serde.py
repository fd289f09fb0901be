"""MilliOpGraph JSON serialization.

Reference equivalent: every reference graph layer is serde-serializable
(SURVEY §aux: Symbolic/Milli/Super all ship over the wire so the WebUI
and server can exchange editable artifacts). The milli layer is the
TRAINING artifact layer — a serialized forward+loss+backward+optimizer
graph is a portable training job (examples/mnist_train_supergraph.rs
wraps exactly this in a SuperGraph Scan).

Ops are dataclasses keyed by KIND; fields serialize by type (ndarray ->
dtype/shape/b64, DType -> name, enums -> value). Tensor infos are NOT
serialized — they are derived state (re-inferred from feeds at eval /
compile time), not part of the graph's identity.

The port's copy of whisper_tensor_tpu/milli/serde.py, over the port's
op set: the reference's vision op module is not ported, so its kinds do
not load; the recurrent (rnn.py) and spectral (signal.py, DFT in
extra.py) kinds do.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import inspect
from typing import Any, Dict, Optional, Type

import numpy as np

from ..dtype import DType
from ..graph import new_global_id
from .ir import MilliGraph, MilliNode, MilliOp, Phase

_REGISTRY: Optional[Dict[str, Type[MilliOp]]] = None


def op_registry() -> Dict[str, Type[MilliOp]]:
    """KIND -> op class, over milli.ops + the transform-introduced ops."""
    global _REGISTRY
    if _REGISTRY is None:
        from . import ops as O
        from . import transforms as T
        from .ops import (attention, conv, einsum, extra, index, misc,
                          norm, quant, random, rnn, signal)

        reg: Dict[str, Type[MilliOp]] = {}
        for mod in (O, T, attention, conv, einsum, extra, index, misc,
                    norm, quant, random, rnn, signal):
            for name in dir(mod):
                c = getattr(mod, name)
                if (inspect.isclass(c) and issubclass(c, MilliOp)
                        and c is not MilliOp and getattr(c, "KIND", "?") != "?"):
                    # SimpleUnary/SimpleBinary share KIND across aliases;
                    # first registration wins (same class anyway)
                    reg.setdefault(c.KIND, c)
        _REGISTRY = reg
    return _REGISTRY


def _enc_value(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return {"__nd__": True, "dtype": str(v.dtype),
                "shape": list(v.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(v).tobytes()).decode()}
    if isinstance(v, np.generic):
        return _enc_value(np.asarray(v))
    if isinstance(v, DType):
        return {"__dtype__": v.name}
    if isinstance(v, enum.Enum):
        return {"__enum__": type(v).__name__, "value": v.value}
    if isinstance(v, (list, tuple)):
        return [_enc_value(x) for x in v]
    return v


def _dec_value(v: Any) -> Any:
    if isinstance(v, dict) and v.get("__nd__"):
        arr = np.frombuffer(base64.b64decode(v["b64"]),
                            dtype=np.dtype(v["dtype"]))
        return arr.reshape(v["shape"]).copy()
    if isinstance(v, dict) and "__dtype__" in v:
        return DType[v["__dtype__"]]
    if isinstance(v, dict) and "__enum__" in v:
        # optimizer/phase enums live next to their op modules
        from . import optimizers as _opt

        cls = getattr(_opt, v["__enum__"], None)
        if cls is None:
            raise KeyError(f"unknown enum {v['__enum__']}")
        return cls(v["value"])
    if isinstance(v, list):
        return [_dec_value(x) for x in v]
    return v


def graph_to_json(g: MilliGraph) -> Dict[str, Any]:
    nodes = []
    for n in g.nodes:
        fields = {}
        for f in dataclasses.fields(n.op):
            fields[f.name] = _enc_value(getattr(n.op, f.name))
        nodes.append({"op": n.op.KIND, "fields": fields,
                      "inputs": list(n.inputs), "outputs": list(n.outputs),
                      "phase": n.phase.value, "group": n.group})
    return {
        "name": g.name,
        "n_tensors": g._next_tid,
        "labels": {str(tid): t.label for tid, t in g.tensors.items()
                   if t.label},
        "inputs": dict(g.inputs),
        "outputs": dict(g.outputs),
        "nodes": nodes,
    }


def graph_from_json(d: Dict[str, Any]) -> MilliGraph:
    g = MilliGraph(d.get("name", ""))
    labels = {int(k): v for k, v in d.get("labels", {}).items()}
    for tid in range(int(d["n_tensors"])):
        g.new_tensor(label=labels.get(tid))
    g.inputs = {k: int(v) for k, v in d["inputs"].items()}
    g.outputs = {k: int(v) for k, v in d["outputs"].items()}
    reg = op_registry()
    for nd in d["nodes"]:
        cls = reg.get(nd["op"])
        if cls is None:
            raise KeyError(f"unknown milli op kind {nd['op']!r}")
        kwargs = {k: _dec_value(v) for k, v in nd["fields"].items()}
        op = cls(**kwargs)
        g.nodes.append(MilliNode(new_global_id(), op,
                                 [int(i) for i in nd["inputs"]],
                                 [int(o) for o in nd["outputs"]],
                                 Phase(nd.get("phase", Phase.FORWARD.value)),
                                 nd.get("group")))
    return g
