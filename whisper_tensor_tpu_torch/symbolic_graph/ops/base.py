"""Symbolic-op base: the Operation protocol + ONNX registry.

Reference equivalent: the Operation trait + AnyOperation enum
(src/symbolic_graph/ops/mod.rs:107-147, 223-286). An Operation knows:
  * how to construct itself from an ONNX NodeProto (`from_onnx`),
  * how to lower itself into milli ops (`lower`) — the reference's
    `get_milli_op_graph`, restructured as direct emission into a
    LowerCtx (no per-op sub-graph merge step needed),
  * optionally a direct `infer` override.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/base.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type

import numpy as np

from ...graph import Introspectable
from ...milli.ir import MilliGraph
from ...onnx_pb import NodeProto, tensor_proto_to_numpy
from ...tensor_info import TensorInfo

_REGISTRY: Dict[str, Type["Operation"]] = {}


def register(*op_types: str):
    def deco(cls):
        for t in op_types:
            _REGISTRY[t] = cls
        if not hasattr(cls, "OP_TYPE") or cls.OP_TYPE == "?":
            cls.OP_TYPE = op_types[0]
        return cls

    return deco


def registry() -> Dict[str, Type["Operation"]]:
    return dict(_REGISTRY)


class Attrs:
    """Typed view over a NodeProto's attributes."""

    def __init__(self, node: NodeProto, base_dir: Optional[str] = None):
        self._d = {a.name: a for a in node.attribute}
        self._base_dir = base_dir

    def __contains__(self, k):
        return k in self._d

    def f(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else float(a.f)

    def i(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else int(a.i)

    def s(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else a.s.decode("utf-8")

    def ints(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else [int(v) for v in a.ints]

    def floats(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else [float(v) for v in a.floats]

    def strings(self, k, default=None):
        a = self._d.get(k)
        return default if a is None else [v.decode("utf-8") for v in a.strings]

    def t(self, k) -> Optional[np.ndarray]:
        a = self._d.get(k)
        if a is None or a.t is None:
            return None
        return tensor_proto_to_numpy(a.t, self._base_dir)

    def g(self, k):
        a = self._d.get(k)
        return None if a is None else a.g


class LowerCtx:
    """Emission context for symbolic->milli lowering.

    Wraps the target MilliGraph plus the symbolic-tensor -> milli-tensor
    mapping; ops emit with `ctx.emit(op, *milli_ids)`.
    """

    def __init__(self, milli: MilliGraph, group: Optional[str] = None):
        self.milli = milli
        self.group = group

    def emit(self, op, *inputs: int, n_outputs: Optional[int] = None) -> List[int]:
        return self.milli.add_op(op, list(inputs), n_outputs=n_outputs,
                                 group=self.group)

    def emit1(self, op, *inputs: int) -> int:
        return self.emit(op, *inputs)[0]

    def const(self, value: np.ndarray) -> int:
        from ...milli.ops import Constant   # (milli.ops imports this module)

        return self.emit1(Constant(np.asarray(value)))

    def const_like(self, value: float, like: int) -> int:
        from ...milli.ops import CastLike, Constant

        c = self.const(np.asarray(value, dtype=np.float32))
        return self.emit1(CastLike(), c, like)


class Operation(Introspectable):
    """Base symbolic op."""

    OP_TYPE = "?"
    # number of outputs given the node (default: from the ONNX node)

    @classmethod
    def from_onnx(cls, node: NodeProto, attrs: Attrs, opset: int) -> "Operation":
        return cls()

    def lower(self, ctx: LowerCtx, inputs: List[Optional[int]],
              n_outputs: int) -> List[int]:
        raise NotImplementedError(f"{self.OP_TYPE}.lower")

    # Optional fast-path inference at the symbolic level; default None
    # means "lower to milli and use milli infer" (reference default).
    def infer(self, infos: List[Optional[TensorInfo]], n_outputs: int
              ) -> Optional[List[Optional[TensorInfo]]]:
        return None

    def display_name(self) -> str:
        return self.OP_TYPE

    # Ops with nested sub-graphs (If/Scan/Loop/SequenceMap) override this.
    def sub_graphs(self) -> list:
        return []

    # ONNX export support (symbolic_graph/export.py). Imported ops
    # re-emit their stored AttributeProtos verbatim; control-flow ops
    # override sub_graph_attrs so nested graphs re-encode LIVE (nested
    # surgery survives export). Programmatically-constructed ops with
    # attributes define to_onnx_attrs() -> {attr_name: value}.
    def sub_graph_attrs(self) -> Dict[str, Any]:
        return {}


def opset_of(model_opsets: Dict[str, int], domain: str = "") -> int:
    return model_opsets.get(domain, 0)
