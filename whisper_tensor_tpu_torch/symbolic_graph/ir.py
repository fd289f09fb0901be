"""SymbolicGraph: the ONNX-level IR.

Reference equivalent: src/symbolic_graph/mod.rs (SymbolicGraph +
SymbolicGraphMutator). Tensors carry mixed symbolic+numeric dim info
(named ONNX dim_params intern to stable symbols); initializers live in
a lazy TensorStore; ops are typed Operation objects constructed from
NodeProtos via the registry.

`to_milli()` lowers the whole graph into one MilliGraph, which the
port's GraphExecutor runs; a graph with control flow runs in the
interpreter (backends/eval_backend.py), its If/Scan/Loop on the host and
their nested graphs (sub-graphs, bound at ingest) through the selected
mode.

The port's copy of whisper_tensor_tpu/symbolic_graph/ir.py without graph
surgery; ONNX re-export is symbolic_graph/export.py. An initializer whose store entry is lazy
(the GGUF loader's) is not materialized to lower it. `needs_host_eval`
also holds the graphs with an `ai.onnx.ml` node: those ops (label
encoders, tree ensembles, ...) run in the numpy interpreter by design.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..dtype import DType, ONNX_TO_DTYPE
from ..graph import new_global_id
from ..milli.ir import MilliGraph
from ..onnx_pb import GraphProto, ModelProto, tensor_proto_to_numpy
from ..scalar_info import ScalarInfo
from ..symbolic import SymbolicResolver
from ..tensor import NumericTensor
from ..tensor_info import TensorInfo
from .ops.base import Attrs, LowerCtx, Operation, registry
from .tensor_store import LazyTensor, TensorStore

# Initializers at or below this many elements are baked into the milli
# graph as constants (so trace-time shape folding sees them); larger
# ones become named runtime inputs fed from the TensorStore.
CONST_BAKE_MAX_ELEMENTS = 1024

# ONNX op types whose outputs are STRING tensors
_STRING_OPS = ("StringConcat", "StringSplit", "StringNormalizer",
               "RegexFullMatch")


class TensorKind(enum.Enum):
    INPUT = "input"
    OUTPUT = "output"
    INTERMEDIATE = "intermediate"
    INITIALIZER = "initializer"


@dataclass
class STensor:
    id: int
    name: str
    dtype: Optional[DType]
    info: Optional[TensorInfo]
    kind: TensorKind


@dataclass
class SOp:
    id: int
    name: str
    op: Operation
    inputs: List[Optional[int]]   # None = optional input omitted
    outputs: List[Optional[int]]  # None = optional output omitted


class UnsupportedOnnxOp(Exception):
    pass


class SymbolicGraph:
    def __init__(self, name: str = "", resolver: Optional[SymbolicResolver] = None,
                 store: Optional[TensorStore] = None,
                 opsets: Optional[Dict[str, int]] = None):
        self.id = new_global_id()
        self.name = name
        self.tensors: Dict[int, STensor] = {}
        self.by_name: Dict[str, int] = {}
        self.ops: List[SOp] = []
        self.inputs: List[int] = []
        self.outputs: List[int] = []
        self.resolver = resolver or SymbolicResolver()
        self.store = store or TensorStore()
        self.opsets = opsets or {"": 21}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_tensor(self, name: str, dtype: Optional[DType] = None,
                   info: Optional[TensorInfo] = None,
                   kind: TensorKind = TensorKind.INTERMEDIATE) -> int:
        if name in self.by_name:
            return self.by_name[name]
        tid = new_global_id()
        self.tensors[tid] = STensor(tid, name, dtype, info, kind)
        self.by_name[name] = tid
        return tid

    def add_input(self, name: str, dtype: DType, dims: Sequence) -> int:
        info = TensorInfo.shaped(dtype, [self._dim(d) for d in dims])
        tid = self.add_tensor(name, dtype, info, TensorKind.INPUT)
        self.inputs.append(tid)
        return tid

    def add_initializer(self, name: str, value) -> int:
        """value: np.ndarray or NumericTensor."""
        if isinstance(value, np.ndarray):
            value = NumericTensor.from_numpy(value)
        self.store.put(name, value)
        info = TensorInfo.shaped(value.dtype, list(value.shape))
        tid = self.add_tensor(name, value.dtype, info, TensorKind.INITIALIZER)
        self.tensors[tid].kind = TensorKind.INITIALIZER
        return tid

    def add_op(self, op: Operation, inputs: Sequence[Optional[str]],
               outputs: Sequence[Optional[str]], name: str = "") -> SOp:
        in_ids = [self.by_name.get(n) if n else None for n in inputs]
        for n, i in zip(inputs, in_ids):
            if n and i is None:
                raise KeyError(f"op {name or op.OP_TYPE}: unknown input tensor {n!r}")
        out_ids = [self.add_tensor(n) if n else None for n in outputs]
        sop = SOp(new_global_id(), name or f"{op.OP_TYPE}_{len(self.ops)}", op,
                  in_ids, out_ids)
        self.ops.append(sop)
        return sop

    def mark_output(self, name: str) -> None:
        self.outputs.append(self.by_name[name])

    def _dim(self, d) -> ScalarInfo:
        if isinstance(d, str):
            return ScalarInfo.of(self.resolver.new_symbol(d))
        if isinstance(d, ScalarInfo):
            return d
        return ScalarInfo.of(int(d))

    # ------------------------------------------------------------------
    # ONNX ingest
    # ------------------------------------------------------------------
    @staticmethod
    def from_onnx_bytes(data: bytes, base_dir: Optional[str] = None) -> "SymbolicGraph":
        model = ModelProto.parse(data)
        return SymbolicGraph.from_model_proto(model, base_dir)

    @staticmethod
    def from_model_proto(model: ModelProto, base_dir: Optional[str] = None) -> "SymbolicGraph":
        opsets = {o.domain: int(o.version) for o in model.opset_import} or {"": 21}
        resolver = SymbolicResolver()
        store = TensorStore()
        return SymbolicGraph._from_graph_proto(model.graph, resolver, store,
                                               opsets, base_dir)

    @staticmethod
    def _from_graph_proto(gp: GraphProto, resolver: SymbolicResolver,
                          store: TensorStore, opsets: Dict[str, int],
                          base_dir: Optional[str]) -> "SymbolicGraph":
        g = SymbolicGraph(gp.name, resolver, store, opsets)
        init_names = set()
        for tp in gp.initializer:
            size = 1
            for d in tp.dims:
                size *= int(d)
            has_payload = (bool(tp.raw_data) or tp.data_location == 1
                           or bool(tp.float_data) or bool(tp.int32_data)
                           or bool(tp.int64_data) or bool(tp.double_data)
                           or bool(tp.uint64_data) or bool(tp.string_data)
                           or size == 0)
            if has_payload:
                arr = tensor_proto_to_numpy(tp, base_dir)
                g.add_initializer(tp.name, arr)
            else:
                # structure-only initializer (an ONNX written without
                # payloads): register dtype/shape metadata only
                dt = ONNX_TO_DTYPE.get(tp.data_type)
                info = TensorInfo.shaped(dt, [int(d) for d in tp.dims]) \
                    if dt is not None else None
                g.add_tensor(tp.name, dt, info, TensorKind.INITIALIZER)
            init_names.add(tp.name)
        for vi in gp.input:
            if vi.name in init_names:
                continue
            dt, dims = _value_info(vi, resolver)
            tid = g.add_tensor(vi.name, dt,
                               TensorInfo.shaped(dt, dims) if dt and dims is not None else
                               (TensorInfo.minimal(dt) if dt else None),
                               TensorKind.INPUT)
            g.inputs.append(tid)
        for vi in gp.value_info:
            dt, dims = _value_info(vi, resolver)
            if vi.name not in g.by_name:
                g.add_tensor(vi.name, dt,
                             TensorInfo.shaped(dt, dims) if dt and dims is not None else
                             (TensorInfo.minimal(dt) if dt else None))
        reg = registry()
        opset = opsets.get("", 21)
        for node in gp.node:
            cls = reg.get(node.op_type)
            if cls is None:
                raise UnsupportedOnnxOp(
                    f"unsupported ONNX op {node.op_type!r} (node {node.name!r})")
            attrs = Attrs(node, base_dir)
            op = cls.from_onnx(node, attrs, opset)
            op.OP_TYPE = node.op_type  # instance-level: shared classes
            # keep the source attributes for lossless ONNX re-export
            # (symbolic_graph/export.py)
            op._onnx_attrs = list(node.attribute)
            op._onnx_domain = node.domain or ""
            # control-flow ops parse their nested graphs here
            if hasattr(op, "_bind_subgraphs"):
                op._bind_subgraphs(node, attrs, resolver, store, opsets,
                                   base_dir)
            # unknown input names are outer-scope captures (ONNX subgraph
            # semantics) or forward references; create placeholders.
            for n in node.input:
                if n and n not in g.by_name:
                    g.add_tensor(n)
            g.add_op(op, [n or None for n in node.input],
                     [n or None for n in node.output], node.name)
        for vi in gp.output:
            dt, dims = _value_info(vi, resolver)
            if vi.name not in g.by_name:
                g.add_tensor(vi.name, dt, None)
            tid = g.by_name[vi.name]
            t = g.tensors[tid]
            t.kind = TensorKind.OUTPUT
            if t.dtype is None:
                t.dtype = dt
            if t.info is None and dt is not None and dims is not None:
                t.info = TensorInfo.shaped(dt, dims)
            g.outputs.append(tid)
        return g

    # mutation (the reference's, symbolic_graph/ir.py:248-257; surgery.py
    # uses it)
    # ------------------------------------------------------------------
    def producer_of(self, tid: int) -> Optional[SOp]:
        for op in self.ops:
            if tid in op.outputs:
                return op
        return None

    def consumers_of(self, tid: int) -> List[SOp]:
        return [op for op in self.ops if tid in op.inputs]

    def replace_tensor(self, old: int, new: int) -> None:
        for op in self.ops:
            op.inputs = [new if i == old else i for i in op.inputs]
        self.outputs = [new if i == old else i for i in self.outputs]

    def remove_op(self, sop: SOp) -> None:
        self.ops.remove(sop)

    def topo_sort(self) -> List[SOp]:
        produced = set(self.inputs)
        for tid, t in self.tensors.items():
            if t.kind is TensorKind.INITIALIZER:
                produced.add(tid)
        remaining = list(self.ops)
        ordered: List[SOp] = []
        while remaining:
            progressed = False
            rest = []
            for op in remaining:
                if all(i is None or i in produced for i in op.inputs
                       if self._is_produced_tensor(i)):
                    ordered.append(op)
                    produced.update(o for o in op.outputs if o is not None)
                    progressed = True
                else:
                    rest.append(op)
            remaining = rest
            if not progressed and remaining:
                names = [o.name for o in remaining[:5]]
                raise RuntimeError(f"graph has a cycle or missing producers: {names}")
        return ordered

    _producer_cache: Optional[Dict[int, SOp]] = None

    def producer_of_cached(self, tid: int) -> Optional[SOp]:
        if self._producer_cache is None or len(self._producer_cache_ops or []) != len(self.ops):
            self._producer_cache = {}
            for op in self.ops:
                for o in op.outputs:
                    if o is not None:
                        self._producer_cache[o] = op
            self._producer_cache_ops = list(self.ops)
        return self._producer_cache.get(tid)

    _producer_cache_ops: Optional[List[SOp]] = None

    def _is_produced_tensor(self, tid: Optional[int]) -> bool:
        if tid is None:
            return False
        t = self.tensors[tid]
        if t.kind in (TensorKind.INPUT, TensorKind.INITIALIZER):
            return False
        return self.producer_of_cached(tid) is not None

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------
    def has_control_flow(self) -> bool:
        return any(op.op.sub_graphs() for op in self.ops)

    def needs_host_eval(self) -> bool:
        """True when the graph carries values torch cannot represent:
        sequence/optional host containers (ops that execute via
        eval_direct), STRING tensors (declared, or made by a string op or
        a Cast to STRING), or an `ai.onnx.ml` node. Such graphs run on
        the host interpreter (reference :308-323)."""
        if any(hasattr(op.op, "eval_direct") and not op.op.sub_graphs()
               for op in self.ops):
            return True
        if any(getattr(op.op, "_onnx_domain", "") == "ai.onnx.ml"
               or op.op.OP_TYPE in _STRING_OPS
               or getattr(op.op, "to", None) is DType.STRING
               for op in self.ops):
            return True
        return any(t.info is not None and t.info.dtype == DType.STRING
                   for t in self.tensors.values())

    # ------------------------------------------------------------------
    # ONNX export (inverse of from_onnx_bytes; symbolic_graph/export.py)
    # ------------------------------------------------------------------
    def to_onnx_bytes(self, weights: str = "embed", sink=None) -> bytes:
        from .export import to_onnx_bytes

        return to_onnx_bytes(self, weights=weights, sink=sink)

    def save_onnx(self, path: str, weights: str = "embed") -> None:
        from .export import save_onnx

        save_onnx(self, path, weights=weights)

    def to_milli(self, group: Optional[str] = None,
                 bake_small_constants: bool = True) -> Tuple[MilliGraph, Dict[str, str]]:
        """Lower the whole graph to one MilliOpGraph.

        Returns (milli_graph, weight_inputs) where weight_inputs maps
        milli input name -> store tensor name for initializer feeds.
        (Reference: generate_milli_graph, src/symbolic_graph/mod.rs:716.)
        """
        if self.has_control_flow():
            raise UnsupportedOnnxOp("whole-graph lowering with control flow; "
                                    "use the interpreter path")
        milli = MilliGraph(self.name)
        ctx = LowerCtx(milli, group)
        tmap: Dict[int, int] = {}
        weight_inputs: Dict[str, str] = {}
        for tid in self.inputs:
            t = self.tensors[tid]
            tmap[tid] = milli.add_input(t.name, t.info)
        for tid, t in self.tensors.items():
            if t.kind is TensorKind.INITIALIZER:
                tmap[tid] = self._lower_initializer(ctx, milli, t, weight_inputs,
                                                    bake_small_constants)
        # outer-scope captures: tensors consumed but never produced here
        # (subgraph placeholders) become extra milli inputs fed by the
        # caller's environment.
        produced = set(self.inputs)
        for sop in self.ops:
            produced.update(o for o in sop.outputs if o is not None)
        for sop in self.ops:
            for i in sop.inputs:
                if i is not None and i not in produced and i not in tmap:
                    tmap[i] = milli.add_input(self.tensors[i].name,
                                              self.tensors[i].info)
        for sop in self.topo_sort():
            ins = [tmap.get(i) if i is not None else None for i in sop.inputs]
            n_out = len(sop.outputs)
            outs = sop.op.lower(ctx, ins, n_out)
            for st, mt in zip(sop.outputs, outs):
                if st is not None and mt is not None:
                    tmap[st] = mt
                    milli.tensors[mt].label = self.tensors[st].name
                    milli.tensors[mt].source_tensor = st
        for tid in self.outputs:
            milli.mark_output(self.tensors[tid].name, tmap[tid])
        return milli, weight_inputs

    def _lower_initializer(self, ctx: LowerCtx, milli: MilliGraph, t: STensor,
                           weight_inputs: Dict[str, str],
                           bake_small_constants: bool = True) -> int:
        if t.name in self.store and bake_small_constants:
            # a small NumericTensor bakes as a constant; a LazyTensor is
            # materialized only if it is that small (reference :387-404,
            # which materializes every lazy entry to count it)
            stored = self.store.raw(t.name)
            if isinstance(stored, LazyTensor):
                dims = t.info.dims() if t.info is not None else None
                small = dims is not None and all(d.is_known for d in dims) \
                    and int(np.prod([int(d.value()) for d in dims])) \
                    <= CONST_BAKE_MAX_ELEMENTS
                stored = self.store.get(t.name) if small else None
            if isinstance(stored, NumericTensor) \
                    and stored.size <= CONST_BAKE_MAX_ELEMENTS:
                return ctx.const(stored.numpy())
        # big weight (or one whose payload comes with a shared store, or
        # a packed one): a runtime input
        name = t.name
        info = t.info
        mt = milli.add_input(name, info)
        weight_inputs[name] = name
        return mt

    # ------------------------------------------------------------------
    def __repr__(self) -> str:
        return (f"SymbolicGraph({self.name!r}, {len(self.ops)} ops, "
                f"{len(self.inputs)} in, {len(self.outputs)} out, "
                f"{len(self.store)} stored tensors)")


def _value_info(vi, resolver: SymbolicResolver):
    dt = None
    dims = None
    if vi.type is not None and vi.type.tensor_type is not None:
        tt = vi.type.tensor_type
        dt = ONNX_TO_DTYPE.get(tt.elem_type)
        if tt.shape is not None:
            dims = []
            for d in tt.shape.dim:
                if d.dim_param:
                    dims.append(ScalarInfo.of(resolver.new_symbol(d.dim_param)))
                elif d.dim_value > 0:
                    dims.append(ScalarInfo.of(int(d.dim_value)))
                else:
                    # proto3 cannot distinguish absent from 0 here; treat as
                    # an unknown (fresh anonymous symbolic) dim.
                    dims.append(ScalarInfo.of(resolver.new_symbol()))
    return dt, dims
