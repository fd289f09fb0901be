"""SymbolicGraph -> ONNX serialization (the inverse of from_onnx_bytes).

The reference keeps ONNX as the interchange language: its import crate
*emits* ONNX bytes (crates/whisper-tensor-import/src/lib.rs:38-63) and
its SymbolicGraph serializes via serde. Here the same role is filled by
round-tripping through ONNX itself: any live SymbolicGraph — imported,
recipe-built, or surgered (`surgery.py`, `milli.transforms`) — can be
written back to a valid ModelProto and re-imported with identical
semantics, which is what makes surgered models shippable artifacts.

Fidelity strategy:
  * ops imported from ONNX keep their original AttributeProtos
    (`Operation._onnx_attrs`, stashed by `ir._from_graph_proto`) and
    re-emit them verbatim — no per-op re-serialization code to drift;
  * control-flow subgraph attributes (If then/else, Scan/Loop body) are
    re-encoded from the LIVE nested SymbolicGraphs so nested surgery
    survives export (`Operation.sub_graph_attrs`);
  * ops constructed programmatically declare `to_onnx_attrs()`;
    attr-free ops (MatMul/Add/...) need nothing;
  * initializers come from the TensorStore: embedded raw_data, a
    side-by-side .bin with ONNX external_data records, or
    structure-only (dims+dtype, WeightStorage.none() style).

The port's copy of whisper_tensor_tpu/symbolic_graph/export.py,
unchanged: it writes the bytes the JAX package writes. Like the
reference it builds the whole ModelProto in memory and checks no size:
`embed` past ONNX's 2 GiB protobuf limit is written as it is (protobuf
based ONNX tools refuse such a file); `external` keeps the proto small.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..dtype import DTYPE_TO_ONNX, DType
from ..onnx_pb import (
    AttributeProto,
    AttrType,
    GraphProto,
    ModelProto,
    NodeProto,
    OperatorSetIdProto,
    StringStringEntryProto,
    TensorShapeDim,
    TensorShapeProto,
    TensorTypeProto,
    TypeProto,
    ValueInfoProto,
    numpy_to_tensor_proto,
)
from .ir import SymbolicGraph, TensorKind


class ExternalSink:
    """Accumulates raw weight bytes for ONNX external_data storage."""

    def __init__(self, location: str):
        self.location = location  # relative name recorded in the model
        self.chunks: List[bytes] = []
        self.offset = 0

    def append(self, raw: bytes) -> tuple:
        # ONNX requires 4-byte alignment of external offsets; pad to 64
        # for mmap-friendly slices
        pad = (-self.offset) % 64
        if pad:
            self.chunks.append(b"\0" * pad)
            self.offset += pad
        off = self.offset
        self.chunks.append(raw)
        self.offset += len(raw)
        return off, len(raw)

    def write(self, directory: str) -> str:
        path = os.path.join(directory, self.location)
        with open(path, "wb") as f:
            for c in self.chunks:
                f.write(c)
        return path


def _dim_proto(d) -> TensorShapeDim:
    dd = TensorShapeDim()
    if d.numeric is not None:
        dd.dim_value = int(d.numeric)
    else:
        s = d.symbolic
        if s.offset == 0:
            dd.dim_param = s.name or f"s{s.symbol_id}"
        # symbol+offset has no ONNX spelling; leave unknown (re-imports
        # as a fresh anonymous symbol)
    return dd


def _value_info_proto(t) -> ValueInfoProto:
    vi = ValueInfoProto()
    vi.name = t.name
    tt = TensorTypeProto()
    if t.dtype is not None:
        tt.elem_type = DTYPE_TO_ONNX[t.dtype]
    dims = t.info.dims() if t.info is not None else None
    if dims is not None:
        sh = TensorShapeProto()
        sh.dim = [_dim_proto(d) for d in dims]
        tt.shape = sh
    tp = TypeProto()
    tp.tensor_type = tt
    vi.type = tp
    return vi


def _attr_from_value(name: str, v: Any) -> AttributeProto:
    a = AttributeProto()
    a.name = name
    if isinstance(v, SymbolicGraph):
        a.type = AttrType.GRAPH
        a.g = graph_to_graph_proto(v, weights="embed")
    elif isinstance(v, bool) or isinstance(v, (int, np.integer)):
        a.type = AttrType.INT
        a.i = int(v)
    elif isinstance(v, (float, np.floating)):
        a.type = AttrType.FLOAT
        a.f = float(v)
    elif isinstance(v, str):
        a.type = AttrType.STRING
        a.s = v.encode("utf-8")
    elif isinstance(v, bytes):
        a.type = AttrType.STRING
        a.s = v
    elif isinstance(v, np.ndarray):
        a.type = AttrType.TENSOR
        a.t = numpy_to_tensor_proto(v, name)
    elif isinstance(v, (list, tuple)):
        vals = list(v)
        if all(isinstance(x, str) for x in vals):
            a.type = AttrType.STRINGS
            a.strings = [x.encode("utf-8") for x in vals]
        elif any(isinstance(x, (float, np.floating)) for x in vals):
            a.type = AttrType.FLOATS
            a.floats = [float(x) for x in vals]
        else:
            a.type = AttrType.INTS
            a.ints = [int(x) for x in vals]
    else:
        raise TypeError(f"cannot encode ONNX attribute {name}={v!r}")
    return a


def _export_attrs(op) -> List[AttributeProto]:
    sub = op.sub_graph_attrs()
    explicit = getattr(op, "to_onnx_attrs", None)
    if explicit is not None:
        d = explicit()
        if d is not None:
            d = dict(d)
            d.update(sub)
            return [_attr_from_value(k, v) for k, v in d.items()
                    if v is not None]
    stored = getattr(op, "_onnx_attrs", None)
    if stored is None:
        if sub:
            return [_attr_from_value(k, v) for k, v in sub.items()]
        # Attr-free op (or one whose lowering ignores attrs): emit bare.
        return []
    out = []
    for a in stored:
        if a.name in sub:
            out.append(_attr_from_value(a.name, sub[a.name]))
        else:
            out.append(a)
    # subgraphs added by surgery that were never in the stored attrs
    for k, v in sub.items():
        if not any(a.name == k for a in stored):
            out.append(_attr_from_value(k, v))
    return out


def graph_to_graph_proto(g: SymbolicGraph, weights: str = "embed",
                         sink: Optional[ExternalSink] = None) -> GraphProto:
    """weights: 'embed' (raw_data in the proto), 'external' (bytes into
    `sink`, external_data records in the proto), or 'none'
    (structure-only initializers, WeightStorage.none() style)."""
    gp = GraphProto()
    gp.name = g.name or "graph"
    nodes = []
    for sop in g.topo_sort():
        n = NodeProto()
        n.name = sop.name or ""
        n.op_type = sop.op.OP_TYPE
        n.domain = getattr(sop.op, "_onnx_domain", "") or ""
        n.input = [(g.tensors[i].name if i is not None else "")
                   for i in sop.inputs]
        n.output = [(g.tensors[o].name if o is not None else "")
                    for o in sop.outputs]
        n.attribute = _export_attrs(sop.op)
        nodes.append(n)
    gp.node = nodes

    inits = []
    for tid, t in g.tensors.items():
        if t.kind is not TensorKind.INITIALIZER:
            continue
        if weights != "none" and t.name in g.store:
            dequant = t.dtype if (t.dtype is not None
                                  and t.dtype.to_numpy() is not None) \
                else DType.F32
            arr = g.store.get_numeric(t.name, dequant_dtype=dequant).numpy()
            if t.dtype is not None:
                arr = np.asarray(arr, dtype=t.dtype.to_numpy())
            tp = numpy_to_tensor_proto(arr, t.name)
            if weights == "external" and arr.nbytes > 256:
                raw = tp.raw_data
                off, length = sink.append(raw)
                tp.raw_data = b""
                tp.data_location = 1
                tp.external_data = [
                    _sse("location", sink.location),
                    _sse("offset", str(off)),
                    _sse("length", str(length)),
                ]
            inits.append(tp)
        else:
            # structure-only: dims+dtype, no payload (the importer
            # registers metadata and expects a store to be attached)
            from ..onnx_pb import TensorProto

            tp = TensorProto()
            tp.name = t.name
            if t.dtype is not None:
                tp.data_type = DTYPE_TO_ONNX[t.dtype]
            shape = t.info.concrete_shape() if t.info is not None else None
            if shape is not None:
                tp.dims = [int(d) for d in shape]
            inits.append(tp)
    gp.initializer = inits

    gp.input = [_value_info_proto(g.tensors[tid]) for tid in g.inputs]
    gp.output = [_value_info_proto(g.tensors[tid]) for tid in g.outputs]
    return gp


def _sse(k: str, v: str) -> StringStringEntryProto:
    e = StringStringEntryProto()
    e.key = k
    e.value = v
    return e


def to_model_proto(g: SymbolicGraph, weights: str = "embed",
                   sink: Optional[ExternalSink] = None) -> ModelProto:
    m = ModelProto()
    m.ir_version = 10
    m.producer_name = "whisper-tensor-tpu"
    ops = []
    for domain, version in sorted(g.opsets.items()):
        o = OperatorSetIdProto()
        o.domain = domain
        o.version = int(version)
        ops.append(o)
    m.opset_import = ops
    m.graph = graph_to_graph_proto(g, weights=weights, sink=sink)
    return m


def to_onnx_bytes(g: SymbolicGraph, weights: str = "embed",
                  sink: Optional[ExternalSink] = None) -> bytes:
    if weights == "external" and sink is None:
        raise ValueError("weights='external' requires an ExternalSink")
    return to_model_proto(g, weights=weights, sink=sink).dumps()


def save_onnx(g: SymbolicGraph, path: str, weights: str = "embed") -> None:
    """Write `path` (+ `<path>.bin` when weights='external')."""
    sink = None
    if weights == "external":
        sink = ExternalSink(os.path.basename(path) + ".bin")
    data = to_onnx_bytes(g, weights=weights, sink=sink)
    with open(path, "wb") as f:
        f.write(data)
    if sink is not None:
        sink.write(os.path.dirname(path) or ".")
