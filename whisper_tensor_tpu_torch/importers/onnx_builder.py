"""Programmatic ONNX construction DSL.

Reference equivalent: crates/whisper-tensor-import/src/onnx_graph/
(operators.rs ~75 constructors; mod.rs:56-80 WeightStorageStrategy;
weights.rs weight managers). Python redesign: one generic `node()`
emitter with attribute coercion plus typed sugar methods.

The port's copy of whisper_tensor_tpu/importers/onnx_builder.py, trimmed
to the weight storages the port's loaders use (WeightStorage, :29-70):
"embed" (every initializer inline, the default), "none" (structure
only) and "sink" (structure only, every initializer value handed to a
dict: the GGUF loader installs them in the TensorStore itself). The
reference's external .bin file and origin-reference strategies (with
LazyWeight), `hint_shape` and `gemm` are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..dtype import DTYPE_TO_ONNX, DType
from ..onnx_pb import (AttributeProto, AttrType, GraphProto, ModelProto,
                       NodeProto, OperatorSetIdProto, TensorProto,
                       TensorShapeDim, TensorShapeProto, TensorTypeProto,
                       TypeProto, ValueInfoProto, numpy_to_tensor_proto)


@dataclass
class WeightStorage:
    """Storage strategy for initializer payloads.

    kind: "embed" (raw_data inline), "none" (structure only — payloads
    dropped; reference WeightStorageStrategy::None), "sink" (structure
    only in the ONNX bytes, but every initializer VALUE lands in the
    given dict — the caller installs them into the TensorStore directly,
    so large payloads never round-trip through protobuf serialization).
    """

    kind: str = "embed"
    sink: Optional[dict] = None

    @staticmethod
    def embed() -> "WeightStorage":
        return WeightStorage("embed")

    @staticmethod
    def none() -> "WeightStorage":
        return WeightStorage("none")

    @staticmethod
    def to_sink(sink: dict) -> "WeightStorage":
        return WeightStorage("sink", sink=sink)


def _shape_proto(dims: Sequence[Union[int, str]]) -> TensorShapeProto:
    sp = TensorShapeProto()
    for d in dims:
        dim = TensorShapeDim()
        if isinstance(d, str):
            dim.dim_param = d
        else:
            dim.dim_value = int(d)
        sp.dim.append(dim)
    return sp


def _value_info(name: str, dtype: DType, dims: Sequence[Union[int, str]]) -> ValueInfoProto:
    tt = TensorTypeProto(elem_type=DTYPE_TO_ONNX[dtype], shape=_shape_proto(dims))
    return ValueInfoProto(name=name, type=TypeProto(tensor_type=tt))


def _attr(name: str, v: Any) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(v, AttributeProto):
        return v
    if isinstance(v, bool):
        a.type, a.i = AttrType.INT, int(v)
    elif isinstance(v, int):
        a.type, a.i = AttrType.INT, v
    elif isinstance(v, float):
        a.type, a.f = AttrType.FLOAT, v
    elif isinstance(v, str):
        a.type, a.s = AttrType.STRING, v.encode("utf-8")
    elif isinstance(v, np.ndarray):
        a.type, a.t = AttrType.TENSOR, numpy_to_tensor_proto(v, name)
    elif isinstance(v, GraphProto):
        a.type, a.g = AttrType.GRAPH, v
    elif isinstance(v, (list, tuple)):
        if all(isinstance(x, int) for x in v):
            a.type, a.ints = AttrType.INTS, [int(x) for x in v]
        elif all(isinstance(x, float) for x in v):
            a.type, a.floats = AttrType.FLOATS, [float(x) for x in v]
        elif all(isinstance(x, str) for x in v):
            a.type, a.strings = AttrType.STRINGS, [x.encode("utf-8") for x in v]
        else:
            raise TypeError(f"attribute {name}: bad list {v!r}")
    else:
        raise TypeError(f"attribute {name}: unsupported {type(v)}")
    return a


class OnnxBuilder:
    def __init__(self, name: str = "graph", opset: int = 23,
                 custom_opsets: Optional[Dict[str, int]] = None):
        self.name = name
        self.opset = opset
        self.custom_opsets = custom_opsets or {}
        self.nodes: List[NodeProto] = []
        self.inputs: List[ValueInfoProto] = []
        self.outputs: List[ValueInfoProto] = []
        self.value_infos: List[ValueInfoProto] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self._counter = 0

    # -- naming --------------------------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    # -- graph I/O ------------------------------------------------------
    def input(self, name: str, dtype: DType, shape: Sequence[Union[int, str]]) -> str:
        self.inputs.append(_value_info(name, dtype, shape))
        return name

    def output(self, name: str, dtype: DType, shape: Sequence[Union[int, str]]) -> str:
        self.outputs.append(_value_info(name, dtype, shape))
        return name

    def initializer(self, name: str, value: np.ndarray) -> str:
        self.initializers[name] = value
        return name

    # -- nodes ------------------------------------------------------------
    def node(self, op_type: str, inputs: Sequence[Optional[str]],
             n_outputs: int = 1, name: Optional[str] = None,
             outputs: Optional[Sequence[str]] = None,
             domain: str = "", **attrs) -> Union[str, Tuple[str, ...]]:
        outs = (list(outputs) if outputs is not None
                else [self.fresh(op_type.lower()) for _ in range(n_outputs)])
        n = NodeProto(op_type=op_type,
                      input=[i or "" for i in inputs],
                      output=list(outs),
                      name=name or self.fresh(f"n_{op_type}"),
                      domain=domain)
        n.attribute = [_attr(k, v) for k, v in attrs.items() if v is not None]
        self.nodes.append(n)
        n_real = len(outs)
        return outs[0] if n_real == 1 else tuple(outs)

    # -- common sugar -------------------------------------------------------
    def const(self, value: np.ndarray, name: Optional[str] = None) -> str:
        return self.node("Constant", [], name=name, value=np.asarray(value))

    def const_i64(self, values, name: Optional[str] = None) -> str:
        return self.const(np.asarray(values, dtype=np.int64), name)

    def add(self, a, b):
        return self.node("Add", [a, b])

    def mul(self, a, b):
        return self.node("Mul", [a, b])

    def matmul(self, a, b):
        return self.node("MatMul", [a, b])

    def reshape(self, x, shape) -> str:
        if not isinstance(shape, str):
            shape = self.const_i64(shape)
        return self.node("Reshape", [x, shape])

    def transpose(self, x, perm):
        return self.node("Transpose", [x], perm=list(perm))

    def softmax(self, x, axis=-1):
        return self.node("Softmax", [x], axis=axis)

    def cast(self, x, dtype: DType):
        return self.node("Cast", [x], to=DTYPE_TO_ONNX[dtype])

    def layer_norm(self, x, scale, bias=None, axis=-1, epsilon=1e-5):
        return self.node("LayerNormalization", [x, scale] + ([bias] if bias else []),
                         axis=axis, epsilon=epsilon)

    def rms_norm(self, x, scale, axis=-1, epsilon=1e-5):
        return self.node("RMSNormalization", [x, scale], axis=axis, epsilon=epsilon)

    def gather(self, data, idx, axis=0):
        return self.node("Gather", [data, idx], axis=axis)

    def concat(self, xs, axis):
        return self.node("Concat", list(xs), axis=axis)

    def slice_(self, x, starts, ends, axes=None, steps=None):
        args = [x, self.const_i64(starts), self.const_i64(ends)]
        if axes is not None:
            args.append(self.const_i64(axes))
        if steps is not None:
            args.append(self.const_i64(steps))
        return self.node("Slice", args)

    def attention(self, q, k, v, mask=None, scale=None, is_causal=False,
                  softcap=None):
        return self.node("Attention", [q, k, v] + ([mask] if mask else []),
                         scale=scale, is_causal=1 if is_causal else None,
                         softcap=softcap)

    def rotary(self, x, cos, sin, position_ids=None, interleaved=False):
        return self.node("RotaryEmbedding",
                         [x, cos, sin] + ([position_ids] if position_ids else []),
                         interleaved=1 if interleaved else None)

    # -- build ----------------------------------------------------------------
    def build_graph_proto(self, storage: WeightStorage) -> GraphProto:
        g = GraphProto(name=self.name, node=self.nodes,
                       input=self.inputs, output=self.outputs,
                       value_info=self.value_infos)
        for name, w in self.initializers.items():
            arr = np.asarray(w)
            dt = DType.from_numpy(arr.dtype)
            if storage.kind == "sink":
                storage.sink[name] = w
            if storage.kind in ("none", "sink"):
                g.initializer.append(TensorProto(
                    name=name, data_type=DTYPE_TO_ONNX[dt],
                    dims=[int(d) for d in arr.shape]))
                continue
            g.initializer.append(numpy_to_tensor_proto(arr, name, dt))
        return g

    def build(self, storage: Optional[WeightStorage] = None,
              producer: str = "whisper-tensor-tpu") -> bytes:
        storage = storage or WeightStorage.embed()
        m = ModelProto(ir_version=10, producer_name=producer,
                       graph=self.build_graph_proto(storage))
        m.opset_import = [OperatorSetIdProto(domain="", version=self.opset)]
        for dom, ver in self.custom_opsets.items():
            m.opset_import.append(OperatorSetIdProto(domain=dom, version=ver))
        return m.dumps()
