"""Programmatic ONNX construction DSL.

Reference equivalent: crates/whisper-tensor-import/src/onnx_graph/
(operators.rs ~75 constructors; mod.rs:56-80 WeightStorageStrategy;
weights.rs weight managers). Python redesign: one generic `node()`
emitter with attribute coercion plus typed sugar methods; weight
storage strategies Embed / BinFile / NoWeights / Sink / OriginReference.

The port's copy of whisper_tensor_tpu/importers/onnx_builder.py: it
writes the bytes the JAX package writes, external-data records (a .bin
file's location/offset/length, an origin's format/tensor_name/location
and a .pth span's offset/length) with the same keys in the same order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..dtype import DTYPE_TO_ONNX, DType
from ..onnx_pb import (AttributeProto, AttrType, GraphProto, ModelProto,
                       NodeProto, OperatorSetIdProto, StringStringEntryProto,
                       TensorProto, TensorShapeDim, TensorShapeProto,
                       TensorTypeProto, TypeProto, ValueInfoProto,
                       numpy_to_tensor_proto)

# Weight payloads larger than this are candidates for external storage.
EXTERNAL_THRESHOLD_BYTES = 1 << 20


@dataclass
class WeightStorage:
    """Storage strategy for initializer payloads.

    kind: "embed" (raw_data inline), "bin" (single external .bin file),
    "none" (structure only — payloads dropped; for shape-only tests,
    reference WeightStorageStrategy::None), "sink" (structure only in
    the ONNX bytes, but every initializer VALUE lands in the given dict
    — the caller installs them into the TensorStore directly, so large
    payloads never round-trip through protobuf serialization),
    "origin" (reference WeightStorageStrategy::OriginReference,
    onnx_graph/mod.rs:56-80 + weights.rs:233-420: initializers become
    external-data protos whose `location` points back at the ORIGINAL
    checkpoint file — .pth zip member offsets or a safetensors tensor
    name — so the exported ONNX carries no payload bytes yet loads
    anywhere the origin checkpoint exists. Initializers without origin
    metadata (generated/derived arrays) embed inline.)
    """

    kind: str = "embed"
    bin_path: Optional[str] = None
    sink: Optional[dict] = None

    @staticmethod
    def embed() -> "WeightStorage":
        return WeightStorage("embed")

    @staticmethod
    def bin_file(path: str) -> "WeightStorage":
        return WeightStorage("bin", path)

    @staticmethod
    def none() -> "WeightStorage":
        return WeightStorage("none")

    @staticmethod
    def to_sink(sink: dict) -> "WeightStorage":
        return WeightStorage("sink", sink=sink)

    @staticmethod
    def origin_reference() -> "WeightStorage":
        return WeightStorage("origin")


class LazyWeight:
    """Deferred weight payload (e.g. a safetensors slice); materialized
    only when the chosen storage strategy needs bytes.

    origin: optional provenance for WeightStorage.origin_reference() —
    a dict with keys `format` ("pth" | "safetensors"), `location`
    (origin file path), `tensor_name`, and for pth `offset`/`length`
    (byte span of the tensor inside the checkpoint). Mirrors the
    external_data entries the reference writes
    (onnx_graph/weights.rs:318-410)."""

    def __init__(self, loader, dtype: DType, shape: Tuple[int, ...],
                 origin: Optional[Dict[str, str]] = None):
        self.loader = loader
        self.dtype = dtype
        self.shape = tuple(int(d) for d in shape)
        self.origin = origin

    def load(self) -> np.ndarray:
        arr = self.loader()
        return np.ascontiguousarray(np.asarray(arr, dtype=self.dtype.to_numpy()))


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
        self.initializers: Dict[str, Union[np.ndarray, LazyWeight]] = {}
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

    def hint_shape(self, name: str, dtype: DType, shape: Sequence[Union[int, str]]) -> str:
        self.value_infos.append(_value_info(name, dtype, shape))
        return name

    def initializer(self, name: str, value: Union[np.ndarray, LazyWeight]) -> str:
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

    def gemm(self, a, b, c=None, trans_b=False):
        return self.node("Gemm", [a, b] + ([c] if c else []),
                         transB=1 if trans_b else None)

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
        bin_f = None
        bin_rel = None
        try:
            if storage.kind == "bin":
                os.makedirs(os.path.dirname(os.path.abspath(storage.bin_path)),
                            exist_ok=True)
                bin_f = open(storage.bin_path, "wb")
                bin_rel = os.path.basename(storage.bin_path)
            for name, w in self.initializers.items():
                if storage.kind == "sink":
                    storage.sink[name] = w
                if storage.kind in ("none", "sink"):
                    arr_shape = w.shape
                    dt = (w.dtype if isinstance(w, LazyWeight)
                          else DType.from_numpy(w.dtype))
                    tp = TensorProto(name=name, data_type=DTYPE_TO_ONNX[dt],
                                     dims=[int(d) for d in arr_shape])
                    g.initializer.append(tp)
                    continue
                if (storage.kind == "origin" and isinstance(w, LazyWeight)
                        and w.origin):
                    tp = TensorProto(name=name,
                                     data_type=DTYPE_TO_ONNX[w.dtype],
                                     dims=[int(d) for d in w.shape],
                                     data_location=1)
                    # key order matches the reference's external_data
                    # (weights.rs:318-352): format, tensor_name,
                    # location, then pth offset/length
                    tp.external_data = [
                        StringStringEntryProto(key=k, value=str(w.origin[k]))
                        for k in ("format", "tensor_name", "location",
                                  "offset", "length") if k in w.origin]
                    g.initializer.append(tp)
                    continue
                arr = w.load() if isinstance(w, LazyWeight) else np.asarray(w)
                dt = (w.dtype if isinstance(w, LazyWeight)
                      else DType.from_numpy(arr.dtype))
                nbytes = arr.nbytes
                if storage.kind == "bin" and nbytes >= EXTERNAL_THRESHOLD_BYTES:
                    offset = bin_f.tell()
                    raw = np.ascontiguousarray(arr).tobytes()
                    bin_f.write(raw)
                    tp = TensorProto(name=name, data_type=DTYPE_TO_ONNX[dt],
                                     dims=[int(d) for d in arr.shape],
                                     data_location=1)
                    tp.external_data = [
                        StringStringEntryProto(key="location", value=bin_rel),
                        StringStringEntryProto(key="offset", value=str(offset)),
                        StringStringEntryProto(key="length", value=str(len(raw))),
                    ]
                    g.initializer.append(tp)
                else:
                    g.initializer.append(numpy_to_tensor_proto(arr, name, dt))
        finally:
            if bin_f is not None:
                bin_f.close()
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
