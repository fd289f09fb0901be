"""Data-movement and shape symbolic ops -> milli lowerings.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/data.py,
trimmed to the ONNX op types the llama and GPT-2 recipes emit:
Constant, Shape, Reshape, Transpose, Squeeze, Unsqueeze, Split, Gather
and Range. Any other op type raises UnsupportedOnnxOp at import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ...milli.ops import (Gather, Range, Reshape, Shape, Split, Squeeze,
                          Transpose, Unsqueeze)
from .base import Operation, register


@register("Constant")
@dataclass
class ConstantOp(Operation):
    value: np.ndarray = None  # type: ignore[assignment]

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        if "value" in attrs:
            return cls(attrs.t("value"))
        if "value_float" in attrs:
            return cls(np.asarray(attrs.f("value_float"), dtype=np.float32))
        if "value_int" in attrs:
            return cls(np.asarray(attrs.i("value_int"), dtype=np.int64))
        if "value_floats" in attrs:
            return cls(np.asarray(attrs.floats("value_floats"), dtype=np.float32))
        if "value_ints" in attrs:
            return cls(np.asarray(attrs.ints("value_ints"), dtype=np.int64))
        if "value_string" in attrs:
            return cls(np.asarray(attrs.s("value_string"), dtype=object))
        if "value_strings" in attrs:
            return cls(np.asarray(attrs.strings("value_strings"), dtype=object))
        raise ValueError("Constant node without a value attribute")

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.const(self.value)]

    def properties(self):
        v = np.asarray(self.value)
        return {"dtype": str(v.dtype), "shape": list(v.shape)}


@register("Shape")
@dataclass
class ShapeOp(Operation):
    start: int = 0
    end: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("start", 0), attrs.i("end", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Shape(self.start, self.end), inputs[0])]


@register("Reshape")
@dataclass
class ReshapeOp(Operation):
    allowzero: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("allowzero", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Reshape(self.allowzero), inputs[0], inputs[1])]


@register("Transpose")
@dataclass
class TransposeOp(Operation):
    perm: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("perm", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Transpose(self.perm), inputs[0])]


@register("Squeeze")
@dataclass
class SqueezeOp(Operation):
    axes: Optional[List[int]] = None  # pre-13 attribute form

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("axes", None))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) > 1 and inputs[1] is not None:
            return [ctx.emit1(Squeeze(), inputs[0], inputs[1])]
        return [ctx.emit1(Squeeze(self.axes), inputs[0])]


@register("Unsqueeze")
@dataclass
class UnsqueezeOp(Operation):
    axes: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("axes", None))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) > 1 and inputs[1] is not None:
            return [ctx.emit1(Unsqueeze(), inputs[0], inputs[1])]
        return [ctx.emit1(Unsqueeze(self.axes or []), inputs[0])]


@register("Split")
@dataclass
class SplitOp(Operation):
    axis: int = 0
    split_attr: Optional[List[int]] = None
    num_outputs: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0), attrs.ints("split", None),
                   attrs.i("num_outputs", len(node.output)))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) > 1 and inputs[1] is not None:
            op = Split(self.axis, [], num_outputs=n_outputs)
            return ctx.emit(op, inputs[0], inputs[1], n_outputs=n_outputs)
        op = Split(self.axis, self.split_attr or [], num_outputs=n_outputs)
        return ctx.emit(op, inputs[0], n_outputs=n_outputs)


@register("Gather")
@dataclass
class GatherOp(Operation):
    axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Gather(self.axis), inputs[0], inputs[1])]


@register("Range")
class RangeOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Range(), inputs[0], inputs[1], inputs[2])]
