"""Data-movement symbolic ops: shape manipulation, indexing, constants.

Reference equivalents: src/symbolic_graph/ops/{shape,slice,gather,...}.rs.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/data.py
without Resize, which waits for the resampling milli op
(symbolic_graph/ops/not_ported.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ...dtype import DType, ONNX_TO_DTYPE
from ...milli.ops import (ArgMinMax, CastLike, Concat, Constant,
                          ConstantOfShape, CumSum, Expand, Gather,
                          GatherElements, GatherND, NonZero, Pad,
                          RandomNormalLike, Range, Reduce, Reshape, ScatterND,
                          Shape, Slice, SizeOf, Split, Squeeze, TopK,
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


@register("ConstantOfShape")
@dataclass
class ConstantOfShapeOp(Operation):
    value: np.ndarray = None  # type: ignore[assignment]

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        v = attrs.t("value")
        if v is None:
            v = np.asarray(0.0, dtype=np.float32)
        return cls(np.asarray(v).reshape(()))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(ConstantOfShape(self.value), inputs[0])]


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


@register("Size")
class Size(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(SizeOf(), inputs[0])]


@register("Reshape")
@dataclass
class ReshapeOp(Operation):
    allowzero: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("allowzero", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Reshape(self.allowzero), inputs[0], inputs[1])]


@register("Flatten")
@dataclass
class Flatten(Operation):
    axis: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 1))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        shp = ctx.emit1(Shape(), x)
        # [prod(dims[:axis]), prod(dims[axis:])]
        if self.axis == 0:
            one = ctx.const(np.asarray([1], dtype=np.int64))
            neg1 = ctx.const(np.asarray([-1], dtype=np.int64))
            tgt = ctx.emit1(Concat(axis=0), one, neg1)
        else:
            head = ctx.emit1(Slice(), shp,
                             ctx.const(np.asarray([0], dtype=np.int64)),
                             ctx.const(np.asarray([self.axis], dtype=np.int64)))
            headp = ctx.emit1(Reduce("prod", axes=[0], keepdims=True), head)
            neg1 = ctx.const(np.asarray([-1], dtype=np.int64))
            tgt = ctx.emit1(Concat(axis=0), headp, neg1)
        return [ctx.emit1(Reshape(), x, tgt)]


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


@register("Expand")
class ExpandOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Expand(), inputs[0], inputs[1])]


@register("Concat")
@dataclass
class ConcatOp(Operation):
    axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Concat(self.axis), *inputs)]


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


@register("Slice")
@dataclass
class SliceOp(Operation):
    # opset-1 attribute form
    starts: Optional[List[int]] = None
    ends: Optional[List[int]] = None
    axes: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("starts", None), attrs.ints("ends", None),
                   attrs.ints("axes", None))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) == 1:  # attribute form
            starts = ctx.const(np.asarray(self.starts, dtype=np.int64))
            ends = ctx.const(np.asarray(self.ends, dtype=np.int64))
            args = [inputs[0], starts, ends]
            if self.axes is not None:
                args.append(ctx.const(np.asarray(self.axes, dtype=np.int64)))
            return [ctx.emit1(Slice(), *args)]
        args = [i for i in inputs if i is not None]
        return [ctx.emit1(Slice(), *args)]


@register("Pad")
@dataclass
class PadOp(Operation):
    mode: str = "constant"
    # opset-2 attribute form
    pads_attr: Optional[List[int]] = None
    value_attr: float = 0.0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("mode", "constant"), attrs.ints("pads", None),
                   attrs.f("value", 0.0))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) == 1:
            pads = ctx.const(np.asarray(self.pads_attr, dtype=np.int64))
            val = ctx.const_like(self.value_attr, inputs[0])
            return [ctx.emit1(Pad(self.mode), inputs[0], pads, val)]
        args = [i for i in inputs if i is not None]
        # preserve positional optionality: data, pads, [value], [axes]
        return [ctx.emit1(Pad(self.mode), *inputs)]


@register("Gather")
@dataclass
class GatherOp(Operation):
    axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Gather(self.axis), inputs[0], inputs[1])]


@register("GatherElements")
@dataclass
class GatherElementsOp(Operation):
    axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(GatherElements(self.axis), inputs[0], inputs[1])]


@register("GatherND")
@dataclass
class GatherNDOp(Operation):
    batch_dims: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("batch_dims", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(GatherND(self.batch_dims), inputs[0], inputs[1])]


@register("ScatterND")
@dataclass
class ScatterNDOp(Operation):
    reduction: str = "none"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("reduction", "none"))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(ScatterND(self.reduction), inputs[0], inputs[1], inputs[2])]


@register("Range")
class RangeOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Range(), inputs[0], inputs[1], inputs[2])]


@register("Tile")
class Tile(Operation):
    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import TileMilli

        return [ctx.emit1(TileMilli(), inputs[0], inputs[1])]


@register("NonZero")
class NonZeroOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(NonZero(), inputs[0])]


@register("ArgMax", "ArgMin")
@dataclass
class ArgMinMaxOp(Operation):
    mode: str = "max"
    axis: int = 0
    keepdims: bool = True
    select_last_index: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls("max" if node.op_type == "ArgMax" else "min",
                   attrs.i("axis", 0), bool(attrs.i("keepdims", 1)),
                   bool(attrs.i("select_last_index", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(ArgMinMax(self.mode, self.axis, self.keepdims,
                                    self.select_last_index), inputs[0])]


@register("TopK")
@dataclass
class TopKOp(Operation):
    axis: int = -1
    largest: bool = True
    sorted: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), bool(attrs.i("largest", 1)),
                   bool(attrs.i("sorted", 1)))

    def lower(self, ctx, inputs, n_outputs):
        return ctx.emit(TopK(self.axis, self.largest, self.sorted),
                        inputs[0], inputs[1], n_outputs=2)


@register("CumSum")
@dataclass
class CumSumOp(Operation):
    exclusive: bool = False
    reverse: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("exclusive", 0)), bool(attrs.i("reverse", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(CumSum(self.exclusive, self.reverse), inputs[0], inputs[1])]


@register("RandomNormalLike")
@dataclass
class RandomNormalLikeOp(Operation):
    mean: float = 0.0
    scale: float = 1.0
    seed: Optional[int] = None
    dtype: Optional[DType] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        dt = ONNX_TO_DTYPE.get(attrs.i("dtype", 0))
        seed = attrs.f("seed", None)
        return cls(attrs.f("mean", 0.0), attrs.f("scale", 1.0),
                   None if seed is None else int(seed), dt)

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(RandomNormalLike(self.mean, self.scale, self.seed,
                                           self.dtype), inputs[0])]


@register("Trilu")
@dataclass
class Trilu(Operation):
    upper: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("upper", 1)))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import TriluMilli

        k = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        args = [inputs[0]] + ([k] if k is not None else [])
        return [ctx.emit1(TriluMilli(self.upper), *args)]


@register("EyeLike")
@dataclass
class EyeLike(Operation):
    dtype: Optional[DType] = None
    k: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(ONNX_TO_DTYPE.get(attrs.i("dtype", 0)), attrs.i("k", 0))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import EyeLikeMilli

        return [ctx.emit1(EyeLikeMilli(self.dtype, self.k), inputs[0])]


@register("OneHot")
@dataclass
class OneHot(Operation):
    axis: int = -1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import OneHotMilli

        return [ctx.emit1(OneHotMilli(self.axis), inputs[0], inputs[1], inputs[2])]


@register("ScatterElements", "Scatter")
@dataclass
class ScatterElements(Operation):
    """ONNX ScatterElements (and the deprecated opset-9 Scatter alias)."""

    axis: int = 0
    reduction: str = "none"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0), attrs.s("reduction", "none"))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.index import ScatterElementsMilli

        return [ctx.emit1(ScatterElementsMilli(self.axis, self.reduction),
                          inputs[0], inputs[1], inputs[2])]


@register("Hardmax")
@dataclass
class Hardmax(Operation):
    """onehot(argmax(x, axis)) with ties going to the first index."""

    axis: int = -1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import CastLike, Constant, GatherShape, Shape
        from ...milli.ops.misc import OneHotMilli
        from ...milli.ops.reduce import ArgMinMax

        x = inputs[0]
        am = ctx.emit1(ArgMinMax("max", axis=self.axis, keepdims=False), x)
        shp = ctx.emit1(Shape(), x)
        depth = ctx.emit1(GatherShape(self.axis), shp)
        vals = ctx.emit1(Constant(np.asarray([0.0, 1.0], dtype=np.float32)))
        valsc = ctx.emit1(CastLike(), vals, x)
        return [ctx.emit1(OneHotMilli(axis=self.axis), am, depth, valsc)]
