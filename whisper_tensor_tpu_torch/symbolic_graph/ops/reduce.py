"""Reduction symbolic ops (ReduceSum/Mean/... with opset 13/18 forms).

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/reduce.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ...milli.ops import Reduce
from .base import Operation, register

_MODES = {
    "ReduceSum": "sum", "ReduceMean": "mean", "ReduceProd": "prod",
    "ReduceMin": "min", "ReduceMax": "max", "ReduceL2": "l2",
    "ReduceL1": "l1", "ReduceLogSumExp": "logsumexp",
    "ReduceSumSquare": "sumsquare",
}


@register(*_MODES.keys())
@dataclass
class ReduceOp(Operation):
    mode: str = "sum"
    axes_attr: Optional[List[int]] = None  # opset < 13/18 attribute form
    keepdims: bool = True
    noop_with_empty_axes: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(_MODES[node.op_type], attrs.ints("axes", None),
                   bool(attrs.i("keepdims", 1)),
                   bool(attrs.i("noop_with_empty_axes", 0)))

    def lower(self, ctx, inputs, n_outputs):
        if len(inputs) > 1 and inputs[1] is not None:
            return [ctx.emit1(Reduce(self.mode, None, self.keepdims,
                                     self.noop_with_empty_axes),
                              inputs[0], inputs[1])]
        return [ctx.emit1(Reduce(self.mode, self.axes_attr, self.keepdims,
                                 self.noop_with_empty_axes), inputs[0])]

    def display_name(self):
        return f"Reduce{self.mode}"


@register("ReduceLogSum")
@dataclass
class ReduceLogSum(Operation):
    axes_attr: Optional[List[int]] = None
    keepdims: bool = True
    noop_with_empty_axes: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("axes", None), bool(attrs.i("keepdims", 1)),
                   bool(attrs.i("noop_with_empty_axes", 0)))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import SimpleUnary

        if len(inputs) > 1 and inputs[1] is not None:
            s = ctx.emit1(Reduce("sum", None, self.keepdims,
                                 self.noop_with_empty_axes), inputs[0], inputs[1])
        else:
            s = ctx.emit1(Reduce("sum", self.axes_attr, self.keepdims,
                                 self.noop_with_empty_axes), inputs[0])
        return [ctx.emit1(SimpleUnary("log"), s)]
