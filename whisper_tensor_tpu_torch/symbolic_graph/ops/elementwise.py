"""Elementwise symbolic ops -> milli lowerings.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/elementwise.py,
trimmed to the ONNX op types the llama and GPT-2 recipes emit: Add, Mul,
LessOrEqual, Sigmoid, Gelu, Where and Cast. Any other op type is
unregistered, and SymbolicGraph.from_onnx_bytes raises
UnsupportedOnnxOp for it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...dtype import DType, ONNX_TO_DTYPE
from ...milli.ops import Cast, SimpleBinary, SimpleUnary, Where
from .base import Operation, register


_UNARY_MAP = {"Sigmoid": "sigmoid"}


@register(*_UNARY_MAP.keys())
@dataclass
class Unary(Operation):
    mode: str = "neg"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(_UNARY_MAP[node.op_type])

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(SimpleUnary(self.mode), inputs[0])]

    def display_name(self):
        return self.mode


_BINARY_MAP = {"Add": "add", "Mul": "mul", "LessOrEqual": "le"}


@register(*_BINARY_MAP.keys())
@dataclass
class Binary(Operation):
    mode: str = "add"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(_BINARY_MAP[node.op_type])

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(SimpleBinary(self.mode), inputs[0], inputs[1])]

    def display_name(self):
        return self.mode


@register("Gelu")
@dataclass
class Gelu(Operation):
    approximate: str = "none"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("approximate", "none"))

    def _gelu(self, ctx, x):
        half = ctx.const_like(0.5, x)
        one = ctx.const_like(1.0, x)
        if self.approximate == "tanh":
            c = ctx.const_like(float(np.sqrt(2.0 / np.pi)), x)
            k = ctx.const_like(0.044715, x)
            x3 = ctx.emit1(SimpleBinary("mul"), x, ctx.emit1(SimpleBinary("mul"), x, x))
            inner = ctx.emit1(SimpleBinary("add"), x, ctx.emit1(SimpleBinary("mul"), k, x3))
            t = ctx.emit1(SimpleUnary("tanh"), ctx.emit1(SimpleBinary("mul"), c, inner))
            return ctx.emit1(SimpleBinary("mul"), half,
                             ctx.emit1(SimpleBinary("mul"), x,
                                       ctx.emit1(SimpleBinary("add"), one, t)))
        inv_sqrt2 = ctx.const_like(float(1.0 / np.sqrt(2.0)), x)
        e = ctx.emit1(SimpleUnary("erf"), ctx.emit1(SimpleBinary("mul"), x, inv_sqrt2))
        return ctx.emit1(SimpleBinary("mul"), half,
                         ctx.emit1(SimpleBinary("mul"), x,
                                   ctx.emit1(SimpleBinary("add"), one, e)))

    def lower(self, ctx, inputs, n_outputs):
        return [self._gelu(ctx, inputs[0])]


@register("Where")
class WhereOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Where(), inputs[0], inputs[1], inputs[2])]


@register("Cast")
@dataclass
class CastOp(Operation):
    to: DType = DType.F32

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(ONNX_TO_DTYPE[attrs.i("to")])

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Cast(self.to), inputs[0])]
