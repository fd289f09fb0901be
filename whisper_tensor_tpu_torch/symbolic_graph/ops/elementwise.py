"""Elementwise symbolic ops -> milli lowerings.

Reference equivalents: src/symbolic_graph/ops/{unary,binary,misc}.rs.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/elementwise.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...dtype import DType, ONNX_TO_DTYPE
from ...milli.ops import Cast, CastLike, Pow, SimpleBinary, SimpleUnary, Where
from .base import Operation, register

_UNARY_MAP = {
    "Neg": "neg", "Abs": "abs", "Exp": "exp", "Log": "log", "Sqrt": "sqrt",
    "Sin": "sin", "Cos": "cos", "Tan": "tan", "Asin": "asin", "Acos": "acos",
    "Atan": "atan", "Sinh": "sinh", "Cosh": "cosh", "Tanh": "tanh",
    "Asinh": "asinh", "Acosh": "acosh", "Atanh": "atanh",
    "Sigmoid": "sigmoid", "Erf": "erf", "Floor": "floor", "Ceil": "ceil",
    "Round": "round", "Reciprocal": "reciprocal", "Not": "not",
    "Sign": "sign", "Relu": "relu", "Softplus": "softplus", "IsNaN": "isnan",
    "BitwiseNot": "bitnot",
}


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


_BINARY_MAP = {
    "Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div",
    "And": "and", "Or": "or", "Xor": "xor",
    "BitwiseAnd": "bitand", "BitwiseOr": "bitor", "BitwiseXor": "bitxor",
    "Equal": "eq", "Less": "lt", "LessOrEqual": "le",
    "Greater": "gt", "GreaterOrEqual": "ge",
}


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


@register("Mod")
@dataclass
class Modulo(Operation):
    fmod: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("fmod", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(SimpleBinary("fmod" if self.fmod else "mod"),
                          inputs[0], inputs[1])]


@register("BitShift")
@dataclass
class BitShift(Operation):
    direction: str = "LEFT"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("direction", "LEFT"))

    def lower(self, ctx, inputs, n_outputs):
        mode = "bitshift_left" if self.direction == "LEFT" else "bitshift_right"
        return [ctx.emit1(SimpleBinary(mode), inputs[0], inputs[1])]


@register("Pow")
class PowOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Pow(), inputs[0], inputs[1])]


@register("Max", "Min", "Sum", "Mean")
@dataclass
class Variadic(Operation):
    mode: str = "max"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(node.op_type.lower())

    def lower(self, ctx, inputs, n_outputs):
        mode = {"max": "max", "min": "min", "sum": "add", "mean": "add"}[self.mode]
        acc = inputs[0]
        for i in inputs[1:]:
            acc = ctx.emit1(SimpleBinary(mode), acc, i)
        if self.mode == "mean":
            n = ctx.const_like(float(len(inputs)), acc)
            acc = ctx.emit1(SimpleBinary("div"), acc, n)
        return [acc]


@register("Clip")
@dataclass
class Clip(Operation):
    """Clip-11+: min/max as optional inputs; Clip-6: min/max attributes."""

    min_attr: Optional[float] = None
    max_attr: Optional[float] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("min", None), attrs.f("max", None))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        if len(inputs) == 1 and (self.min_attr is not None
                                 or self.max_attr is not None):
            if self.min_attr is not None:
                x = ctx.emit1(SimpleBinary("max"), x,
                              ctx.const_like(self.min_attr, x))
            if self.max_attr is not None:
                x = ctx.emit1(SimpleBinary("min"), x,
                              ctx.const_like(self.max_attr, x))
            return [x]
        if len(inputs) > 1 and inputs[1] is not None:
            x = ctx.emit1(SimpleBinary("max"), x, inputs[1])
        if len(inputs) > 2 and inputs[2] is not None:
            x = ctx.emit1(SimpleBinary("min"), x, inputs[2])
        return [x]


@register("LeakyRelu")
@dataclass
class LeakyRelu(Operation):
    alpha: float = 0.01

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 0.01))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        a = ctx.const_like(self.alpha, x)
        ax = ctx.emit1(SimpleBinary("mul"), a, x)
        zero = ctx.const_like(0.0, x)
        mask = ctx.emit1(SimpleBinary("gt"), x, zero)
        return [ctx.emit1(Where(), mask, x, ax)]


@register("Elu")
@dataclass
class Elu(Operation):
    alpha: float = 1.0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1.0))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        zero = ctx.const_like(0.0, x)
        one = ctx.const_like(1.0, x)
        a = ctx.const_like(self.alpha, x)
        em1 = ctx.emit1(SimpleBinary("sub"), ctx.emit1(SimpleUnary("exp"), x), one)
        neg = ctx.emit1(SimpleBinary("mul"), a, em1)
        mask = ctx.emit1(SimpleBinary("gt"), x, zero)
        return [ctx.emit1(Where(), mask, x, neg)]


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


@register("BiasGelu")
@dataclass
class BiasGelu(Gelu):
    """com.microsoft BiasGelu: gelu(x + bias). Reference has it as a
    first-class op (src/symbolic_graph/ops/mod.rs:223-286)."""

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls("none")

    def lower(self, ctx, inputs, n_outputs):
        x = ctx.emit1(SimpleBinary("add"), inputs[0], inputs[1])
        return [self._gelu(ctx, x)]


@register("PRelu")
class PRelu(Operation):
    def lower(self, ctx, inputs, n_outputs):
        x, slope = inputs
        zero = ctx.const_like(0.0, x)
        sx = ctx.emit1(SimpleBinary("mul"), slope, x)
        mask = ctx.emit1(SimpleBinary("gt"), x, zero)
        return [ctx.emit1(Where(), mask, x, sx)]


@register("HardSigmoid")
@dataclass
class HardSigmoid(Operation):
    alpha: float = 0.2
    beta: float = 0.5

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 0.2), attrs.f("beta", 0.5))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        a = ctx.const_like(self.alpha, x)
        b = ctx.const_like(self.beta, x)
        y = ctx.emit1(SimpleBinary("add"), ctx.emit1(SimpleBinary("mul"), a, x), b)
        y = ctx.emit1(SimpleBinary("max"), y, ctx.const_like(0.0, x))
        return [ctx.emit1(SimpleBinary("min"), y, ctx.const_like(1.0, x))]


@register("HardSwish")
class HardSwish(Operation):
    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        hs = HardSigmoid(1.0 / 6.0, 0.5).lower(ctx, [x], 1)[0]
        return [ctx.emit1(SimpleBinary("mul"), x, hs)]


@register("Softsign")
class Softsign(Operation):
    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        one = ctx.const_like(1.0, x)
        denom = ctx.emit1(SimpleBinary("add"), one, ctx.emit1(SimpleUnary("abs"), x))
        return [ctx.emit1(SimpleBinary("div"), x, denom)]


@register("Mish")
class Mish(Operation):
    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        sp = ctx.emit1(SimpleUnary("softplus"), x)
        return [ctx.emit1(SimpleBinary("mul"), x, ctx.emit1(SimpleUnary("tanh"), sp))]


@register("Selu")
@dataclass
class Selu(Operation):
    alpha: float = 1.6732632423543772
    gamma: float = 1.0507009873554805

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1.6732632423543772),
                   attrs.f("gamma", 1.0507009873554805))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        zero = ctx.const_like(0.0, x)
        a = ctx.const_like(self.alpha, x)
        gmm = ctx.const_like(self.gamma, x)
        one = ctx.const_like(1.0, x)
        em1 = ctx.emit1(SimpleBinary("sub"), ctx.emit1(SimpleUnary("exp"), x), one)
        neg = ctx.emit1(SimpleBinary("mul"), a, em1)
        mask = ctx.emit1(SimpleBinary("gt"), x, zero)
        sel = ctx.emit1(Where(), mask, x, neg)
        return [ctx.emit1(SimpleBinary("mul"), gmm, sel)]


@register("IsInf")
@dataclass
class IsInf(Operation):
    detect_negative: bool = True
    detect_positive: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("detect_negative", 1)), bool(attrs.i("detect_positive", 1)))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        pos = ctx.emit1(SimpleBinary("eq"), x, ctx.const_like(float("inf"), x))
        neg = ctx.emit1(SimpleBinary("eq"), x, ctx.const_like(float("-inf"), x))
        if self.detect_negative and self.detect_positive:
            return [ctx.emit1(SimpleBinary("or"), pos, neg)]
        if self.detect_positive:
            return [pos]
        if self.detect_negative:
            return [neg]
        false = ctx.emit1(Cast(DType.BOOL), ctx.const_like(0.0, x))
        return [false]


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


@register("CastLike")
class CastLikeOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(CastLike(), inputs[0], inputs[1])]


@register("Identity")
class Identity(Operation):
    def lower(self, ctx, inputs, n_outputs):
        # emit a no-op CastLike-free pass-through: reuse input id directly
        return [inputs[0]]


@register("Celu")
@dataclass
class Celu(Operation):
    """max(0,x) + min(0, alpha*(exp(x/alpha)-1))"""

    alpha: float = 1.0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1.0))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        zero = ctx.const_like(0.0, x)
        one = ctx.const_like(1.0, x)
        a = ctx.const_like(self.alpha, x)
        em1 = ctx.emit1(SimpleBinary("sub"), ctx.emit1(
            SimpleUnary("exp"), ctx.emit1(SimpleBinary("div"), x, a)), one)
        neg = ctx.emit1(SimpleBinary("min"), zero,
                        ctx.emit1(SimpleBinary("mul"), a, em1))
        pos = ctx.emit1(SimpleBinary("max"), zero, x)
        return [ctx.emit1(SimpleBinary("add"), pos, neg)]


@register("Shrink")
@dataclass
class Shrink(Operation):
    """x < -lambd -> x+bias; x > lambd -> x-bias; else 0."""

    bias: float = 0.0
    lambd: float = 0.5

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("bias", 0.0), attrs.f("lambd", 0.5))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        zero = ctx.const_like(0.0, x)
        lam = ctx.const_like(self.lambd, x)
        nlam = ctx.const_like(-self.lambd, x)
        bias = ctx.const_like(self.bias, x)
        lo = ctx.emit1(SimpleBinary("lt"), x, nlam)
        hi = ctx.emit1(SimpleBinary("gt"), x, lam)
        xp = ctx.emit1(SimpleBinary("add"), x, bias)
        xm = ctx.emit1(SimpleBinary("sub"), x, bias)
        inner = ctx.emit1(Where(), hi, xm, zero)
        return [ctx.emit1(Where(), lo, xp, inner)]


@register("ThresholdedRelu")
@dataclass
class ThresholdedRelu(Operation):
    alpha: float = 1.0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1.0))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        zero = ctx.const_like(0.0, x)
        a = ctx.const_like(self.alpha, x)
        mask = ctx.emit1(SimpleBinary("gt"), x, a)
        return [ctx.emit1(Where(), mask, x, zero)]
