"""Linear-algebra symbolic ops: MatMul, Gemm, QuantMatMul, Einsum.

Reference equivalents: src/symbolic_graph/ops/{mod,conv}.rs.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/linalg.py
without Conv, ConvTranspose and the pools, which wait for the
convolution milli ops (symbolic_graph/ops/not_ported.py).
"""

from __future__ import annotations

from dataclasses import dataclass


from ...milli.ops import MatMul, SimpleBinary, Transpose
from .base import Operation, register


@register("MatMul")
class MatMulOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(MatMul(), inputs[0], inputs[1])]


@register("Gemm")
@dataclass
class Gemm(Operation):
    alpha: float = 1.0
    beta: float = 1.0
    trans_a: bool = False
    trans_b: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1.0), attrs.f("beta", 1.0),
                   bool(attrs.i("transA", 0)), bool(attrs.i("transB", 0)))

    def lower(self, ctx, inputs, n_outputs):
        a, b = inputs[0], inputs[1]
        if self.trans_a:
            a = ctx.emit1(Transpose(swap_last2=True), a)
        if self.trans_b:
            b = ctx.emit1(Transpose(swap_last2=True), b)
        y = ctx.emit1(MatMul(), a, b)
        if self.alpha != 1.0:
            y = ctx.emit1(SimpleBinary("mul"), ctx.const_like(self.alpha, y), y)
        if len(inputs) > 2 and inputs[2] is not None:
            c = inputs[2]
            if self.beta != 1.0:
                c = ctx.emit1(SimpleBinary("mul"), ctx.const_like(self.beta, c), c)
            y = ctx.emit1(SimpleBinary("add"), y, c)
        return [y]


@register("QuantMatMul")
@dataclass
class QuantMatMul(Operation):
    """Custom-domain quantized matmul: x @ dequant(w_packed).

    Reference: src/symbolic_graph/ops/mod.rs QuantMatMul. On TPU this is
    served by the fused dequant-matmul Pallas kernel; the milli lowering
    dequantizes then matmuls (oracle semantics).
    """

    def lower(self, ctx, inputs, n_outputs):
        # inputs: x, w (w is a dequantized-on-load initializer in milli)
        return [ctx.emit1(MatMul(), inputs[0], inputs[1])]


@register("Einsum")
@dataclass
class Einsum(Operation):
    equation: str = ""

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("equation", ""))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.einsum import EinsumMilli

        return [ctx.emit1(EinsumMilli(self.equation), *inputs)]


