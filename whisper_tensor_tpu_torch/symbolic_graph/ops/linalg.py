"""Linear-algebra symbolic ops: MatMul, Gemm, Conv, ConvTranspose,
QuantMatMul, Einsum and the pooling family.

Reference equivalents: src/symbolic_graph/ops/{mod,conv}.rs.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/linalg.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ...milli.ops import Conv, MatMul, SimpleBinary, Transpose
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


@register("Conv")
@dataclass
class ConvOp(Operation):
    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    auto_pad: str = "NOTSET"
    kernel_shape: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("strides", None), attrs.ints("pads", None),
                   attrs.ints("dilations", None), attrs.i("group", 1),
                   attrs.s("auto_pad", "NOTSET"), attrs.ints("kernel_shape", None))

    def lower(self, ctx, inputs, n_outputs):
        pads = self.pads
        ap = self.auto_pad or "NOTSET"
        if ap == "VALID":
            pads, ap = None, "NOTSET"
        args = [i for i in inputs if i is not None]
        return [ctx.emit1(Conv(self.strides, pads, self.dilations,
                               self.groups, auto_pad=ap), *args)]


@register("ConvTranspose")
@dataclass
class ConvTranspose(Operation):
    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    output_padding: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        if attrs.s("auto_pad", "NOTSET") not in ("", "NOTSET"):
            raise NotImplementedError("ConvTranspose auto_pad")
        return cls(attrs.ints("strides", None), attrs.ints("pads", None),
                   attrs.ints("dilations", None), attrs.i("group", 1),
                   attrs.ints("output_padding", None))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.conv import ConvTransposeMilli

        args = [i for i in inputs if i is not None]
        return [ctx.emit1(ConvTransposeMilli(self.strides, self.pads,
                                             self.dilations, self.groups,
                                             self.output_padding), *args)]


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


@register("MaxPool", "AveragePool", "GlobalMaxPool", "GlobalAveragePool",
          "LpPool")
@dataclass
class PoolOp(Operation):
    """ONNX pooling family -> milli Pool (lax.reduce_window on TPU).
    Reference seam: the pooling node tests of the official corpus
    (tests/onnx_testing.rs)."""

    mode: str = "max"
    kernel_shape: Optional[List[int]] = None
    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    ceil_mode: bool = False
    count_include_pad: bool = False
    p: int = 2
    auto_pad: str = "NOTSET"
    storage_order: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        mode = {"MaxPool": "max", "AveragePool": "avg",
                "GlobalMaxPool": "max", "GlobalAveragePool": "avg",
                "LpPool": "lp"}[node.op_type]
        is_global = node.op_type.startswith("Global")
        return cls(mode,
                   None if is_global else attrs.ints("kernel_shape", None),
                   attrs.ints("strides", None), attrs.ints("pads", None),
                   attrs.ints("dilations", None),
                   bool(attrs.i("ceil_mode", 0)),
                   bool(attrs.i("count_include_pad", 0)),
                   attrs.i("p", 2), attrs.s("auto_pad", "NOTSET"),
                   attrs.i("storage_order", 0))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops import Pool, Pow, SimpleBinary, SimpleUnary

        ap = self.auto_pad or "NOTSET"
        if ap == "VALID":
            ap = "NOTSET"
        x = inputs[0]
        if self.mode == "lp":
            # LpPool(p) = (sum |x|^p)^(1/p) = (avg*count)^(1/p); use
            # count_include_pad avg then scale by window size
            if self.p != 2:
                ax = ctx.emit1(SimpleUnary("abs"), x)
                pc = ctx.const_like(float(self.p), x)
                xpow = ctx.emit1(Pow(), ax, pc)
            else:
                xpow = ctx.emit1(SimpleBinary("mul"), x, x)
            avg = ctx.emit1(Pool("avg", self.kernel_shape, self.strides,
                                 self.pads, self.dilations, self.ceil_mode,
                                 count_include_pad=True, auto_pad=ap),
                            xpow)
            n = 1
            for kk in (self.kernel_shape or []):
                n *= kk
            ssum = ctx.emit1(SimpleBinary("mul"), avg,
                             ctx.const_like(float(n), avg))
            inv = ctx.const_like(1.0 / float(self.p), ssum)
            return [ctx.emit1(Pow(), ssum, inv)]
        return ctx.emit(Pool(self.mode, self.kernel_shape, self.strides,
                             self.pads, self.dilations, self.ceil_mode,
                             self.count_include_pad, auto_pad=ap,
                             n_out=n_outputs,
                             storage_order=self.storage_order), x,
                        n_outputs=n_outputs)
