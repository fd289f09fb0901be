"""Normalization symbolic ops -> milli lowerings.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/norm.py,
trimmed to the ONNX op types the llama and GPT-2 recipes emit:
LayerNormalization and RMSNormalization. Any other op type raises
UnsupportedOnnxOp at import.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...milli.ops.norm import LayerNormMilli, RMSNormMilli
from .base import Operation, register


@register("LayerNormalization")
@dataclass
class LayerNormalization(Operation):
    axis: int = -1
    epsilon: float = 1e-5
    stash_type: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), attrs.f("epsilon", 1e-5),
                   attrs.i("stash_type", 1))

    def lower(self, ctx, inputs, n_outputs):
        args = [i for i in inputs if i is not None]
        return ctx.emit(LayerNormMilli(self.axis, self.epsilon,
                                       bool(self.stash_type),
                                       n_out=n_outputs),
                        *args, n_outputs=n_outputs)


@register("RMSNormalization")
@dataclass
class RMSNormalization(Operation):
    axis: int = -1
    epsilon: float = 1e-5
    stash_type: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), attrs.f("epsilon", 1e-5),
                   attrs.i("stash_type", 1))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(RMSNormMilli(self.axis, self.epsilon,
                                       bool(self.stash_type)), inputs[0], inputs[1])]
