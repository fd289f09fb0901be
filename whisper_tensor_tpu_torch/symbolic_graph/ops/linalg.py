"""Linear-algebra symbolic ops -> milli lowerings.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/linalg.py,
trimmed to the one ONNX op type of it the llama and GPT-2 recipes emit:
MatMul. Any other op type raises UnsupportedOnnxOp at import.
"""

from __future__ import annotations

from ...milli.ops import MatMul
from .base import Operation, register


@register("MatMul")
class MatMulOp(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(MatMul(), inputs[0], inputs[1])]
