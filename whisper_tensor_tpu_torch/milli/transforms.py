"""QuantMatMul lowering (whisper_tensor_tpu/milli/transforms.py:32).

The graph passes themselves (`quantize_matmul_weights`,
`fuse_parallel_matmuls`) are numpy surgery on the milli graph; the port
imports them from the reference and runs them unchanged.
"""

from __future__ import annotations

from ..backends.cuda.quant_matmul import int8_matmul
from .registry import lowering


@lowering("QuantMatMul")
def quant_matmul(op, inputs, static, device):
    x, w_i8, scale = inputs
    return [int8_matmul(x, w_i8, scale)]
