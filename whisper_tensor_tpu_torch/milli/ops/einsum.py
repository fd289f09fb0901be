"""Einsum milli op (np.einsum semantics, ONNX equation) and its lowering.

The port's copy of whisper_tensor_tpu/milli/ops/einsum.py. The
multi-LoRA surgery (milli/transforms.py inject_multi_lora) emits it;
the JAX package computes it with jnp.einsum, outside any Pallas
kernel, so the lowering is torch.einsum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering
from .common import downcast_result, upcast_for_compute


@dataclass
class EinsumMilli(MilliOp):
    equation: str = ""
    KIND = "Einsum"

    def eval(self, inputs):
        ups = [upcast_for_compute(x) for x in inputs]
        out = np.einsum(self.equation, *[u[0] for u in ups])
        return [downcast_result(np.asarray(out), ups[0][1])]

    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        cs = [i.concrete_shape() for i in infos]
        if all(c is not None for c in cs):
            dummies = [np.zeros(c, dtype=np.float32) for c in cs]
            out_shape = np.einsum(self.equation, *dummies).shape
            return [TensorInfo.shaped(infos[0].dtype, list(out_shape))]
        return [TensorInfo.minimal(infos[0].dtype)]


_LOW = (torch.bfloat16, torch.float16)


@lowering("Einsum")
def einsum(op, inputs, static, device):
    """bf16/f16 operands of one type contract in that type: cuBLAS sums
    the products in f32 and rounds once (device.py keeps reduced-
    precision reduction off), eval's f32 compute and one downcast.
    Mixed types compute in f32 and round to the first input's type."""
    dt = inputs[0].dtype
    if all(x.dtype == dt for x in inputs):
        return [torch.einsum(op.equation, *inputs)]
    out = torch.einsum(op.equation, *[x.float() for x in inputs])
    return [out.to(dt) if dt.is_floating_point else out]
