"""RMSNorm and LayerNorm: the milli op classes and their PyTorch
lowerings.

The classes are the port's copy of RMSNormMilli and LayerNormMilli from
whisper_tensor_tpu/milli/ops/norm.py (numpy `eval` and shape inference;
no `to_jax`). The lowerings take statistics in f32 (the ONNX
stash_type=1 default) and round the output back to the input type once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...dtype import DType
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


@dataclass
class LayerNormMilli(MilliOp):
    """x, scale[, bias] -> y[, mean, inv_std]; normalizes dims [axis:].
    Mean/InvStdDev (keepdims over the normalized span) stay in the
    stash dtype (f32 when stash_f32), per the ONNX-17 spec."""

    axis: int = -1
    epsilon: float = 1e-5
    stash_f32: bool = True
    n_out: int = 1
    KIND = "LayerNorm"
    N_OUTPUTS = 1

    def _stats(self, xp, ax):
        mean = xp.mean(axis=ax, keepdims=True)
        d = xp - mean
        var = (d * d).mean(axis=ax, keepdims=True)
        return mean, d, var

    def eval(self, inputs):
        x = inputs[0]
        scale = inputs[1]
        bias = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        ax = tuple(range(self.axis % x.ndim, x.ndim))
        xp = x.astype(np.float32) if self.stash_f32 and x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        mean, d, var = self._stats(xp, ax)
        inv = 1.0 / np.sqrt(var + np.asarray(self.epsilon, dtype=xp.dtype))
        y = d * inv * scale.astype(xp.dtype)
        if bias is not None:
            y = y + bias.astype(xp.dtype)
        stash_dt = np.float32 if self.stash_f32 else x.dtype
        return [y.astype(x.dtype), mean.astype(stash_dt),
                inv.astype(stash_dt)][:self.n_out]

    def infer(self, infos):
        i = infos[0]
        if all(f is not None and f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(o)
                    for o in self.eval([f.value for f in infos])]
        if self.n_out == 1:
            return [i.forget_value()]
        stash = DType.F32 if self.stash_f32 else i.dtype
        stats = (TensorInfo.ranked(stash, i.rank) if i.rank is not None
                 else TensorInfo.minimal(stash))
        return [i.forget_value(), stats, stats][:self.n_out]


@dataclass
class RMSNormMilli(MilliOp):
    axis: int = -1
    epsilon: float = 1e-5
    stash_f32: bool = True
    KIND = "RMSNorm"

    def eval(self, inputs):
        x, scale = inputs[0], inputs[1]
        ax = tuple(range(self.axis % x.ndim, x.ndim))
        xp = x.astype(np.float32) if self.stash_f32 and x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        ms = (xp * xp).mean(axis=ax, keepdims=True)
        y = xp / np.sqrt(ms + np.asarray(self.epsilon, dtype=xp.dtype))
        return [(y * scale.astype(xp.dtype)).astype(x.dtype)]

    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]


# -- lowerings ----------------------------------------------------------


@lowering("RMSNorm")
def rms_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    ms = (xp * xp).mean(dim=dims, keepdim=True)
    y = xp * torch.rsqrt(ms + op.epsilon)
    return [(y * scale.to(xp.dtype)).to(x.dtype)]


@lowering("LayerNorm")
def layer_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    mean = xp.mean(dim=dims, keepdim=True)
    d = xp - mean
    inv = torch.rsqrt((d * d).mean(dim=dims, keepdim=True) + op.epsilon)
    y = d * inv * scale.to(xp.dtype)
    if bias is not None:
        y = y + bias.to(xp.dtype)
    stash = torch.float32 if op.stash_f32 else x.dtype
    return [y.to(x.dtype), mean.to(stash), inv.to(stash)][:op.n_out]
