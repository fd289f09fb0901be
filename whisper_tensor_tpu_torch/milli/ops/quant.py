"""Affine quantize/dequantize milli ops (ONNX Q/DQ semantics) and their
PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/quant.py
(numpy `eval` and shape inference; no `to_jax`). Float8 and 4-bit float
targets clip to the target's finite range and cast (basic.cast_to); the
4-bit integer targets clip to their logical range and live in their
8-bit carriers (dtype.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...dtype import DType, from_torch, to_torch
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering
from .basic import cast_to


def _reshape_for_axis(p, ndim, axis):
    if p.ndim == 0:
        return p
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return p.reshape(shape)


def _finfo(np_t):
    """np.finfo that also accepts ml_dtypes scalar classes."""
    try:
        return np.finfo(np_t)
    except ValueError:
        import ml_dtypes

        return ml_dtypes.finfo(np_t)


def _q_range(tgt: DType):
    """clip range for the quantize target (4-bit logical ranges differ
    from their widened host containers)."""
    if tgt is DType.I4:
        return -8, 7
    if tgt is DType.U4:
        return 0, 15
    info = np.iinfo(tgt.to_numpy())
    return info.min, info.max


def _expand_block(xp, s, axis, dim, block):
    """Blocked (ONNX-21) scale/zp: repeat each block along `axis` to
    the data length."""
    rep = xp.repeat(s, block, axis=axis)
    sl = [slice(None)] * s.ndim
    sl[axis] = slice(0, dim)
    return rep[tuple(sl)]


@dataclass
class QuantizeLinearMilli(MilliOp):
    axis: int = 1
    dtype: Optional[DType] = None  # target (from zero_point or attr)
    block_size: int = 0
    KIND = "QuantizeLinear"

    def _scales(self, xp, x, scale, zp):
        ax = self.axis % x.ndim
        if self.block_size:
            s = _expand_block(xp, scale.astype(xp.float32), ax,
                              x.shape[ax], self.block_size)
            z = (_expand_block(xp, zp.astype(xp.float32), ax, x.shape[ax],
                               self.block_size) if zp is not None else 0.0)
            return s, z
        s = _reshape_for_axis(scale.astype(np.float32), x.ndim, self.axis)
        z = (_reshape_for_axis(zp.astype(np.float32), x.ndim, self.axis)
             if zp is not None else 0.0)
        return s, z

    def eval(self, inputs):
        x, scale = inputs[0], inputs[1]
        zp = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        tgt = self.dtype or (DType.from_numpy(zp.dtype) if zp is not None else DType.U8)
        s, z = self._scales(np, x, scale, zp)
        np_t = tgt.to_numpy()
        if tgt.is_float:
            # float8/float4 targets: saturating cast of x/s + z (no
            # integer rounding), per the ONNX saturate=1 default
            v = x.astype(np.float32) / s + z
            fi = _finfo(np_t)
            v = np.clip(v, float(fi.min), float(fi.max))
            return [v.astype(np_t)]
        q = np.round(x.astype(np.float32) / s) + z
        lo, hi = _q_range(tgt)
        q = np.clip(q, lo, hi)
        return [q.astype(np_t)]


    def infer(self, infos):
        x = infos[0]
        tgt = self.dtype or (infos[2].dtype if len(infos) > 2 and infos[2] is not None else DType.U8)
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [TensorInfo(tgt, min(x.level, 2), shape=x.shape, rank_=x.rank_)]


@dataclass
class DequantizeLinearMilli(MilliOp):
    axis: int = 1
    block_size: int = 0
    KIND = "DequantizeLinear"

    def _sz(self, xp, x, scale, zp):
        if self.block_size:
            ax = self.axis % x.ndim
            s = _expand_block(xp, scale.astype(xp.float32), ax,
                              x.shape[ax], self.block_size)
            z = (_expand_block(xp, zp.astype(xp.float32), ax, x.shape[ax],
                               self.block_size) if zp is not None else 0.0)
            return s, z
        s = _reshape_for_axis(scale.astype(np.float32), x.ndim, self.axis)
        z = (_reshape_for_axis(zp.astype(np.float32), x.ndim, self.axis)
             if zp is not None else 0.0)
        return s, z

    def eval(self, inputs):
        x, scale = inputs[0], inputs[1]
        zp = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        s, z = self._sz(np, x, scale, zp)
        out = (x.astype(np.float32) - z) * s
        return [out.astype(scale.dtype)]


    def infer(self, infos):
        x = infos[0]
        dt = infos[1].dtype
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [TensorInfo(dt, min(x.level, 2), shape=x.shape, rank_=x.rank_)]


# -- lowerings ----------------------------------------------------------


def _params(op, x: torch.Tensor, scale: torch.Tensor, zp):
    """Scale and zero point (f32) broadcast against x: per tensor, per
    axis, or per block of `block_size` along the axis (ONNX-21)."""
    ax = op.axis % x.ndim
    s = scale.float()
    z = zp.float() if zp is not None else None
    if op.block_size:
        def expand(p):
            p = p.repeat_interleave(op.block_size, dim=ax)
            return p.narrow(ax, 0, x.shape[ax])
        return expand(s), (expand(z) if z is not None else 0.0)
    if s.ndim:
        shape = [1] * x.ndim
        shape[ax] = -1
        s = s.reshape(shape)
        z = z.reshape(shape) if z is not None else None
    return s, (z if z is not None else 0.0)


@lowering("QuantizeLinear")
def quantize_linear(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    zp = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
    tgt = op.dtype or (from_torch(zp.dtype) if zp is not None else DType.U8)
    s, z = _params(op, x, scale, zp)
    if tgt.is_float:
        fi = _finfo(tgt.to_numpy())
        v = (x.float() / s + z).clamp(float(fi.min), float(fi.max))
        return [cast_to(v, tgt)]
    q = torch.round(x.float() / s) + z
    lo, hi = _q_range(tgt)
    return [q.clamp(lo, hi).to(to_torch(tgt))]


@lowering("DequantizeLinear")
def dequantize_linear(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    zp = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
    s, z = _params(op, x, scale, zp)
    xf = x.float() if x.dtype != torch.uint64 else x.view(torch.int64).float()
    return [((xf - z) * s).to(scale.dtype)]
